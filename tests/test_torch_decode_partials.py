"""The port's split-KV decode partials against the JAX package's.

``ops.decode_attention_partials`` returns the unnormalized accumulator and
the running max and sum of a flash-decode over a slice of the cache. On the
CPU the port runs its plain version (a streaming loop) or its oracle
(materialized); both are held against the JAX package's jnp path and its
Pallas kernel in interpret mode, over GQA groups 1, 4 and 7, with and
without a window, at effective lengths 0, 1, partial and the whole slice,
with float32 q (pre-scaled, as the sharded decode passes it) against
float32 and bfloat16 caches. Tolerances: float32 2e-5, bfloat16 2e-2
(tests/test_kernels.py's). The combine identity of
tests/test_kernels.py::test_decode_attention_partials_combine is held
against the port's own decode oracle, also for rows whose only keys lie
in the last slice.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import combine_partials  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SHAPES = [
    # (B, H, KV, D, chunk): GQA groups 1, 4 and 7
    (4, 4, 4, 32, 48),
    (4, 8, 2, 64, 48),
    (4, 14, 2, 32, 48),
]
EFF = [0, 1, 17, 48]      # an empty slice, one key, a partial slice, a full one


def _np(rng, shape, dtype):
    a = rng.normal(size=shape).astype(np.float32)
    if dtype == "bfloat16":
        a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return a


def _inputs(shape, dtype, seed):
    b, h, kv, d, chunk = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32) * d ** -0.5
    return q, _np(rng, (b, chunk, kv, d), dtype), _np(rng, (b, chunk, kv, d), dtype)


def _close(got, want, dtype):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jax_impl", ["jnp", "pallas_interpret"])
def test_partials_match_jax(shape, window, dtype, jax_impl):
    q, kc, vc = _inputs(shape, dtype, seed=7)
    lens = np.asarray(EFF, np.int32)
    want = jops.decode_attention_partials(
        jnp.asarray(q), jnp.asarray(kc, getattr(jnp, dtype)), jnp.asarray(vc, getattr(jnp, dtype)),
        jnp.asarray(lens), scale=1.0, window=window, impl=jax_impl)
    b, h, kv, d, _ = shape
    want = (want[0], want[1].reshape(b, kv, h // kv), want[2].reshape(b, kv, h // kv))
    tq = torch.from_numpy(q)
    tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (kc, vc))
    for impl in ("plain", "ref"):
        got = ops.decode_attention_partials(tq, tk, tv, torch.from_numpy(lens), scale=1.0,
                                            window=window, impl=impl)
        assert [t.dtype for t in got] == [torch.float32] * 3
        assert got[0].shape == (b, kv, h // kv, d) and got[1].shape == (b, kv, h // kv)
        _close(got, want, dtype)
        # the empty slice is the Pallas kernel's initial state, with no NaN
        assert torch.equal(got[0][0], torch.zeros_like(got[0][0]))
        assert (got[1][0] == -1e30).all() and (got[2][0] == 0).all()


def _combine(parts):
    """attn_decode_sharded's combine of the slices' partials, divided."""
    acc, _, denom = combine_partials(*(torch.stack(t) for t in zip(*parts, strict=True)))
    return acc / torch.clamp(denom[..., None], min=1e-30)


def _cache(rng, b, h, kv, d, s):
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.normal(size=(b, s, kv, d)).astype(np.float32))
              for _ in range(2))
    return q, kc, vc


@pytest.mark.parametrize("impl", ["plain", "ref"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_partials_combine_to_the_oracle(impl, n_shards):
    """Partials over n slices of a cache, combined as attn_decode_sharded
    combines them, equal decode attention over the whole cache (rows end
    in the first, a middle and the last slice)."""
    b, h, kv, d, s = 3, 8, 2, 64, 300
    q, kc, vc = _cache(np.random.default_rng(5), b, h, kv, d, s)
    lens = torch.tensor([120, 300, 1], dtype=torch.int32)
    want = ops.decode_attention(q, kc, vc, lens, impl="ref")
    chunk = s // n_shards
    out = _combine([ops.decode_attention_partials(
        q, kc[:, lo:lo + chunk], vc[:, lo:lo + chunk], torch.clamp(lens - lo, 0, chunk),
        impl=impl) for lo in range(0, s, chunk)])
    np.testing.assert_allclose(out.reshape(b, h, d).numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("impl", ["plain", "ref"])
def test_partials_combine_with_keys_in_the_last_slice_only(impl):
    """Each row's window lies inside the last of 4 slices; the slices before
    it are given length 0 (masking against absolute positions is the
    caller's job), so three of the four partials are empty (m = -1e30) and
    the combine must still give the oracle's attention."""
    b, h, kv, d, s, window = 3, 8, 2, 64, 300, 60
    q, kc, vc = _cache(np.random.default_rng(6), b, h, kv, d, s)
    lens = torch.tensor([300, 290, 286], dtype=torch.int32)
    want = ops.decode_attention(q, kc, vc, lens, window=window, impl="ref")
    chunk = s // 4
    parts = []
    for lo in range(0, s, chunk):
        eff = torch.clamp(lens - lo, 0, chunk)
        eff = torch.where(lo + chunk <= lens - window, 0, eff)
        parts.append(ops.decode_attention_partials(
            q, kc[:, lo:lo + chunk], vc[:, lo:lo + chunk], eff, window=window, impl=impl))
    assert all((p[1] == -1e30).all() for p in parts[:3])
    out = _combine(parts)
    np.testing.assert_allclose(out.reshape(b, h, d).numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


def test_partials_kernel_refuses_a_cpu_tensor():
    q = torch.zeros((1, 4, 128))
    kc = torch.zeros((1, 8, 2, 128))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.decode_attention_partials(q, kc, kc, torch.ones(1, dtype=torch.int32),
                                      impl="kernel")


@pytest.mark.parametrize("impl", ["auto", "plain", "ref"])
@pytest.mark.parametrize("partials", [False, True])
def test_decode_gives_gradients_on_the_cpu(impl, partials):
    """The decode kernels refuse autograd on a CUDA tensor only: on the CPU
    'auto' (the plain version), 'plain' and 'ref' give q, k and v gradients,
    and those agree with the oracle's."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((2, 8, 32), (2, 40, 2, 32), (2, 40, 2, 32)))
    lens = torch.tensor([17, 40], dtype=torch.int32)
    fn = ops.decode_attention_partials if partials else ops.decode_attention
    grads = []
    for use in (impl, "ref"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, lens, impl=use)
        loss = sum((o * torch.linspace(-1, 1, o.numel()).reshape(o.shape)).sum()
                   for o in (out if partials else (out,)) if o.dtype.is_floating_point)
        grads.append(torch.autograd.grad(loss, leaves))
    for g, w in zip(*grads, strict=True):
        assert g.abs().sum() > 0
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)

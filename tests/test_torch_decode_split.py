"""The decode kernel's sequence split, on the CPU: its plan, its algorithm in
PyTorch and its merge, against the port's plain decode and the JAX package.

``split_plan`` fixes the number of splits and the keys per split from the
cache's shape and the window; the CUDA kernel runs one block per (split,
kv head, batch) and merges the splits in the same launch.
``decode_attention_split_plain`` is that algorithm in PyTorch. It is held
against ``decode_attention_plain`` (float32 at 1e-6: the same arithmetic
merged in another order) and against JAX's ``decode_attention`` through its
oracle (``ref``) and its Pallas kernel in interpret mode (float32 2e-5,
bfloat16 2e-2, tests/test_kernels.py's tolerances), at lengths on and
around the 64-key split boundaries, with splits past the length left empty.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SMAX = 160
LENGTHS = [1, 31, 32, 33, 63, 64, 65, SMAX]   # on and around the split boundaries
SHAPES = [
    # (H, KV, D): GQA groups 4 and 7, then group 1 (MHA, as zamba2-1.2b's
    # shared attention) at head_dims 64 and 32
    (8, 2, 32),
    (14, 2, 32),
    (4, 4, 64),
    (4, 4, 32),
]


@pytest.mark.parametrize("smax", [1, 31, 32, 33, 100, 192, 4096, 20000])
@pytest.mark.parametrize("window", [None, 1, 40, 1024])
def test_split_plan_covers_every_key_once(smax, window):
    """For every length a row can have, the splits from the row's first
    visited key cover each visited key exactly once and nothing else; a
    split holds at most 128 keys unless fewer would take more than 64
    splits, and there are never more than 64."""
    n_splits, kps = da.split_plan(smax, window, 4, 4)
    span = smax if window is None else min(window, smax)
    assert 1 <= n_splits <= da.MAX_SPLITS and kps % da.SPLIT_ALIGN == 0
    assert kps <= da.MAX_KEYS_PER_SPLIT or -(-span // (kps - da.SPLIT_ALIGN)) > da.MAX_SPLITS
    for length in range(0, smax + 3):
        start = max(0, length - window) if window is not None else 0
        end = min(length, smax)
        seen = np.zeros(smax, np.int64)
        for i in range(n_splits):
            lo = start + i * kps
            seen[lo:max(lo, min(lo + kps, end))] += 1
        want = np.zeros(smax, np.int64)
        want[start:max(start, end)] = 1
        np.testing.assert_array_equal(seen, want, err_msg=f"length {length}")


def test_split_plan_fills_the_card_at_the_serving_shapes():
    """qwen2-7b's serving step (batch 4, 4 kv heads): 48-96 blocks at Smax
    192, at least 128 under a window of 1024 at Smax 4096."""
    n, _ = da.split_plan(192, None, 4, 4)
    assert 48 <= n * 16 <= 96
    n, _ = da.split_plan(4096, 1024, 4, 4)
    assert n * 16 >= 128


def _inputs(shape, dtype, seed):
    h, kv, d = shape
    rng = np.random.default_rng(seed)
    b = len(LENGTHS)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kc, vc = (rng.normal(size=(b, SMAX, kv, d)).astype(np.float32) for _ in range(2))
    if dtype == "bfloat16":   # values a bf16 cache can hold, the same on both sides
        q, kc, vc = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                     for a in (q, kc, vc))
    return q, kc, vc, np.asarray(LENGTHS, np.int32)


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("window", [None, 100, 40])
def test_split_plain_matches_plain(shape, window):
    q, kc, vc, lens = _inputs(shape, "float32", seed=3)
    args = (torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            torch.from_numpy(lens))
    kw = dict(scale=shape[2] ** -0.5, window=window)
    if window != 40:   # two or more splits, the later ones empty for short rows
        assert da.split_plan(SMAX, window, len(LENGTHS), shape[1])[0] >= 2
    got = da.decode_attention_split_plain(*args, **kw)
    want = da.decode_attention_plain(*args, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jax_impl", ["ref", "pallas_interpret"])
def test_split_plain_matches_jax(shape, window, dtype, jax_impl):
    q, kc, vc, lens = _inputs(shape, dtype, seed=4)
    jd = getattr(jnp, dtype)
    want = jops.decode_attention(jnp.asarray(q, jd), jnp.asarray(kc, jd), jnp.asarray(vc, jd),
                                 jnp.asarray(lens), window=window, impl=jax_impl)
    got = da.decode_attention_split_plain(
        _torch(q, dtype), _torch(kc, dtype), _torch(vc, dtype), torch.from_numpy(lens),
        scale=shape[2] ** -0.5, window=window)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_combine_partials_of_empty_splits_is_zero():
    """Splits with no keys (m = -1e30, l = 0, acc = 0) merge to 0, not NaN,
    alone and beside a real split, whose result they leave as it is."""
    acc = torch.zeros((3, 2, 4, 8))
    m = torch.full((3, 2, 4), -1e30)
    denom = torch.zeros((3, 2, 4))
    acc_g, m_g, l_g = da.combine_partials(acc, m, denom)
    out = acc_g / torch.clamp(l_g[..., None], min=1e-30)
    assert torch.equal(out, torch.zeros_like(out)) and (m_g == -1e30).all()
    real = torch.randn((2, 4, 8)), torch.randn((2, 4)), torch.rand((2, 4)) + 0.5
    acc[1], m[1], denom[1] = real
    acc_g, m_g, l_g = da.combine_partials(acc, m, denom)
    for got, want in zip((acc_g, m_g, l_g), real, strict=True):
        assert torch.equal(got, want)

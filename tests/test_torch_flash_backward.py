"""The flash-attention backward's plain version against autograd and JAX.

``flash_attention_bwd_plain`` (the algorithm of csrc/flash_attention_bwd.cu
in PyTorch: P recomputed from the forward's LSE, dS = P * (dO V^T - delta))
is held, at float32 on the same numpy inputs, against
* ``torch.autograd`` through ``flash_attention_plain`` (the CPU training path);
* ``jax.vjp`` of ``repro.kernels.ops.flash_attention(impl="jnp")``, the path
  the JAX package trains through (its Pallas kernel has no backward), and of
  ``repro.kernels.ref.mha_reference``;
at GQA groups 1 and 4, head_dim 32, 64 and 128, causal with and without a
window, Sq = Sk. Tolerance 1e-5 (atol and rtol): the same arithmetic in
another order. The plain LSE is held against a direct logsumexp of the
masked scores. The kernels themselves are held on the card
(tests/test_torch_kernels_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = 1e-5
CASES = [  # (S, H, KV, D, window)
    (37, 4, 4, 32, None),
    (37, 4, 1, 32, 8),
    (70, 8, 2, 64, None),
    (70, 4, 4, 64, 16),
    (45, 4, 1, 128, None),
    (45, 8, 8, 128, 20),
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in tests/test_torch_ssd_chained.py: the suite
    runs under xdist, where threaded einsums slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(s, h, kv, d, seed, b=2):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, kv, d)).astype(np.float32) for _ in range(2))
    do = rng.normal(size=(b, s, h, d)).astype(np.float32)
    return q, k, v, do


def _plain_grads(q, k, v, do, window):
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    kw = dict(causal=True, window=window, scale=q.shape[-1] ** -0.5)
    o, lse = fa.flash_attention_fwd_lse_plain(*t[:3], **kw)
    return fa.flash_attention_bwd_plain(*t[:3], o, lse, t[3], **kw)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("s,h,kv,d,window", CASES)
def test_bwd_plain_matches_autograd_of_the_plain_forward(s, h, kv, d, window):
    q, k, v, do = _inputs(s, h, kv, d, seed=1)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention_plain(*leaves, causal=True, window=window, scale=d ** -0.5)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w in zip(_plain_grads(q, k, v, do, window), want, strict=True):
        _close(g.numpy(), w.numpy())


@pytest.mark.parametrize("s,h,kv,d,window", CASES)
@pytest.mark.parametrize("jax_fn", ["jnp", "ref"])
def test_bwd_plain_matches_jax_vjp(s, h, kv, d, window, jax_fn):
    q, k, v, do = _inputs(s, h, kv, d, seed=2)
    if jax_fn == "jnp":
        def fn(q_, k_, v_):
            return jops.flash_attention(q_, k_, v_, causal=True, window=window, impl="jnp")
    else:
        def fn(q_, k_, v_):
            return jref.mha_reference(q_, k_, v_, causal=True, window=window)
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    for g, w in zip(_plain_grads(q, k, v, do, window), want, strict=True):
        _close(g.numpy(), w)


@pytest.mark.parametrize("s,h,kv,d,window", CASES)
def test_plain_lse_is_the_logsumexp_of_the_masked_scores(s, h, kv, d, window):
    q, k, v, _ = _inputs(s, h, kv, d, seed=3)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd_lse_plain(qt, kt, vt, causal=True, window=window,
                                              scale=scale)
    assert torch.equal(o, fa.flash_attention_plain(qt, kt, vt, causal=True, window=window,
                                                   scale=scale))
    grp = h // kv
    scores = torch.einsum("bqhd,bkhd->bhqk", qt, kt.repeat_interleave(grp, dim=2)) * scale
    pos = torch.arange(s)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    want = torch.logsumexp(torch.where(mask, scores, -torch.inf), dim=-1)
    assert lse.shape == (2, h, s) and lse.dtype == torch.float32
    _close(lse.numpy(), want.numpy())


def test_ops_attention_on_the_cpu_differentiates_the_plain_version():
    """On a CPU tensor under autograd, ops.flash_attention('auto') is the
    plain version (the CPU training path), with the plain backward's
    gradients; the backward kernel is never reached."""
    q, k, v, do = _inputs(33, 4, 2, 32, seed=4)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = fa.bwd_launches
    out = ops.flash_attention(*leaves, window=12)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert fa.bwd_launches == before
    for g, w in zip(got, _plain_grads(q, k, v, do, 12), strict=True):
        _close(g.numpy(), w.numpy())


def test_backward_kernel_wrapper_refuses_a_cpu_tensor():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(8, 2, 2, 32, seed=5))
    lse = torch.zeros((2, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_kernel(q, k, v, q, lse, do, causal=True, window=None, scale=1.0)

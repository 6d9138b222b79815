"""The flash-attention backward's plain versions against autograd and JAX.

``flash_attention_bwd_plain`` (the backward in PyTorch: P recomputed from
the forward's LSE, dS = P * (dO V^T - delta)) is held, at float32 on the
same numpy inputs, against
* ``torch.autograd`` through ``flash_attention_plain`` (the CPU training path);
* ``jax.vjp`` of ``repro.kernels.ops.flash_attention(impl="jnp")``, the path
  the JAX package trains through (its Pallas kernel has no backward), and of
  ``repro.kernels.ref.mha_reference``;
at GQA groups 1 and 4, head_dim 32, 64 and 128, causal with and without a
window, Sq = Sk. Tolerance 1e-5 (atol and rtol): the same arithmetic in
another order. The plain LSE is held against a direct logsumexp of the
masked scores.

``flash_attention_bwd_tiled_plain`` (the bf16 kernel's algorithm: 64-row
tiles within the kernel's visibility limits, per-query-head partials summed
in a fixed order, P and dS rounded to bf16 as mma operands) is held against
``jax.vjp`` of the jnp path and against ``flash_attention_bwd_plain``, at
float32 without rounding (1e-5) and with it (2e-2, chip_smoke's bf16
tolerance), at GQA groups 1, 2, 4 and 7, head_dim 32, 64 and 128, windows
none, 1 and 48, lengths around the 64-row tiles and Sq < Sk, and once at
S = 512. The visibility limits, as the kernel computes them, are checked
exhaustively against the mask. The kernels themselves are held on the card
(tests/test_torch_kernels_cuda.py).
"""
import functools

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


# (B, Sq, Sk, H, KV, D, window): lengths on and around the 64-row tiles,
# right-aligned queries (Sk - Sq = 1, 37, 64, 130), GQA groups 1, 2, 4, 7
TILED_CASES = [
    (2, 63, 63, 4, 4, 32, None),
    (2, 64, 64, 4, 2, 64, 1),
    (1, 65, 65, 8, 2, 128, 48),
    (1, 127, 127, 14, 2, 32, None),
    (1, 128, 128, 7, 1, 64, 48),
    (1, 129, 129, 8, 4, 128, None),
    (2, 129, 129, 4, 1, 64, 1),
    (1, 65, 66, 4, 4, 64, 48),
    (1, 65, 102, 8, 2, 32, 48),
    (1, 63, 193, 14, 2, 128, None),
    (1, 1, 130, 4, 2, 64, 1),
    (1, 64, 128, 8, 4, 32, 1),
    (1, 200, 200, 4, 2, 128, 48),
]


def _tiled_inputs(b, sq, sk, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, sk, kv, d)).astype(np.float32) for _ in range(2))
    return q, k, v, do


@functools.cache
def _jax_grads(b, sq, sk, h, kv, d, window):
    """jax.vjp of the jnp path on the case's inputs (cached: each case is
    held with and without rounding)."""
    q, k, v, do = _tiled_inputs(b, sq, sk, h, kv, d, seed=6)

    def fn(q_, k_, v_):
        return jops.flash_attention(q_, k_, v_, causal=True, window=window, impl="jnp")
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return tuple(np.asarray(g) for g in vjp(jnp.asarray(do)))


def _tiled_and_plain(b, sq, sk, h, kv, d, window, round_p_ds, seed=6):
    q, k, v, do = (torch.from_numpy(a) for a in _tiled_inputs(b, sq, sk, h, kv, d, seed))
    kw = dict(causal=True, window=window, scale=d ** -0.5)
    o, lse = fa.flash_attention_fwd_lse_plain(q, k, v, **kw)
    tiled = fa.flash_attention_bwd_tiled_plain(q, k, v, o, lse, do, round_p_ds=round_p_ds, **kw)
    return tiled, fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)


@pytest.mark.parametrize("case", TILED_CASES)
@pytest.mark.parametrize("round_p_ds", [False, True])
@pytest.mark.parametrize("against", ["jax_vjp", "plain"])
def test_tiled_bwd_plain_matches_jax_and_the_plain_backward(case, round_p_ds, against):
    """The kernel's algorithm against jax.vjp of the jnp path and against
    flash_attention_bwd_plain: 1e-5 in f32 without rounding (the same sums
    in another order), 2e-2 with P and dS rounded to bf16."""
    tiled, plain = _tiled_and_plain(*case, round_p_ds)
    want = _jax_grads(*case) if against == "jax_vjp" else [t.numpy() for t in plain]
    for g, w in zip(tiled, want, strict=True):
        assert g.dtype == torch.float32
        _close(g.numpy(), w, 2e-2 if round_p_ds else TOL)


def test_tiled_bwd_plain_rounding_at_s512():
    """The rounding plan over a longer sum: S = 512, qwen2-7b's 7 query heads
    a kv head at head_dim 128, P and dS in bf16, within 2e-2 of the
    unrounded plain backward."""
    tiled, plain = _tiled_and_plain(1, 512, 512, 14, 2, 128, None, True, seed=7)
    for g, w in zip(tiled, plain, strict=True):
        _close(g.numpy(), w.numpy(), 2e-2)


def test_tiled_bwd_plain_on_bf16_inputs():
    """bf16 inputs with P and dS rounded, as on the card: bf16 gradients
    within 2e-2 (chip_smoke's bf16 tolerance) of the plain backward on the
    same bf16 inputs."""
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _tiled_inputs(2, 130, 130, 8, 2, 64, seed=8))
    kw = dict(causal=True, window=48, scale=64 ** -0.5)
    o, lse = fa.flash_attention_fwd_lse_plain(q, k, v, **kw)
    got = fa.flash_attention_bwd_tiled_plain(q, k, v, o, lse, do, round_p_ds=True, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.bfloat16
        _close(g.float().numpy(), w.float().numpy(), 2e-2)


def test_bwd_kernels_counts_the_gqa_sum():
    assert fa.bwd_kernels(24, 24) == 3   # musicgen-medium, zamba2-1.2b: grp 1
    assert fa.bwd_kernels(28, 4) == 4    # qwen2-7b: grp 7, the partials' sum
    assert fa.bwd_kernels(4, 2) == 4


_FAR = 1 << 30  # the distance of a pair that is not visible


def _tiled_min(dist, axis, tile):
    """The least distance over each tile of `tile` positions along `axis`
    (padded with _FAR)."""
    n = dist.shape[axis]
    widths = (0, -n % tile) if axis == 1 else (0, 0, 0, -n % tile)
    padded = torch.nn.functional.pad(dist, widths, value=_FAR)
    if axis == 1:
        return padded.reshape(dist.shape[0], -1, tile).amin(-1)      # (rows, tiles)
    return padded.reshape(-1, tile, dist.shape[1]).amin(1)          # (tiles, keys)


@pytest.mark.parametrize("extra_keys", [0, 1, 37, 130])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_visibility_limits_cover_exactly_the_mask(extra_keys, causal):
    """For every Sq from 1 to 200, Sk = Sq + extra_keys, and every window from
    1 to Sk and none: the dK/dV pass's rows [i_lo, i_hi) of each 64-key tile
    (``bwd_query_rows``) are exactly the rows that see some key of the tile;
    the dQ pass's key tiles from k_begin up to k_end (``bwd_key_range``) for
    each 64-row query tile are exactly the tiles that hold a key some row of
    it sees, and k_end is one past the last such key. A pair is visible under
    window w iff it is visible under none and qpos - kpos < w, so a row sees
    some key of a tile under w iff the least distance over the tile's keys
    visible under none is below w: one minimum per (row, key tile) or (query
    tile, key) decides every window at once. That identity is checked
    against the mask itself at windows 1, 48 and Sk."""
    t = fa.BWD_TILE
    for sq in range(1, 201):
        sk = sq + extra_keys
        qpos, kpos = torch.arange(sq) + extra_keys, torch.arange(sk)
        dist = torch.where(fa._mask(qpos, kpos, causal, None), qpos[:, None] - kpos[None, :], _FAR)
        windows = list(range(1, sk + 1)) + [None]
        w_col = torch.tensor([w if w is not None else _FAR for w in windows])[:, None, None]
        n_kt, n_qt = -(-sk // t), -(-sq // t)

        # dK/dV pass: (window, row, key tile)
        sees = _tiled_min(dist, 1, t)[None] < w_col
        lim = torch.tensor([[fa.bwd_query_rows(j * t, sq, sk, causal, w) for j in range(n_kt)]
                            for w in windows])                          # (W, n_kt, 2)
        rows = torch.arange(sq)[None, :, None]
        want = (rows >= lim[:, None, :, 0]) & (rows < lim[:, None, :, 1])
        assert torch.equal(sees, want), (sq, sk)

        # dQ pass: (window, query tile, key)
        seen = _tiled_min(dist, 0, t)[None] < w_col
        lim = torch.tensor([[fa.bwd_key_range(j * t, sq, sk, causal, w) for j in range(n_qt)]
                            for w in windows])                          # (W, n_qt, 2)
        k_begin, k_end = lim[..., 0, None], lim[..., 1, None]
        assert not (seen & ((kpos < k_begin) | (kpos >= k_end))).any(), (sq, sk)
        assert seen.gather(2, k_end - 1).all(), (sq, sk)                # k_end is tight
        assert (k_begin % t == 0).all()
        starts = torch.arange(n_kt) * t
        visited = (starts >= k_begin) & (starts < k_end)                 # (W, n_qt, n_kt)
        tiles_seen = torch.nn.functional.pad(seen, (0, n_kt * t - sk)).reshape(
            len(windows), n_qt, n_kt, t).any(-1)
        assert torch.equal(visited, tiles_seen), (sq, sk)

        for i, w in ((0, 1), (47, 48), (sk - 1, sk)):
            if i < len(windows) - 1:
                mask = torch.nn.functional.pad(fa._mask(qpos, kpos, causal, w), (0, n_kt * t - sk))
                assert torch.equal(sees[i], mask.reshape(sq, n_kt, t).any(-1))

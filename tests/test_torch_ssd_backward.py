"""The SSD scan's backward in the port against autograd and JAX.

``ssd_scan_bwd_plain`` (the backward written out in PyTorch from the state
entering each chunk, no autograd inside) is held, at float32 on the same
numpy inputs, against
* ``torch.autograd`` through ``ssd_scan_plain`` (the CPU training path);
* ``jax.vjp`` of ``repro.kernels.ops.ssd_scan(impl="jnp")``, the path the
  JAX package trains through (its Pallas kernel has no backward);
for one and two groups, with and without an initial state and a cotangent
of the final state, at lengths that are a multiple of the chunk and that
are not, at the three (P, N, chunk) the kernels are built for. Tolerance
3e-4 (tests/test_kernels.py's SSD tolerance: the chunked form sums in
another order than JAX's), as rtol and, times each gradient's largest
magnitude, as atol: ddt and dA sum terms of hundreds that cancel.

JAX's jnp path evaluates exp(cs_i - cs_j) above the chunk's diagonal too
and masks it with ``where``, whose gradient is NaN once that exp overflows
(a spread of cs past 88: 128 rows of dt 0.1 at A = -16 reach 204). So at
chunk 128 the inputs held against JAX draw dt from [0.001, 0.03] (a spread
of at most 61); at dt up to 0.1 the plain backward is held against autograd
alone, and JAX's gradient is NaN there. The port evaluates the exp only on
or below the diagonal.

``ssd_scan_bwd_tiled_plain`` (the backward kernel's algorithm: a block per
(chunk, block of heads of one group, batch) in reverse ticket order, taking
its heads in turn, the chain's slot updated in place, one partial of dB and
of dC per block of heads and per-head partials of dA and dD, summed in
index order) is held against the same at float32 (3e-4), one head a block
and a whole group a block, and on bf16 inputs with the kernel's rounding
(its f32 operands as bf16 hi + lo pairs, its outputs rounded once; 2e-2,
chip_smoke's bf16 tolerance), and to bitwise repeatability.
``bwd_heads_per_block`` picks the heads a block takes. The kernel itself is
held on the card (tests/test_torch_kernels_cuda.py).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

TOL = {"float32": 3e-4, "bfloat16": 2e-2}
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
DT_MAX = {32: 0.1, 128: 0.03}  # the largest dt where JAX's gradient stays finite, per chunk
CASES = [  # (B, S, H, P, G, N, chunk, with_h0, with_dfinal)
    (2, 64, 4, 32, 1, 16, 32, False, False),     # the reduced shape, two full chunks
    (2, 70, 4, 32, 2, 16, 32, True, True),       # ... a ragged third chunk, two groups
    (1, 256, 4, 64, 1, 64, 128, True, False),    # zamba2-1.2b's shape
    (1, 200, 4, 64, 2, 64, 128, False, True),
    (1, 257, 2, 64, 1, 128, 128, True, True),    # mamba2-2.7b's shape
    (1, 128, 4, 64, 2, 128, 128, False, False),  # one chunk
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in tests/test_torch_ssd_chained.py: the suite
    runs under xdist, where threaded einsums slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, s, h, p, g, n, with_h0, with_dfinal, seed, dtype="float32", dt_max=0.1):
    """Numpy inputs (x, B, C and dy rounded to bfloat16 when asked, so every
    path sees the same values), dt from [0.001, dt_max] and A from [-16, -1],
    the card tests' ranges."""
    rng = np.random.default_rng(seed)

    def normal(shape, cast=False):
        a = rng.normal(size=shape).astype(np.float32)
        if cast and dtype == "bfloat16":
            a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        return a

    return {
        "x": normal((b, s, h, p), True),
        "dt": rng.uniform(0.001, dt_max, size=(b, s, h)).astype(np.float32),
        "A": -rng.uniform(1.0, 16.0, size=(h,)).astype(np.float32),
        "B": normal((b, s, g, n), True),
        "C": normal((b, s, g, n), True),
        "D": normal((h,)),
        "h0": normal((b, h, p, n)) if with_h0 else None,
        "dy": normal((b, s, h, p), True),
        "dfinal": normal((b, h, p, n)) if with_dfinal else None,
    }


def _jax_grads(d, chunk):
    """jax.vjp of the JAX package's jnp SSD: (dx, ddt, dA, dB, dC, dD, dh0)."""
    args = [jnp.asarray(d[k]) for k in ("x", "dt", "A", "B", "C", "D")]
    h0 = jnp.asarray(d["h0"]) if d["h0"] is not None else jnp.zeros(
        (d["x"].shape[0], d["x"].shape[2], d["x"].shape[3], d["B"].shape[3]), jnp.float32)
    fn = lambda *a: jops.ssd_scan(*a[:6], chunk=chunk, impl="jnp", initial_state=a[6])  # noqa: E731
    (y, final), vjp = jax.vjp(fn, *args, h0)
    dfinal = jnp.asarray(d["dfinal"]) if d["dfinal"] is not None else jnp.zeros_like(final)
    return [np.asarray(t) for t in vjp((jnp.asarray(d["dy"]), dfinal))]


def _torch(d, dtype=torch.float32):
    t = {k: None if v is None else torch.from_numpy(v) for k, v in d.items()}
    for k in ("x", "B", "C", "dy"):
        t[k] = t[k].to(dtype)
    return t


def _chunk_states(t, chunk):
    _, _, h_in = ssd.ssd_scan_plain(t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"],
                                    chunk=chunk, initial_state=t["h0"],
                                    return_chunk_states=True)
    return h_in


def _bwd(fn, t, chunk):
    return fn(t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"], _chunk_states(t, chunk),
              t["dy"], t["dfinal"], chunk=chunk)


def _close(got, want, tol):
    """Each gradient within tol (rtol) and tol times its largest reference
    magnitude (atol): ddt and dA sum terms of hundreds that cancel, so an
    element near zero carries the roundoff of its terms, not its own."""
    for name, g, w in zip(NAMES[:len(want)], got, want, strict=True):
        g, w = np.asarray(g.float() if isinstance(g, torch.Tensor) else g), np.asarray(w)
        np.testing.assert_allclose(g, w, atol=tol * np.abs(w).max(), rtol=tol, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_bwd_plain_matches_autograd_and_jax(case):
    b, s, h, p, g, n, chunk, with_h0, with_df = case
    d = _inputs(b, s, h, p, g, n, with_h0, with_df, seed=s + h, dt_max=DT_MAX[chunk])
    t = _torch(d)
    got = _bwd(ssd.ssd_scan_bwd_plain, t, chunk)
    assert [x.dtype for x in got] == [torch.float32] * 7
    assert got[0].shape == (b, s, h, p) and got[3].shape == (b, s, g, n)
    assert got[6].shape == (b, h, p, n)
    _close(got, _jax_grads(d, chunk), TOL["float32"])
    leaves = [t[k].clone().requires_grad_() for k in ("x", "dt", "A", "B", "C", "D")]
    h0 = t["h0"].clone().requires_grad_() if with_h0 else None
    y, final = ssd.ssd_scan_plain(*leaves, chunk=chunk, initial_state=h0)
    loss = (y * t["dy"]).sum() + ((final * t["dfinal"]).sum() if with_df else 0.0)
    want = torch.autograd.grad(loss, leaves + ([h0] if with_h0 else []))
    _close(got[:len(want)], [w.numpy() for w in want], TOL["float32"])


@pytest.mark.parametrize("n", [64, 128])
def test_bwd_plain_matches_autograd_where_jax_overflows(n):
    """dt up to 0.1 over chunks of 128: the plain backward and the tiled one
    against autograd through ssd_scan_plain; JAX's gradient is NaN here."""
    d = _inputs(1, 256, 4, 64, 1, n, True, True, seed=n)
    d["A"][0], d["dt"][:, :, 0] = -16.0, 0.09   # head 0: a spread of 184 over a chunk
    t = _torch(d)
    assert np.isnan(_jax_grads(d, 128)[1]).any()
    leaves = [t[k].clone().requires_grad_() for k in ("x", "dt", "A", "B", "C", "D", "h0")]
    y, final = ssd.ssd_scan_plain(*leaves[:6], chunk=128, initial_state=leaves[6])
    want = torch.autograd.grad((y * t["dy"]).sum() + (final * t["dfinal"]).sum(), leaves)
    for fn in (ssd.ssd_scan_bwd_plain,
               functools.partial(ssd.ssd_scan_bwd_tiled_plain, heads_per_block=2)):
        got = _bwd(fn, t, 128)
        assert all(torch.isfinite(x).all() for x in got)
        _close(got, [w.numpy() for w in want], TOL["float32"])


@pytest.mark.parametrize("whole_group", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_bwd_tiled_plain_matches_jax_and_the_plain_backward(case, whole_group):
    """One head a block, and every head of a group in one block (its dB
    and dC summed over the heads in order before the group's sum)."""
    b, s, h, p, g, n, chunk, with_h0, with_df = case
    d = _inputs(b, s, h, p, g, n, with_h0, with_df, seed=s + h + 1, dt_max=DT_MAX[chunk])
    t = _torch(d)
    tiled = functools.partial(ssd.ssd_scan_bwd_tiled_plain,
                              heads_per_block=h // g if whole_group else 1)
    got = _bwd(tiled, t, chunk)
    _close(got, _jax_grads(d, chunk), TOL["float32"])
    _close(got, [w.numpy() for w in _bwd(ssd.ssd_scan_bwd_plain, t, chunk)], TOL["float32"])


@pytest.mark.parametrize("case", [CASES[1], CASES[4]])
def test_bwd_tiled_plain_with_the_kernels_bf16_rounding(case):
    """bf16 x, B, C and dy: the kernel's products take them as they are,
    its f32 operands (M, dG, gn, the chunk states and exp(cs) dy) as bf16
    hi + lo pairs, and sum in f32; it rounds dx, dB and dC to bf16 once.
    Against jax.vjp on the same values in f32 and against the plain
    backward, with a group's heads in one block."""
    b, s, h, p, g, n, chunk, with_h0, with_df = case
    d = _inputs(b, s, h, p, g, n, with_h0, with_df, seed=7, dtype="bfloat16",
                dt_max=DT_MAX[chunk])
    t = _torch(d, torch.bfloat16)
    tiled = functools.partial(ssd.ssd_scan_bwd_tiled_plain, heads_per_block=h // g)
    got = _bwd(tiled, t, chunk)
    assert [x.dtype for x in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16, torch.bfloat16, torch.float32,
                                      torch.float32]
    _close(got, _jax_grads(d, chunk), TOL["bfloat16"])
    _close(got, [w.float().numpy() for w in _bwd(ssd.ssd_scan_bwd_plain, t, chunk)],
           TOL["bfloat16"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn", [ssd.ssd_scan_bwd_plain, ssd.ssd_scan_bwd_tiled_plain,
                                functools.partial(ssd.ssd_scan_bwd_tiled_plain,
                                                  heads_per_block=2)])
def test_bwd_is_bitwise_repeatable(fn, dtype):
    """The chain runs in ticket order, each block sums its heads in head
    order and the group and block sums run in index order: two calls are
    equal bit for bit, with one head a block and with two."""
    d = _inputs(2, 70, 4, 32, 2, 16, True, True, seed=3)
    t = _torch(d, dtype)
    first, again = _bwd(fn, t, 32), _bwd(fn, t, 32)
    assert all(torch.equal(a, f) for a, f in zip(again, first, strict=True))


def test_bwd_heads_per_block_divides_the_group_and_fills_the_card():
    """A divisor of the group's heads, at most MAX_HEADS_PER_BLOCK; at
    phase T's shapes one wave of 128 blocks on 132 SMs (mamba2-2.7b's 80
    heads 10 a block, zamba2-1.2b's 64 heads 8 a block); where more blocks
    than that fit a wave, one head a block."""
    for h, g, per_head, slots in ((80, 1, 16, 132), (64, 1, 16, 132), (4, 1, 16, 528),
                                  (8, 2, 4, 132), (7, 1, 3, 132), (256, 1, 1, 1), (6, 3, 5, 1)):
        r = ssd.bwd_heads_per_block(h, g, per_head, slots)
        assert (h // g) % r == 0 and 1 <= r <= ssd.MAX_HEADS_PER_BLOCK, (h, g, r)
    assert ssd.bwd_heads_per_block(80, 1, 16, 132) == 10
    assert ssd.bwd_heads_per_block(64, 1, 16, 132) == 8
    assert ssd.bwd_heads_per_block(4, 1, 16, 528) == 1
    assert ssd.bwd_heads_per_block(256, 1, 1, 1) == 16


def test_bwd_ticket_order_runs_each_chunk_after_the_next():
    """Every (chunk, head block, batch) draws one ticket, and every block of
    chunk c + 1 draws before any block of chunk c (the chain's waits point
    back)."""
    nc, h, b = 3, 5, 2
    blocks = [ssd.bwd_ticket_block(t, nc, h, b) for t in range(nc * h * b)]
    assert sorted(blocks) == sorted((c, hh, bb) for c in range(nc) for hh in range(h)
                                    for bb in range(b))
    chunks = [c for c, _, _ in blocks]
    assert chunks == sorted(chunks, reverse=True)


@pytest.mark.parametrize("chunk,p,n", [(32, 32, 16), (128, 64, 64)])
def test_chunk_states_are_the_scan_of_the_prefix(chunk, p, n):
    """h_in[:, c] is h0 at c = 0, then the final state of the scan over the
    first c chunks."""
    d = _inputs(2, 3 * chunk - 5, 4, p, 1, n, True, False, seed=11)
    t = _torch(d)
    h_in = _chunk_states(t, chunk)
    assert h_in.shape == (2, 3, 4, p, n) and h_in.dtype == torch.float32
    torch.testing.assert_close(h_in[:, 0], t["h0"], atol=0, rtol=0)
    for c in (1, 2):
        cut = {k: t[k][:, :c * chunk] for k in ("x", "dt", "B", "C")}
        _, final = ssd.ssd_scan_plain(cut["x"], cut["dt"], t["A"], cut["B"], cut["C"], t["D"],
                                      chunk=chunk, initial_state=t["h0"])
        torch.testing.assert_close(h_in[:, c], final, atol=1e-5, rtol=1e-5)


def test_ops_ssd_scan_under_grad_on_the_cpu_is_autograd_through_the_plain_version():
    """On a CPU tensor 'auto' is the plain version under autograd too: its
    gradients are autograd's through ssd_scan_plain, bit for bit, and no
    kernel is launched."""
    d = _inputs(2, 70, 4, 32, 2, 16, True, False, seed=5)
    t = _torch(d)
    launched = (ssd.launches, ssd.bwd_launches)
    grads = []
    for fn in (lambda *a, **kw: ops.ssd_scan(*a, **kw), ssd.ssd_scan_plain):
        leaves = [t[k].clone().requires_grad_() for k in ("x", "dt", "A", "B", "C", "D", "h0")]
        y, final = fn(*leaves[:6], chunk=32, initial_state=leaves[6])
        grads.append(torch.autograd.grad((y * t["dy"]).sum() + final.sum(), leaves))
    assert all(torch.equal(a, b) for a, b in zip(*grads, strict=True))
    assert (ssd.launches, ssd.bwd_launches) == launched


def test_bwd_kernel_refuses_a_cpu_tensor():
    d = _inputs(1, 40, 4, 32, 1, 16, False, False, seed=2)
    t = _torch(d)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        _bwd(ssd.ssd_scan_bwd_kernel, t, 32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ssd.SsdScanFn.apply(t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"], None, 32)

"""The PyTorch port's SSD scan and SSM decode step against the JAX package's.

On the CPU ``ops.ssd_scan`` runs the plain chunked version beside the CUDA
kernel (``impl="plain"``, which ``auto`` picks for a CPU tensor) or the
sequential oracle (``impl="ref"``). Both are held against the JAX Pallas
kernel in interpret mode and the JAX oracle over tests/test_kernels.py's
SSD shapes, with and without an initial state. Tolerances: float32 3e-4,
the SSD tolerance of tests/test_kernels.py (the chunked form sums in
another order than the recurrence); bfloat16 2e-2 (the outputs round to
bf16 at other points in the two frameworks). The CUDA kernel itself is
held against the plain version in tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = {"float32": 3e-4, "bfloat16": 2e-2}

SSD_SHAPES = [
    # (B, S, H, P, G, N, chunk), as tests/test_kernels.py
    (1, 96, 2, 16, 1, 16, 32),
    (2, 130, 4, 32, 2, 16, 64),
    (1, 64, 4, 64, 1, 64, 32),
]


def _np(rng, shape, dtype="float32"):
    """Normal numpy data, rounded to bfloat16 when asked so both packages
    see identical inputs."""
    a = rng.normal(size=shape).astype(np.float32)
    if dtype == "bfloat16":
        a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return a


def _ssd_inputs(shape, seed, dtype="float32", with_h0=False):
    b, s, h, p, g, n, _ = shape
    rng = np.random.default_rng(seed)
    return {
        "x": _np(rng, (b, s, h, p), dtype),
        "dt": rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32),
        "A": -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32),
        "B": _np(rng, (b, s, g, n), dtype),
        "C": _np(rng, (b, s, g, n), dtype),
        "D": _np(rng, (h,)),
        "h0": _np(rng, (b, h, p, n)) if with_h0 else None,
    }


def _jax(inp, dtype):
    cast = {"x": dtype, "B": dtype, "C": dtype}
    return {k: None if v is None else jnp.asarray(v, getattr(jnp, cast.get(k, "float32")))
            for k, v in inp.items()}


def _torch(inp, dtype):
    cast = {"x": dtype, "B": dtype, "C": dtype}
    return {k: None if v is None else
            torch.from_numpy(v).to(getattr(torch, cast.get(k, "float32")))
            for k, v in inp.items()}


def _close(got, want, dtype):
    got, want = (x.float().numpy() if isinstance(x, torch.Tensor)
                 else np.asarray(x, np.float32) for x in (got, want))
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])


def _jax_scan(inp, dtype, chunk, jax_impl):
    j = _jax(inp, dtype)
    if jax_impl == "ref":
        return jref.ssd_reference(j["x"], j["dt"], j["A"], j["B"], j["C"], j["D"],
                                  initial_state=j["h0"])
    return jops.ssd_scan(j["x"], j["dt"], j["A"], j["B"], j["C"], j["D"], chunk=chunk,
                         impl=jax_impl, initial_state=j["h0"])


def _port_scan(inp, dtype, chunk, impl):
    t = _torch(inp, dtype)
    return ops.ssd_scan(t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"], chunk=chunk,
                        impl=impl, initial_state=t["h0"])


@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("impl", ["auto", "ref"])
@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_matches_jax(jax_impl, impl, shape, with_h0):
    chunk = shape[-1]
    inp = _ssd_inputs(shape, seed=1, with_h0=with_h0)
    want_y, want_h = _jax_scan(inp, "float32", chunk, jax_impl)
    got_y, got_h = _port_scan(inp, "float32", chunk, impl)
    assert got_y.dtype == torch.float32 and got_y.shape == inp["x"].shape
    b, _, h, p, _, n, _ = shape
    assert got_h.dtype == torch.float32 and got_h.shape == (b, h, p, n)
    _close(got_y, want_y, "float32")
    _close(got_h, want_h, "float32")


@pytest.mark.parametrize("impl", ["plain", "ref"])
def test_ssd_scan_bfloat16_matches_jax(impl):
    """bf16 x, B and C (dt, A, D and the state stay f32), at the serving
    path's chunk of 128 over a ragged last chunk."""
    shape = (1, 150, 4, 64, 1, 64, 128)
    inp = _ssd_inputs(shape, seed=2, dtype="bfloat16", with_h0=True)
    want_y, want_h = _jax_scan(inp, "bfloat16", 128, "pallas_interpret")
    got_y, got_h = _port_scan(inp, "bfloat16", 128, impl)
    assert got_y.dtype == torch.bfloat16
    _close(got_y, want_y, "bfloat16")
    _close(got_h, want_h, "bfloat16")


def test_ssd_scan_chunk_invariance():
    """The chunked form does not depend on the chunk length."""
    inp = _ssd_inputs((2, 100, 4, 16, 2, 16, 0), seed=3, with_h0=True)
    want = _port_scan(inp, "float32", 0, "ref")
    for chunk in (16, 32, 128):
        got = _port_scan(inp, "float32", chunk, "plain")
        for g, w in zip(got, want, strict=True):
            _close(g, w, "float32")


def test_ssm_decode_step_matches_jax():
    rng = np.random.default_rng(4)
    b, h, p, g, n = 3, 8, 16, 2, 16
    x, B, C = _np(rng, (b, h, p)), _np(rng, (b, g, n)), _np(rng, (b, g, n))
    dt = rng.uniform(0.01, 0.2, size=(b, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32)
    D, state = _np(rng, (h,)), _np(rng, (b, h, p, n))
    want_y, want_s = jops.ssm_decode_step(*(jnp.asarray(a) for a in (x, dt, A, B, C, D, state)))
    got_y, got_s = ops.ssm_decode_step(*(torch.from_numpy(a) for a in (x, dt, A, B, C, D, state)))
    _close(got_y, want_y, "float32")
    _close(got_s, want_s, "float32")


def test_ssm_decode_matches_scan():
    """Recurrent decode steps must agree with the chunked scan
    (tests/test_kernels.py::test_ssm_decode_matches_scan)."""
    inp = _torch(_ssd_inputs((2, 17, 2, 8, 1, 8, 0), seed=5), "float32")
    want_y, want_h = ops.ssd_scan(inp["x"], inp["dt"], inp["A"], inp["B"], inp["C"], inp["D"],
                                  chunk=8, impl="plain")
    state = torch.zeros_like(want_h)
    ys = []
    for t in range(inp["x"].shape[1]):
        y, state = ops.ssm_decode_step(inp["x"][:, t], inp["dt"][:, t], inp["A"],
                                       inp["B"][:, t], inp["C"][:, t], inp["D"], state)
        ys.append(y)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), want_y.numpy(), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(state.numpy(), want_h.numpy(), atol=2e-4, rtol=2e-4)

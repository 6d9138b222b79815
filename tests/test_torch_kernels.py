"""The PyTorch port's attention kernels against the JAX package's.

On the CPU the port's entry points run the plain PyTorch version beside
each CUDA kernel; it is held against the JAX Pallas kernels (interpret
mode) and the JAX oracles over the shape, dtype and window grid of
tests/test_kernels.py (the CUDA kernels themselves are held against their
plain versions in tests/test_torch_kernels_cuda.py). Tolerances: float32
2e-5, bfloat16 2e-2, as in tests/test_kernels.py (bf16 rounds at other
points in the two frameworks).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

ATTN_SHAPES = [
    # (B, S, H, KV, D)
    (1, 128, 4, 4, 64),
    (2, 200, 8, 2, 32),
    (1, 64, 6, 3, 128),
    (1, 19, 14, 2, 32),      # grp = 7, as qwen2-7b's 28 query heads over 4 kv heads
    (1, 19, 32, 32, 64),     # zamba2-1.2b's shared attention (grp = 1), speculative prefill
]
DECODE_SHAPES = [
    # (B, H, KV, D, Smax)
    (2, 8, 2, 64, 256),
    (3, 4, 4, 32, 100),
    (1, 6, 2, 128, 513),
    (4, 14, 2, 32, 192),     # grp = 7
    (4, 32, 32, 64, 192),    # zamba2-1.2b's serving step (grp = 1)
]
WINDOWS = [(True, None), (True, 48), (False, None)]


def _np(rng, shape, dtype):
    """Normal numpy data, rounded to bfloat16 when asked so both packages
    see identical inputs."""
    a = rng.normal(size=shape).astype(np.float32)
    if dtype == "bfloat16":
        a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return a


def _to_torch(a, dtype, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))


def _to_jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _close(got, want, dtype):
    got, want = (x.float().cpu().numpy() if isinstance(x, torch.Tensor)
                 else np.asarray(x, np.float32) for x in (got, want))
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])


def _flash_inputs(shape, dtype, seed):
    b, s, h, kv, d = shape
    rng = np.random.default_rng(seed)
    return (_np(rng, (b, s, h, d), dtype), _np(rng, (b, s, kv, d), dtype),
            _np(rng, (b, s, kv, d), dtype))


def _decode_inputs(shape, dtype, seed):
    b, h, kv, d, smax = shape
    rng = np.random.default_rng(seed)
    q = _np(rng, (b, h, d), dtype)
    kc, vc = _np(rng, (b, smax, kv, d), dtype), _np(rng, (b, smax, kv, d), dtype)
    lens = rng.integers(1, smax + 1, size=(b,)).astype(np.int32)
    return q, kc, vc, lens


@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", WINDOWS)
def test_flash_attention_plain_matches_jax(jax_impl, shape, dtype, causal, window):
    q, k, v = _flash_inputs(shape, dtype, seed=1)
    want = jops.flash_attention(_to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype),
                                causal=causal, window=window, impl=jax_impl,
                                block_q=64, block_k=64)
    got = ops.flash_attention(_to_torch(q, dtype), _to_torch(k, dtype), _to_torch(v, dtype),
                              causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 40])
def test_decode_attention_plain_matches_jax(jax_impl, shape, dtype, window):
    q, kc, vc, lens = _decode_inputs(shape, dtype, seed=2)
    want = jops.decode_attention(_to_jax(q, dtype), _to_jax(kc, dtype), _to_jax(vc, dtype),
                                 jnp.asarray(lens), window=window, impl=jax_impl, block_k=64)
    got = ops.decode_attention(_to_torch(q, dtype), _to_torch(kc, dtype), _to_torch(vc, dtype),
                               torch.from_numpy(lens), window=window)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("causal,window", WINDOWS)
def test_mha_reference_matches_jax(shape, causal, window):
    q, k, v = _flash_inputs(shape, "float32", seed=3)
    want = jref.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=causal, window=window, impl="ref")
    _close(got, want, "float32")


def test_mha_reference_right_aligns_queries():
    """Fewer queries than keys: query i sits at position i + Sk - Sq."""
    rng = np.random.default_rng(4)
    q, k, v = _np(rng, (1, 5, 4, 32), "float32"), _np(rng, (1, 12, 2, 32), "float32"), \
        _np(rng, (1, 12, 2, 32), "float32")
    want = jref.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=6)
    for impl in ("ref", "plain"):
        got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  window=6, impl=impl)
        _close(got, want, "float32")


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("window", [None, 40])
def test_decode_reference_matches_jax(shape, window):
    q, kc, vc, lens = _decode_inputs(shape, "float32", seed=5)
    want = jref.decode_attention_reference(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                           jnp.asarray(lens), window=window)
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                               torch.from_numpy(lens), window=window, impl="ref")
    _close(got, want, "float32")


def test_kernel_impl_on_cpu_tensor_raises():
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs((1, 8, 4, 2, 32), "float32", seed=6))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, impl="kernel")
    qd, kc, vc, lens = (torch.from_numpy(a) for a in
                        _decode_inputs((1, 4, 2, 32, 16), "float32", seed=6))
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(qd, kc, vc, lens, impl="kernel")
    x, B = torch.zeros((1, 8, 2, 64)), torch.zeros((1, 8, 1, 64))
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_scan(x, torch.zeros((1, 8, 2)), torch.zeros(2), B, B, torch.zeros(2),
                     impl="kernel")


def test_unknown_impl_raises():
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs((1, 8, 4, 2, 32), "float32", seed=7))
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, k, v, impl="pallas")

"""The port's hand-written CUDA kernels against their plain PyTorch versions.

These need a CUDA card and skip without one; they import no JAX, so they
run where only PyTorch is installed:

  PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

The grid is tests/test_kernels.py's batch, sequence, GQA-group and window
cases at head_dim 128 (the only head_dim the kernels are built for), plus
the qwen2-7b shapes of the serving path. Tolerances: float32 2e-5,
bfloat16 2e-2 (the kernel and the plain version sum in another order and
round bf16 outputs independently).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

ATTN_SHAPES = [
    # (B, S, H, KV, D)
    (1, 128, 4, 4, 128),
    (2, 200, 8, 2, 128),
    (1, 64, 6, 3, 128),
    (1, 3, 28, 4, 128),       # qwen2-7b authoritative prefill
    (1, 19, 28, 4, 128),      # qwen2-7b speculative prefill
    (1, 300, 28, 4, 128),
]
DECODE_SHAPES = [
    # (B, H, KV, D, Smax)
    (2, 8, 2, 128, 256),
    (3, 4, 4, 128, 100),
    (1, 6, 2, 128, 513),
    (4, 28, 4, 128, 192),     # qwen2-7b serving step
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, dtype)


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, None)])
def test_flash_attention_kernel_matches_plain(cuda_device, shape, dtype, causal, window):
    b, s, h, kv, d = shape
    rng = np.random.default_rng(8)
    q = _randn(rng, (b, s, h, d), dtype, cuda_device)
    k, v = (_randn(rng, (b, s, kv, d), dtype, cuda_device) for _ in range(2))
    want = ops.flash_attention(q, k, v, causal=causal, window=window, impl="plain")
    got = ops.flash_attention(q, k, v, causal=causal, window=window, impl="kernel")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 40])
def test_decode_attention_kernel_matches_plain(cuda_device, shape, dtype, window):
    b, h, kv, d, smax = shape
    rng = np.random.default_rng(9)
    q = _randn(rng, (b, h, d), dtype, cuda_device)
    kc, vc = (_randn(rng, (b, smax, kv, d), dtype, cuda_device) for _ in range(2))
    lens = torch.from_numpy(rng.integers(1, smax + 1, size=(b,)).astype(np.int32)).to(cuda_device)
    want = ops.decode_attention(q, kc, vc, lens, window=window, impl="plain")
    got = ops.decode_attention(q, kc, vc, lens, window=window, impl="kernel")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, want, dtype)


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 8, 4, 48), device=cuda_device)          # head_dim 48
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2], impl="kernel")
    q = torch.zeros((1, 8, 4, 128), device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q, q, q, impl="kernel")

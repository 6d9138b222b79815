"""The port's hand-written CUDA kernels against their plain PyTorch versions.

These need a CUDA card and skip without one; they import no JAX, so they
run where only PyTorch is installed:

  PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

The attention grid is tests/test_kernels.py's batch, sequence, GQA-group
and window cases at head_dim 128 (the only head_dim the attention kernels
are built for), plus the qwen2-7b shapes of the serving path. Tolerances:
float32 2e-5, bfloat16 2e-2 (the kernel and the plain version sum in
another order and round bf16 outputs independently). The SSD scan is held
at mamba2-2.7b's prompt lengths (3 and 19 tokens, 80 heads) and at
tests/test_kernels.py's lengths over one, two and sixteen chunks, for one
and two groups, both supported state sizes, with and without an initial
state; float32 at 3e-4 (tests/test_kernels.py's SSD tolerance), bfloat16
at 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 3e-4, torch.bfloat16: 2e-2}

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


def _close(got, want, dtype, tols=TOL):
    torch.testing.assert_close(got.float(), want.float(), atol=tols[dtype], rtol=tols[dtype])


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


SSD_SHAPES = [
    # (B, S, H): mamba2-2.7b's prompts, then one, two and sixteen chunks of 128
    (1, 3, 80),
    (1, 19, 80),
    (2, 96, 8),
    (1, 130, 8),
    (1, 2048, 8),
]


def _ssd_inputs(rng, b, s, h, g, n, dtype, with_h0, device, p=64):
    x = _randn(rng, (b, s, h, p), dtype, device)
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, size=(b, s, h)).astype(np.float32)).to(device)
    A = -torch.from_numpy(rng.uniform(1.0, 16.0, size=(h,)).astype(np.float32)).to(device)
    B, C = (_randn(rng, (b, s, g, n), dtype, device) for _ in range(2))
    D = _randn(rng, (h,), torch.float32, device)
    h0 = _randn(rng, (b, h, p, n), torch.float32, device) if with_h0 else None
    return (x, dt, A, B, C, D), h0


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain(cuda_device, shape, g, n, with_h0, dtype):
    b, s, h = shape
    args, h0 = _ssd_inputs(np.random.default_rng(10), b, s, h, g, n, dtype, with_h0,
                           cuda_device)
    want_y, want_h = ops.ssd_scan(*args, impl="plain", initial_state=h0)
    got_y, got_h = ops.ssd_scan(*args, impl="kernel", initial_state=h0)
    torch.cuda.synchronize()
    assert got_y.dtype == dtype and got_y.shape == args[0].shape
    assert got_h.dtype == torch.float32 and got_h.shape == (b, h, 64, n)
    _close(got_y, want_y, dtype, SSD_TOL)
    _close(got_h, want_h, dtype, SSD_TOL)


def test_ssd_kernel_rejects_what_it_does_not_take(cuda_device):
    rng = np.random.default_rng(11)
    args, _ = _ssd_inputs(rng, 1, 8, 4, 1, 64, torch.float32, False, cuda_device, p=32)
    with pytest.raises(ValueError, match="head_dim"):
        ops.ssd_scan(*args, impl="kernel")
    args, _ = _ssd_inputs(rng, 1, 8, 4, 1, 64, torch.float32, False, cuda_device)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(*args, chunk=64, impl="kernel")
    with pytest.raises(ValueError, match="d_state"):
        ops.ssd_scan(*_ssd_inputs(rng, 1, 8, 4, 1, 32, torch.float32, False, cuda_device)[0],
                     impl="kernel")

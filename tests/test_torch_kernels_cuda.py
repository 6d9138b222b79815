"""The port's hand-written CUDA kernels against their plain PyTorch versions.

These need a CUDA card and skip without one; they import no JAX, so they
run where only PyTorch is installed:

  PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

The attention grid is tests/test_kernels.py's batch, sequence, GQA-group
and window cases at head_dim 128, plus the qwen2-7b shapes of the serving
path, zamba2-1.2b's shared attention (32 query and 32 kv heads of head_dim
64) and a shape at head_dim 32, the other two head_dims the attention
kernels are built for. Tolerances:
float32 2e-5, bfloat16 2e-2 (the kernel and the plain version sum in
another order and round bf16 outputs independently). The SSD scan is held
at mamba2-2.7b's prompt lengths (3 and 19 tokens, 80 heads) and at
tests/test_kernels.py's lengths over one, two and sixteen chunks, at the
chunk's edges (127 to 257), and over 32 chunks of 4 x 80 heads (more
blocks than the card holds), for one and two groups, both supported state
sizes, with and without an initial state, bitwise from call to call and
with the device's chain flags left zero; float32 at 3e-4
(tests/test_kernels.py's SSD tolerance), bfloat16 at 2e-2. The split-KV partials are held on 4 slices of a cache, passed as
views of it, with f32 q against bf16 and f32 caches: the qwen2-7b sharded
serving step (Smax 192, slices of 48 that are full, partial and empty) and
Smax 4096 with and without a window; combined, they are held against
decode attention over the whole cache. The redesigned kernels are also held
at the decode split's boundaries (lengths around multiples of 64, every
GQA group up to 16), at flash's 64-row tile boundaries with right-aligned
queries (Sq < Sk) and windows from one key to all of them, and to bitwise
repeatability. The SSD scan is also held at the reduced configs' shape
(P = 32, N = 16, chunk 32) against both plain versions; a model with padded
attention heads (head_dim 32) on the card against the CPU; and the MoE
block (f32) on the card against the CPU and bitwise from call to call.
The flash-attention backward kernel (training) is held against its plain
version at every head_dim, lengths at the tiles' edges (1, 63, 64, 65,
127, 128, 129, 200), GQA groups 1, 2, 4 and 7, with and without a window
and with Sq < Sk (float32 2e-5, bfloat16 2e-2), and to bitwise
repeatability at GQA groups 1 and 7; nvcc's report must show no spill in
any of its instantiations, and the SASS of its bf16 dK/dV and dQ kernels
must hold tensor-core (HMMA) instructions; the forward's
log-sum-exp output against the plain LSE, with o unchanged bit for bit;
autograd through ops.flash_attention on the card against autograd over the
oracle. The SSD backward kernel (training) is held against
ssd_scan_bwd_plain at the three built (P, N, chunk), ragged last chunks,
one and two groups, with and without an initial state and a cotangent of
the final state, and over 128 chunks (float32 3e-4, bfloat16 2e-2, both
also times each gradient's largest magnitude as atol), with 1, 2 and 4
heads a block, and to bitwise repeatability at the card's plan of heads a
block and at 4; the plan at phase T's shapes (one block an SM, whole
waves); the forward writing its chunk states leaves y and the final
state unchanged bit for bit; no instantiation spills, and the bf16 ones
hold more HMMA than the simple kernel's; ops.ssd_scan under autograd on the card runs SsdScanFn, whose
gradients are the plain backward's; and the decode entries raise under
autograd on the card. Ranks that share the card over gloo
(``launch.dist.spawn``): the sequence-sharded decode (reduced qwen2-7b, f32
and int8 caches, the partials kernel once a layer a step on each rank) and
the expert-parallel MoE block with its gradients, each against the same 2
ranks on the CPU at 1e-4; and each collective op the mesh does not stage
through the host (``launch.mesh.HOST_STAGED``) taking CUDA tensors of
every dtype the port reduces.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
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
    (1, 3, 32, 32, 64),       # zamba2-1.2b's shared attention: authoritative prefill
    (1, 19, 32, 32, 64),      # ... speculative prefill
    (1, 300, 32, 32, 64),
    (2, 200, 8, 2, 32),       # head_dim 32 (the reduced configs)
]
DECODE_SHAPES = [
    # (B, H, KV, D, Smax)
    (2, 8, 2, 128, 256),
    (3, 4, 4, 128, 100),
    (1, 6, 2, 128, 513),
    (4, 28, 4, 128, 192),     # qwen2-7b serving step
    (4, 32, 32, 64, 192),     # zamba2-1.2b's serving step (grp 1)
    (2, 8, 2, 64, 513),
    (3, 8, 4, 32, 100),       # head_dim 32
]
HEAD_DIMS = [32, 64, 128]
FWD_HEAD_DIMS = HEAD_DIMS + [224]   # the forward flash and plain decode entries also take 224


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


SPLIT_LENGTHS = [1, 31, 32, 33, 63, 64, 65, 192]   # on and around the 64-key splits


@pytest.mark.parametrize("d", FWD_HEAD_DIMS)
@pytest.mark.parametrize("grp", [1, 2, 7, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 40, 100])
def test_decode_kernel_at_split_boundaries(cuda_device, d, grp, dtype, window):
    """Smax 192 over 8 sequences and 2 kv heads: 3 splits of 64 keys
    without a window (later splits empty for short rows), 2 under a window
    of 100, 1 under 40; every GQA group size up to the 16 rows of a tile,
    at every head_dim the kernel is built for (the merges map (group row,
    head dim) pairs onto the block's threads)."""
    b, kv, smax = len(SPLIT_LENGTHS), 2, 192
    assert da.split_plan(smax, window, b, kv)[0] == {None: 3, 100: 2, 40: 1}[window]
    rng = np.random.default_rng(15)
    q = _randn(rng, (b, kv * grp, d), dtype, cuda_device)
    kc, vc = (_randn(rng, (b, smax, kv, d), dtype, cuda_device) for _ in range(2))
    lens = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32, device=cuda_device)
    want = ops.decode_attention(q, kc, vc, lens, window=window, impl="plain")
    got = ops.decode_attention(q, kc, vc, lens, window=window, impl="kernel")
    torch.cuda.synchronize()
    _close(got, want, dtype)


FLASH_SQ = [1, 3, 19, 63, 64, 65, 300]


@pytest.mark.parametrize("d", FWD_HEAD_DIMS)
@pytest.mark.parametrize("sq", FLASH_SQ)
@pytest.mark.parametrize("extra_keys", [0, 37])
@pytest.mark.parametrize("window", [None, 1, 48, 400])
@pytest.mark.parametrize("grp", [1, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_tiles_and_right_alignment(cuda_device, d, sq, extra_keys, window, grp,
                                               dtype):
    """Query counts on and around the 64-row tiles, Sq < Sk (queries
    right-aligned to the last keys), windows of one key, of part of the
    keys and of all of them, GQA groups 1 and 7, every head_dim the kernel
    is built for."""
    sk, kv = sq + extra_keys, 2
    rng = np.random.default_rng(16)
    q = _randn(rng, (1, sq, kv * grp, d), dtype, cuda_device)
    k, v = (_randn(rng, (1, sk, kv, d), dtype, cuda_device) for _ in range(2))
    want = ops.flash_attention(q, k, v, causal=True, window=window, impl="plain")
    got = ops.flash_attention(q, k, v, causal=True, window=window, impl="kernel")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("d", FWD_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_are_deterministic(cuda_device, d, dtype):
    """Two calls on the same inputs are bitwise equal: the decode kernel
    merges its splits in a fixed order inside the launch, whichever block
    arrives last."""
    rng = np.random.default_rng(17)
    q = _randn(rng, (4, 28, d), dtype, cuda_device)
    kc, vc = (_randn(rng, (4, 4096, 4, d), dtype, cuda_device) for _ in range(2))
    lens = torch.tensor([4096, 1, 2500, 1024], dtype=torch.int32, device=cuda_device)
    for window in (None, 1024):
        outs = [ops.decode_attention(q, kc, vc, lens, window=window, impl="kernel")
                for _ in range(2)]
        assert torch.equal(*outs)
    if d in HEAD_DIMS:          # the partials are not built at 224
        qf = q.float() * d ** -0.5
        parts = [ops.decode_attention_partials(qf, kc[:, 1024:2048], vc[:, 1024:2048],
                                               torch.clamp(lens - 1024, 0, 1024), scale=1.0,
                                               impl="kernel") for _ in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(*parts, strict=True))
    qs = _randn(rng, (1, 300, 28, d), dtype, cuda_device)
    ks, vs = (_randn(rng, (1, 300, 4, d), dtype, cuda_device) for _ in range(2))
    outs = [ops.flash_attention(qs, ks, vs, window=48, impl="kernel") for _ in range(2)]
    assert torch.equal(*outs)


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 8, 4, 48), device=cuda_device)          # head_dim 48
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2], impl="kernel")
    q = torch.zeros((1, 8, 4, 128), device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q, q, q, impl="kernel")


def test_c_entries_refuse_a_head_dim_they_are_not_built_for(cuda_device):
    """Each C entry dispatches on the head_dim with a switch whose default
    returns cudaErrorInvalidValue (1) before it launches anything, whatever
    the Python wrapper checks first; here head_dim 48."""
    buf = torch.zeros(4096, dtype=torch.float32, device=cuda_device)
    p = buf.data_ptr()
    st = torch.cuda.current_stream(cuda_device).cuda_stream
    assert fa._kernel()(p, p, p, p, None, 1, 8, 8, 4, 2, 48, 1, -1, 1.0, 1, st) == 1
    assert fa._bwd_kernel()(p, p, p, p, p, p, p, p, p, p, p, 1, 8, 8, 4, 2, 48, 1, -1, 1.0,
                            1, st) == 1
    assert da._kernel()(p, p, p, p, p, p, p, 1, 64, 4, 2, 48, -1, 1.0, 1, 1, 64, st) == 1
    assert da._partials_kernel()(p, p, p, p, p, p, p, p, p, 1, 64, 64 * 2 * 48, 4, 2, 48, -1,
                                 1.0, 1, 1, 64, st) == 1
    assert sorted(fa.HEAD_DIMS) == sorted(da.HEAD_DIMS) == FWD_HEAD_DIMS
    assert sorted(fa.BWD_HEAD_DIMS) == sorted(da.PARTIALS_HEAD_DIMS) == HEAD_DIMS


def test_decode_kernel_ignores_lengths_past_the_cache(cuda_device):
    """A length past Smax attends to the Smax keys that exist, as the plain
    version does, also where Smax is not a multiple of the 32-key tile."""
    rng = np.random.default_rng(12)
    q = _randn(rng, (3, 8, 128), torch.float32, cuda_device)
    kc, vc = (_randn(rng, (3, 100, 2, 128), torch.float32, cuda_device) for _ in range(2))
    lens = torch.tensor([100, 101, 131], dtype=torch.int32, device=cuda_device)
    want = ops.decode_attention(q, kc, vc, lens, impl="plain")
    got = ops.decode_attention(q, kc, vc, lens, impl="kernel")
    torch.cuda.synchronize()
    _close(got, want, torch.float32)


PARTIALS_CASES = [
    # (Smax, lengths of the 4 sequences, window): 4 slices of Smax / 4
    (192, [65, 10, 192, 150], None),     # qwen2-7b's step: slices full, partial (17), empty
    (4096, [4096, 1, 2500, 1024], None),
    (4096, [4096, 1, 2500, 1024], 1024),
]


def _partials_inputs(rng, smax, lengths, dtype, device, d=128):
    q = _randn(rng, (4, 28, d), torch.float32, device) * d ** -0.5
    kc, vc = (_randn(rng, (4, smax, 4, d), dtype, device) for _ in range(2))
    return q, kc, vc, torch.tensor(lengths, dtype=torch.int32, device=device)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("smax,lengths,window", PARTIALS_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_partials_kernel_matches_plain_on_views(cuda_device, d, smax, lengths, window,
                                                       dtype):
    q, kc, vc, lens = _partials_inputs(np.random.default_rng(13), smax, lengths, dtype,
                                       cuda_device, d)
    chunk = smax // 4
    parts = []
    for lo in range(0, smax, chunk):
        k_view, v_view = kc[:, lo:lo + chunk], vc[:, lo:lo + chunk]   # read in place
        assert not k_view.is_contiguous()
        eff = torch.clamp(lens - lo, 0, chunk)
        want = ops.decode_attention_partials(q, k_view, v_view, eff, scale=1.0, window=window,
                                             impl="plain")
        got = ops.decode_attention_partials(q, k_view, v_view, eff, scale=1.0, window=window,
                                            impl="kernel")
        torch.cuda.synchronize()
        for g, w in zip(got, want, strict=True):
            assert g.dtype == torch.float32 and g.shape == w.shape
            assert torch.isfinite(g).all()
            _close(g, w, dtype)
        parts.append(got)
    empty = [(r, b) for r, lo in enumerate(range(0, smax, chunk)) for b in range(4)
             if lengths[b] <= lo]
    for r, b in empty:
        assert (parts[r][1][b] == -1e30).all() and (parts[r][2][b] == 0).all()
        assert (parts[r][0][b] == 0).all()
    if window is None:      # combined, the slices give attention over the whole cache
        acc, _, denom = da.combine_partials(*(torch.stack(t) for t in zip(*parts, strict=True)))
        out = acc / torch.clamp(denom[..., None], min=1e-30)
        want = ops.decode_attention(q, kc, vc, lens, scale=1.0, impl="plain")
        _close(out.reshape(4, 28, d), want, dtype)


def test_decode_partials_kernel_rejects_what_it_does_not_take(cuda_device):
    rng = np.random.default_rng(14)
    q, kc, vc, lens = _partials_inputs(rng, 192, [65, 10, 192, 150], torch.bfloat16,
                                       cuda_device)
    with pytest.raises(ValueError, match="float32"):
        ops.decode_attention_partials(q.bfloat16(), kc, vc, lens, impl="kernel")
    with pytest.raises(ValueError, match="int32"):
        ops.decode_attention_partials(q, kc, vc, lens.long(), impl="kernel")
    wide = torch.cat([kc, kc], dim=2)[:, :, :4]         # rows 8 heads apart
    with pytest.raises(ValueError, match="rows must be contiguous"):
        ops.decode_attention_partials(q, wide, wide, lens, impl="kernel")
    with pytest.raises(ValueError, match="is torch.float32"):
        ops.decode_attention_partials(q, kc, vc.float(), lens, impl="kernel")
    with pytest.raises(ValueError, match="head_dim"):             # head_dim 48
        ops.decode_attention_partials(q[..., :48].contiguous(), kc[..., :48], vc[..., :48],
                                      lens, impl="kernel")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.decode_attention_partials(q.cpu(), kc.cpu(), vc.cpu(), lens.cpu(), impl="kernel")


SSD_SHAPES = [
    # (B, S, H): mamba2-2.7b's prompts, then one, two and sixteen chunks of 128
    (1, 3, 80),
    (1, 19, 80),
    (2, 96, 8),
    (1, 130, 8),
    (1, 2048, 8),
    # the chunk's edges: the chained state pass starts at 129
    (1, 127, 8),
    (1, 128, 8),
    (1, 129, 8),
    (2, 256, 8),
    (2, 257, 8),
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_long_chain(cuda_device, dtype):
    """32 chunks of 320 (batch, head) rows: 10240 blocks, more than the card
    holds at once, so blocks wait on the chain while others still start."""
    args, h0 = _ssd_inputs(np.random.default_rng(12), 4, 4096, 80, 1, 128, dtype, True,
                           cuda_device)
    want_y, want_h = ops.ssd_scan(*args, impl="plain", initial_state=h0)
    got_y, got_h = ops.ssd_scan(*args, impl="kernel", initial_state=h0)
    torch.cuda.synchronize()
    _close(got_y, want_y, dtype, SSD_TOL)
    _close(got_h, want_h, dtype, SSD_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_kernel_is_bitwise_repeatable(cuda_device, dtype, with_h0):
    """The chain adds the states in a fixed order, whichever block runs first."""
    args, h0 = _ssd_inputs(np.random.default_rng(13), 2, 1000, 80, 2, 128, dtype, with_h0,
                           cuda_device)
    first = ops.ssd_scan(*args, impl="kernel", initial_state=h0)
    torch.cuda.synchronize()
    again = ops.ssd_scan(*args, impl="kernel", initial_state=h0)
    torch.cuda.synchronize()
    assert all(torch.equal(a, f) for a, f in zip(again, first, strict=True))


def test_ssd_scan_kernel_leaves_its_flags_zero(cuda_device):
    """Calls in a row share the device's ticket counter and flags: each
    launch leaves them zero, so the next, of another shape, is right too."""
    from repro_torch.kernels import ssd_scan as ssd

    rng = np.random.default_rng(14)
    for b, s, h, with_h0 in ((2, 700, 16, True), (1, 300, 8, False), (3, 1100, 24, True),
                             (2, 700, 16, True)):
        args, h0 = _ssd_inputs(rng, b, s, h, 1, 64, torch.bfloat16, with_h0, cuda_device)
        got_y, got_h = ops.ssd_scan(*args, impl="kernel", initial_state=h0)
        torch.cuda.synchronize()
        assert not ssd._syncs[cuda_device.index or 0].any()
        want_y, want_h = ops.ssd_scan(*args, impl="plain", initial_state=h0)
        _close(got_y, want_y, torch.bfloat16, SSD_TOL)
        _close(got_h, want_h, torch.bfloat16, SSD_TOL)


def test_ssd_kernel_rejects_what_it_does_not_take(cuda_device):
    rng = np.random.default_rng(11)
    args, _ = _ssd_inputs(rng, 1, 8, 4, 1, 64, torch.float32, False, cuda_device, p=48)
    with pytest.raises(ValueError, match="head_dim"):
        ops.ssd_scan(*args, impl="kernel")
    args, _ = _ssd_inputs(rng, 1, 8, 4, 1, 64, torch.float32, False, cuda_device, p=32)
    with pytest.raises(ValueError, match="d_state"):       # P = 32 is built only at N = 16
        ops.ssd_scan(*args, chunk=32, impl="kernel")
    args, _ = _ssd_inputs(rng, 1, 8, 4, 1, 16, torch.float32, False, cuda_device, p=32)
    with pytest.raises(ValueError, match="chunk"):         # ... and chunk 32
        ops.ssd_scan(*args, chunk=128, impl="kernel")
    args, _ = _ssd_inputs(rng, 1, 8, 4, 1, 64, torch.float32, False, cuda_device)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(*args, chunk=64, impl="kernel")
    with pytest.raises(ValueError, match="d_state"):
        ops.ssd_scan(*_ssd_inputs(rng, 1, 8, 4, 1, 32, torch.float32, False, cuda_device)[0],
                     impl="kernel")


# The reduced Mamba2 and hybrid configs' SSM shape: P = 32, N = 16, chunk 32
REDUCED_SSD_SHAPES = [
    # (B, S, H, G): the serving CLI's prompts of 3 and 19 tokens, one chunk
    # and its edges, a ragged third chunk, and a long chain
    (1, 3, 8, 1),
    (1, 19, 8, 1),
    (1, 19, 4, 1),
    (1, 31, 4, 1),
    (1, 32, 4, 1),
    (1, 33, 4, 1),
    (2, 65, 4, 1),
    (2, 97, 8, 2),
    (4, 4096, 8, 1),
]


def _reduced_ssd(rng, b, s, h, g, dtype, with_h0, device):
    return _ssd_inputs(rng, b, s, h, g, 16, dtype, with_h0, device, p=32)


@pytest.mark.parametrize("shape", REDUCED_SSD_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_at_the_reduced_shape(cuda_device, shape, with_h0, dtype):
    """Against the plain version and against the kernel's algorithm in
    PyTorch (ssd_scan_chained_plain), bitwise from call to call, the
    device's chain flags left zero."""
    from repro_torch.kernels import ssd_scan as ssd

    b, s, h, g = shape
    args, h0 = _reduced_ssd(np.random.default_rng(18), b, s, h, g, dtype, with_h0, cuda_device)
    got_y, got_h = ops.ssd_scan(*args, chunk=32, impl="kernel", initial_state=h0)
    again = ops.ssd_scan(*args, chunk=32, impl="kernel", initial_state=h0)
    torch.cuda.synchronize()
    assert torch.equal(got_y, again[0]) and torch.equal(got_h, again[1])
    assert not ssd._syncs[cuda_device.index or 0].any()
    assert got_y.dtype == dtype and got_y.shape == args[0].shape
    assert got_h.dtype == torch.float32 and got_h.shape == (b, h, 32, 16)
    for fn in (ssd.ssd_scan_plain, ssd.ssd_scan_chained_plain):
        want_y, want_h = fn(*args, chunk=32, initial_state=h0)
        _close(got_y, want_y, dtype, SSD_TOL)
        _close(got_h, want_h, dtype, SSD_TOL)


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return [_to(v, device) for v in tree]


def test_head_padding_through_the_kernels(cuda_device):
    """3 query and 3 kv heads of head_dim 32 padded to 4 and 4: the model on
    the card (flash and decode kernels over the padded heads) against the
    same weights on the CPU (plain versions), f32, and the padded model on
    the card against the unpadded one there."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(), n_heads=3, n_kv_heads=3,
                              head_dim=32, d_model=96, dtype="float32")
    cfgp = dataclasses.replace(cfg, head_pad_multiple=4)
    params, paramsp = (M.init_params(c, torch.Generator().manual_seed(0), device="cpu")
                       for c in (cfg, cfgp))
    on_card = {"padded": (cfgp, _to(paramsp, cuda_device)),
               "unpadded": (cfg, _to(params, cuda_device))}
    prompt = torch.from_numpy(np.random.default_rng(19).integers(0, cfg.vocab_size, (2, 19)))
    feed = torch.from_numpy(np.random.default_rng(20).integers(0, cfg.vocab_size, (4, 2)))
    flash0, decode0 = fa.launches, da.launches
    logits = {}
    for name, (c, p) in {"cpu": (cfgp, paramsp), **on_card}.items():
        dev = "cpu" if name == "cpu" else cuda_device
        lg, cache = M.prefill(p, c, {"tokens": prompt.to(dev)}, max_len=32)
        out = [lg]
        for tok in feed:
            lg, cache = M.decode_step(p, c, cache, tok.to(dev))
            out.append(lg)
        logits[name] = torch.stack(out).cpu()
    assert fa.launches - flash0 == 2 * cfg.n_layers and da.launches - decode0 == 8 * cfg.n_layers
    torch.testing.assert_close(logits["padded"], logits["cpu"], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(logits["padded"], logits["unpadded"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("experts,top_k,cf", [(4, 2, 8.0), (128, 8, 1.25)])
def test_moe_block_on_the_card_matches_the_cpu(cuda_device, experts, top_k, cf):
    """The MoE block (f32) on the card against itself on the CPU: the
    reduced configs' 4 experts, top-2, no drops; 128 experts, top-8 at
    factor 1.25, qwen3-moe-30b-a3b's routing at batch 4 (capacity 1, some
    slots drop). Bitwise from call to call on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    base = get_config("qwen3-moe-30b-a3b").reduced()
    cfg = dataclasses.replace(base, d_model=256, dtype="float32", moe=dataclasses.replace(
        base.moe, n_experts=experts, top_k=top_k, capacity_factor=cf))
    params = moe.init_moe_params(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(21).normal(size=(4, 1, 256)).astype(np.float32))
    want_y, want_aux = moe.moe_forward(params, x, cfg)
    card = _to(params, cuda_device)
    got_y, got_aux = moe.moe_forward(card, x.to(cuda_device), cfg)
    again_y, again_aux = moe.moe_forward(card, x.to(cuda_device), cfg)
    torch.cuda.synchronize()
    assert torch.equal(got_y, again_y) and torch.equal(got_aux["lb_loss"], again_aux["lb_loss"])
    assert float(got_aux["drop_frac"]) == float(want_aux["drop_frac"])
    assert (float(want_aux["drop_frac"]) > 0) == (cf < 8)
    torch.testing.assert_close(got_y.cpu(), want_y, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got_aux["lb_loss"].cpu(), want_aux["lb_loss"], atol=1e-6, rtol=1e-6)


# ---- the flash-attention backward (training) ------------------------------

BWD_LENGTHS = [1, 63, 64, 65, 127, 128, 129, 200]   # on and around the 64-row tiles


def _bwd_inputs(rng, b, sq, sk, h, kv, d, dtype, device, window):
    """q, k, v, dO and the forward kernel's o and lse on them."""
    q = _randn(rng, (b, sq, h, d), dtype, device)
    k, v = (_randn(rng, (b, sk, kv, d), dtype, device) for _ in range(2))
    do = _randn(rng, (b, sq, h, d), dtype, device)
    o, lse = fa.flash_attention_kernel(q, k, v, causal=True, window=window, scale=d ** -0.5,
                                       return_lse=True)
    return q, k, v, do, o, lse


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("sq", BWD_LENGTHS)
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("grp", [1, 2, 4, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_matches_plain(cuda_device, d, sq, window, grp, dtype):
    """dQ, dK, dV of the backward kernel against flash_attention_bwd_plain on
    the same (q, k, v, o, lse, dO), at every head_dim the kernel is built
    for, lengths at the tiles' edges, GQA groups 1, 2, 4 and 7 (with grp >
    1 through the per-query-head partials and their sum), with and without
    a window; float32 at 2e-5, bfloat16 at 2e-2 (both sum in fp32 in
    another order and round the outputs once; bf16 also rounds P and dS as
    mma operands)."""
    rng = np.random.default_rng(30)
    kw = dict(causal=True, window=window, scale=d ** -0.5)
    q, k, v, do, o, lse = _bwd_inputs(rng, 2, sq, sq, 2 * grp, 2, d, dtype, cuda_device, window)
    got = fa.flash_attention_bwd_kernel(q, k, v, o, lse, do, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for g, w, ref in zip(got, want, (q, k, v), strict=True):
        assert g.dtype == dtype and g.shape == ref.shape
        _close(g, w, dtype)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("extra_keys", [1, 37, 130])
@pytest.mark.parametrize("window", [None, 1, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_right_aligned_queries(cuda_device, d, extra_keys, window, dtype):
    """Sq < Sk: queries right-aligned to the last keys, so key tiles before
    the first query's position are seen by every row (or, under a window,
    by none), and keys no query sees get zero gradient."""
    rng = np.random.default_rng(31)
    sq = 65
    kw = dict(causal=True, window=window, scale=d ** -0.5)
    q, k, v, do, o, lse = _bwd_inputs(rng, 1, sq, sq + extra_keys, 8, 2, d, dtype, cuda_device,
                                      window)
    got = fa.flash_attention_bwd_kernel(q, k, v, o, lse, do, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        _close(g, w, dtype)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 48])
def test_flash_forward_lse(cuda_device, d, dtype, window):
    """The forward with the LSE output writes o bit for bit as without it,
    and its LSE agrees with the plain version's (f32 at 2e-5; bf16 inputs
    at 2e-5 too: the LSE is fp32 on both sides, from the same inputs)."""
    rng = np.random.default_rng(32)
    q = _randn(rng, (2, 200, 8, d), dtype, cuda_device)
    k, v = (_randn(rng, (2, 200, 2, d), dtype, cuda_device) for _ in range(2))
    kw = dict(causal=True, window=window, scale=d ** -0.5)
    o, lse = fa.flash_attention_kernel(q, k, v, return_lse=True, **kw)
    o_plain_entry = fa.flash_attention_kernel(q, k, v, **kw)
    _, lse_plain = fa.flash_attention_fwd_lse_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o_plain_entry)
    assert lse.shape == (2, 8, 200) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, lse_plain, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv", [(28, 4), (8, 8)])
def test_flash_bwd_kernel_is_bitwise_repeatable(cuda_device, d, dtype, h, kv):
    """No atomics: every output element is summed in one fixed order (the
    GQA sum over a kv head's query heads in the order g = 0 .. grp - 1), so
    two calls are bitwise equal, with grp 7 and grp 1."""
    rng = np.random.default_rng(33)
    kw = dict(causal=True, window=100, scale=d ** -0.5)
    q, k, v, do, o, lse = _bwd_inputs(rng, 2, 300, 300, h, kv, d, dtype, cuda_device, 100)
    first = fa.flash_attention_bwd_kernel(q, k, v, o, lse, do, **kw)
    second = fa.flash_attention_bwd_kernel(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second, strict=True))


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_fn_grads_match_autograd_over_the_oracle(cuda_device, d, dtype):
    """ops.flash_attention under autograd on the card runs FlashAttentionFn
    (one forward launch, and one backward call of four launches at grp 4); its
    gradients agree with autograd over impl='ref' (f32 at 1e-4: the oracle
    materializes S and sums in another order; bf16 at 2e-2 against the
    oracle in f32 on the same bf16 inputs, rounded once)."""
    rng = np.random.default_rng(34)
    b, s, h, kv = 2, 130, 8, 2
    leaves = [_randn(rng, shape, dtype, cuda_device).requires_grad_()
              for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]
    do = _randn(rng, (b, s, h, d), dtype, cuda_device)
    fwd0, bwd0 = fa.launches, fa.bwd_launches
    out = ops.flash_attention(*leaves, window=64)
    got = torch.autograd.grad(out, leaves, do)
    assert (fa.launches - fwd0, fa.bwd_launches - bwd0) == (1, fa.bwd_kernels(h, kv))
    ref_leaves = [t.detach().float().requires_grad_() for t in leaves]
    ref_out = ops.flash_attention(*ref_leaves, window=64, impl="ref")
    want = torch.autograd.grad(ref_out, ref_leaves, do.float())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want, strict=True):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w, atol=tol, rtol=tol)
    with torch.no_grad():
        ops.flash_attention(*leaves, window=64)
    assert fa.bwd_launches - bwd0 == fa.bwd_kernels(h, kv)


def test_flash_bwd_kernel_spills_nothing(cuda_device):
    """nvcc's -Xptxas -v report on csrc/flash_attention_bwd.cu: every kernel
    instantiation (both dtypes, every head_dim) spills no bytes."""
    report = _build.ptxas_report(_build.build(("flash_attention_bwd",))["flash_attention_bwd"])
    names = [r["fn"] for r in report]
    for kind in ("dkdv_bf16", "dq_bf16", "dkdv_f32", "dq_f32"):
        assert sum(kind in n for n in names) == len(HEAD_DIMS), names
    assert all(r.get("spill_bytes", 0) == 0 for r in report), report


def test_flash_bwd_bf16_kernels_run_on_the_tensor_cores(cuda_device):
    """cuobjdump -sass of the built library: the bf16 dK/dV and dQ kernels
    at every head_dim hold HMMA instructions."""
    _build.build(("flash_attention_bwd",))
    hmma = _build.sass_hmma(_build.library_path("flash_attention_bwd"))
    assert hmma is not None, "the toolkit has no cuobjdump"
    bf16 = {fn: n for fn, n in hmma.items() if "dkdv_bf16" in fn or "dq_bf16" in fn}
    assert len(bf16) == 2 * len(HEAD_DIMS) and all(n > 0 for n in bf16.values()), hmma


# The SSD backward (training): the three built (P, N, chunk), ragged last
# chunks, two groups, an initial state and a cotangent of the final state
SSD_BWD_CASES = [
    # (B, S, H, P, G, N, chunk, with_h0, with_dfinal)
    (2, 256, 8, 64, 1, 128, 128, False, False),
    (2, 300, 8, 64, 2, 128, 128, True, True),
    (1, 129, 8, 64, 1, 64, 128, True, False),
    (2, 300, 8, 64, 2, 64, 128, False, True),
    (1, 19, 8, 32, 1, 16, 32, False, False),
    (2, 97, 8, 32, 2, 16, 32, True, True),
    (4, 4096, 8, 32, 1, 16, 32, False, True),  # 128 chunks of 32 rows
]


def _ssd_bwd_inputs(rng, b, s, h, p, g, n, chunk, dtype, with_h0, with_dfinal, device):
    args, h0 = _ssd_inputs(rng, b, s, h, g, n, dtype, with_h0, device, p=p)
    dy = _randn(rng, (b, s, h, p), dtype, device)
    dfinal = _randn(rng, (b, h, p, n), torch.float32, device) if with_dfinal else None
    return args, h0, dy, dfinal


def _close_grads(got, want, dtype):
    """Each gradient within SSD_TOL (rtol) and SSD_TOL times its largest
    reference magnitude (atol): ddt and dA sum terms of hundreds that cancel."""
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        scale = w.float().abs().max().item()
        torch.testing.assert_close(g.float(), w.float(), atol=SSD_TOL[dtype] * scale,
                                   rtol=SSD_TOL[dtype])


@pytest.mark.parametrize("case", SSD_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_kernel_matches_plain(cuda_device, case, dtype):
    """dx, ddt, dA, dB, dC, dD and dh0 of the backward kernel against
    ssd_scan_bwd_plain on the same inputs and the forward kernel's chunk
    states, which agree with the plain forward's; float32 at 3e-4, bfloat16
    at 2e-2 (the kernel sums in f32 in another order and rounds dx, dB and
    dC to bf16 once); the device's chain flags left zero."""
    from repro_torch.kernels import ssd_scan as ssd

    b, s, h, p, g, n, chunk, with_h0, with_df = case
    args, h0, dy, df = _ssd_bwd_inputs(np.random.default_rng(40), b, s, h, p, g, n, chunk, dtype,
                                       with_h0, with_df, cuda_device)
    _, _, h_in = ssd.ssd_scan_kernel(*args, chunk=chunk, initial_state=h0,
                                     return_chunk_states=True)
    _, _, h_in_plain = ssd.ssd_scan_plain(*args, chunk=chunk, initial_state=h0,
                                          return_chunk_states=True)
    got = ssd.ssd_scan_bwd_kernel(*args, h_in, dy, df, chunk=chunk)
    torch.cuda.synchronize()
    assert not ssd._syncs[cuda_device.index or 0].any()
    _close(h_in, h_in_plain, dtype, SSD_TOL)
    _close_grads(got, ssd.ssd_scan_bwd_plain(*args, h_in, dy, df, chunk=chunk), dtype)


@pytest.mark.parametrize("case", [SSD_BWD_CASES[1], SSD_BWD_CASES[3], SSD_BWD_CASES[5]])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads_per_block", [1, 2, 4])
def test_ssd_bwd_kernel_heads_per_block(cuda_device, case, dtype, heads_per_block):
    """A block takes 1, 2 or all 4 heads of a group in turn (dB and dC summed
    over its heads in order, then over the group's head blocks): each
    against ssd_scan_bwd_plain, at two groups of the three built shapes,
    with an initial state or a cotangent of the final state; the flags left
    zero."""
    from repro_torch.kernels import ssd_scan as ssd

    b, s, h, p, g, n, chunk, with_h0, with_df = case
    args, h0, dy, df = _ssd_bwd_inputs(np.random.default_rng(44), b, s, h, p, g, n, chunk, dtype,
                                       with_h0, with_df, cuda_device)
    _, _, h_in = ssd.ssd_scan_kernel(*args, chunk=chunk, initial_state=h0,
                                     return_chunk_states=True)
    got = ssd.ssd_scan_bwd_kernel(*args, h_in, dy, df, chunk=chunk,
                                  heads_per_block=heads_per_block)
    torch.cuda.synchronize()
    assert not ssd._syncs[cuda_device.index or 0].any()
    _close_grads(got, ssd.ssd_scan_bwd_plain(*args, h_in, dy, df, chunk=chunk), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("heads_per_block", [None, 4])
def test_ssd_bwd_kernel_is_bitwise_repeatable(cuda_device, dtype, g, heads_per_block):
    """The reverse chain adds the cotangents in chunk order, each block sums
    its heads in head order, and dB, dC, dA and dD are summed from partials
    in index order: two calls are equal bit for bit, at 80 heads over one
    group and over two, with the card's plan of heads a block and with 4."""
    from repro_torch.kernels import ssd_scan as ssd

    args, h0, dy, df = _ssd_bwd_inputs(np.random.default_rng(41), 2, 1000, 80, 64, g, 128, 128,
                                       dtype, True, True, cuda_device)
    _, _, h_in = ssd.ssd_scan_kernel(*args, chunk=128, initial_state=h0,
                                     return_chunk_states=True)
    first = ssd.ssd_scan_bwd_kernel(*args, h_in, dy, df, chunk=128,
                                    heads_per_block=heads_per_block)
    torch.cuda.synchronize()
    again = ssd.ssd_scan_bwd_kernel(*args, h_in, dy, df, chunk=128,
                                    heads_per_block=heads_per_block)
    assert all(torch.equal(a, f) for a, f in zip(again, first, strict=True))


def test_ssd_bwd_plan_at_phase_t_shapes(cuda_device):
    """One backward block an SM at chunk 128, and the plan of heads a block
    at the training steps' shapes: a divisor of the group's heads, whose
    blocks fill whole waves of the card's SMs."""
    from repro_torch.kernels import ssd_scan as ssd

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for p, n, h in ((64, 128, 80), (64, 64, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            slots = ssd.bwd_slots(cuda_device.index or 0, p, n, 128, dtype)
            assert slots == sms, (p, n, dtype, slots, sms)
        r = ssd.bwd_heads_per_block(h, 1, 4 * 4, sms)
        assert h % r == 0 and 4 * 4 * h // r <= sms, (h, r, sms)


@pytest.mark.parametrize("shape", [(1, 19, 80, 64, 1, 128, 128), (2, 300, 8, 64, 2, 64, 128),
                                   (2, 97, 8, 32, 1, 16, 32)])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_forward_with_chunk_states_is_bit_identical(cuda_device, shape, with_h0, dtype):
    """Writing the chunk states for training leaves serving's y and final
    state the same bit for bit; chunk 0's state is h0, or zero."""
    from repro_torch.kernels import ssd_scan as ssd

    b, s, h, p, g, n, chunk = shape
    args, h0 = _ssd_inputs(np.random.default_rng(42), b, s, h, g, n, dtype, with_h0,
                           cuda_device, p=p)
    y, final = ssd.ssd_scan_kernel(*args, chunk=chunk, initial_state=h0)
    y_t, final_t, h_in = ssd.ssd_scan_kernel(*args, chunk=chunk, initial_state=h0,
                                             return_chunk_states=True)
    torch.cuda.synchronize()
    assert torch.equal(y, y_t) and torch.equal(final, final_t)
    assert h_in.shape == (b, -(-s // chunk), h, p, n) and h_in.dtype == torch.float32
    assert torch.equal(h_in[:, 0], h0 if with_h0 else torch.zeros_like(h_in[:, 0]))


def test_ssd_bwd_kernel_spills_nothing(cuda_device):
    """nvcc's -Xptxas -v report on csrc/ssd_scan_bwd.cu: every instantiation
    (both dtypes, every built shape, and the sums) spills no bytes."""
    from repro_torch.kernels import ssd_scan as ssd

    report = _build.ptxas_report(_build.build(("ssd_scan_bwd",))["ssd_scan_bwd"])
    names = [r["fn"] for r in report]
    for kind in ("ssd_bwd_kernel<__nv_bfloat16", "ssd_bwd_kernel<float"):
        assert sum(kind in n for n in names) == len(ssd.SHAPES), names
    assert all(r.get("spill_bytes", 0) == 0 for r in report), report


# HMMA instructions in the bf16 backward of the simple kernel (C B^T and dy
# x^T alone on the tensor cores), per (Q, P, N) in the kernel's template
# order; every product of the redesigned kernel runs there
SIMPLE_KERNEL_HMMA = {"32, 32, 16": 3, "128, 64, 64": 8, "128, 64, 128": 12}


def test_ssd_bwd_bf16_kernels_run_on_the_tensor_cores(cuda_device):
    """cuobjdump -sass of the built library: every product of the bf16
    backward kernel (C B^T, dy x^T, M^T dy, dG^T C, dG B, the chain term and
    the state terms) puts HMMA instructions in it at every built shape,
    more than the simple kernel had."""
    from repro_torch.kernels import ssd_scan as ssd

    _build.build(("ssd_scan_bwd",))
    hmma = _build.sass_hmma(_build.library_path("ssd_scan_bwd"))
    assert hmma is not None, "the toolkit has no cuobjdump"
    bf16 = {fn: k for fn, k in hmma.items() if "ssd_bwd_kernel<__nv_bfloat16" in fn}
    assert len(bf16) == len(ssd.SHAPES), hmma
    for shape, simple in SIMPLE_KERNEL_HMMA.items():
        got = [k for fn, k in bf16.items() if shape in fn]
        assert len(got) == 1 and got[0] > simple, (shape, hmma)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 300, 8, 64, 2, 128, 128), (2, 97, 8, 32, 1, 16, 32)])
def test_ssd_scan_under_grad_on_the_card_matches_the_plain_backward(cuda_device, dtype, shape):
    """ops.ssd_scan under autograd on the card runs SsdScanFn: one forward
    launch and one backward call of BWD_KERNELS launches; its gradients,
    the initial state's too, are ssd_scan_bwd_plain's on the chunk states
    of the forward (None as the final state's cotangent is zero); with no
    grad the forward kernel runs alone, as in serving."""
    from repro_torch.kernels import ssd_scan as ssd

    b, s, h, p, g, n, chunk = shape
    args, h0, dy, _ = _ssd_bwd_inputs(np.random.default_rng(43), b, s, h, p, g, n, chunk, dtype,
                                      True, False, cuda_device)
    leaves = [t.detach().requires_grad_() for t in (*args, h0)]
    fwd0, bwd0 = ssd.launches, ssd.bwd_launches
    y, _ = ops.ssd_scan(*leaves[:6], chunk=chunk, initial_state=leaves[6])
    got = torch.autograd.grad(y, leaves, dy)
    assert (ssd.launches - fwd0, ssd.bwd_launches - bwd0) == (1, ssd.BWD_KERNELS)
    assert [t.dtype for t in got] == [t.dtype for t in leaves]
    _, _, h_in = ssd.ssd_scan_plain(*args, chunk=chunk, initial_state=h0,
                                    return_chunk_states=True)
    _close_grads(got, ssd.ssd_scan_bwd_plain(*args, h_in, dy, None, chunk=chunk), dtype)
    with torch.no_grad():
        y_ng, _ = ops.ssd_scan(*leaves[:6], chunk=chunk, initial_state=leaves[6])
    assert torch.equal(y_ng, y) and ssd.bwd_launches - bwd0 == ssd.BWD_KERNELS


def test_decode_under_grad_raises_on_the_card(cuda_device):
    """The decode kernels are serving-only: under autograd on a CUDA tensor
    decode_attention and decode_attention_partials raise for 'auto' and
    'kernel' instead of returning an output with no history; 'plain' and
    'ref' stay differentiable, and with no grad the kernels run."""
    rng = np.random.default_rng(44)
    q = _randn(rng, (2, 8, 64), torch.float32, cuda_device).requires_grad_()
    kc, vc = (_randn(rng, (2, 96, 2, 64), torch.float32, cuda_device) for _ in range(2))
    lens = torch.tensor([40, 96], dtype=torch.int32, device=cuda_device)
    for fn in (ops.decode_attention, ops.decode_attention_partials):
        for impl in ("auto", "kernel"):
            with pytest.raises(NotImplementedError, match="serving-only"):
                fn(q, kc, vc, lens, impl=impl)
        for impl in ("plain", "ref"):
            out = fn(q, kc, vc, lens, impl=impl)
            out = out[0] if isinstance(out, tuple) else out
            (dq,) = torch.autograd.grad(out.sum(), [q])
            assert torch.isfinite(dq).all() and dq.abs().sum() > 0
        with torch.no_grad():
            fn(q, kc, vc, lens, impl="kernel")


# ---- ranks sharing the card (launch.dist over gloo) -------------------------

def _dist_inputs():
    import torch_dist_bodies as bodies
    rng = np.random.default_rng(45)
    cfg = bodies.config("qwen2-7b")
    prompt = rng.integers(0, cfg.vocab_size, size=(2, 11)).astype(np.int64)
    feed = rng.integers(0, cfg.vocab_size, size=(3, 2)).astype(np.int64)
    return bodies.numpy_params("qwen2-7b", seed=3), prompt, feed


@pytest.mark.parametrize("kv", [{}, {"kv_cache_dtype": "int8"}])
def test_dist_decode_on_the_card_matches_the_cpu(cuda_device, kv):
    """Reduced qwen2-7b (f32), sequence-sharded over 2 gloo ranks that share
    the card: each rank launches the partials kernel once a layer a step
    (4 layers, 3 steps), and its logits equal 2 ranks' on the CPU (the
    plain partials) at 1e-4; with the int8 cache on log-softmax at 2e-2
    (tests/test_perf_features.py's bound: the card's and the CPU's f32
    products round K and V differently, which can move a value across an
    int8 step)."""
    import torch_dist_bodies as bodies
    from repro_torch.launch.dist import spawn
    np_params, prompt, feed = _dist_inputs()
    args = (np_params, kv, prompt, feed, 32)
    card = spawn(bodies.decode, 2, device="cuda:0", model_parallel=2, args=args)
    cpu = spawn(bodies.decode, 2, device="cpu", model_parallel=2, args=args)
    for got, want in zip(card, cpu, strict=True):
        assert got["partials_launches"] == 4 * 3 and want["partials_launches"] == 0
        if kv:
            lsm = [torch.log_softmax(torch.from_numpy(r["logits"]), -1).numpy()
                   for r in (got, want)]
            np.testing.assert_allclose(*lsm, atol=2e-2, rtol=0)
        else:
            np.testing.assert_allclose(got["logits"], want["logits"], atol=1e-4, rtol=1e-4)
        assert got["counts"] == want["counts"] == {"collectives": 3 * 4 * 3, "staged_copies": 0}


def test_dist_moe_on_the_card_matches_the_cpu(cuda_device):
    """Reduced mixtral-8x7b's MoE block (f32, E = 4, capacity 1: slots
    drop) expert-parallel over 2 gloo ranks sharing the card, with the
    gradients of sum(y * r): equal to 2 ranks' on the CPU at 1e-4."""
    import torch_dist_bodies as bodies
    from repro_torch.launch.dist import spawn
    rng = np.random.default_rng(46)
    e, d, f = 4, 128, 64
    blk = {"router": 0.3 * rng.normal(size=(d, e)).astype(np.float32),
           "w_gate": 0.1 * rng.normal(size=(e, d, f)).astype(np.float32),
           "w_up": 0.1 * rng.normal(size=(e, d, f)).astype(np.float32),
           "w_down": 0.1 * rng.normal(size=(e, f, d)).astype(np.float32)}
    x = rng.normal(size=(2, 7, d)).astype(np.float32)
    args = (blk, x, {"moe": {"capacity_factor": 1.0}}, 5)
    card = spawn(bodies.moe, 2, device="cuda:0", model_parallel=2, args=args)
    cpu = spawn(bodies.moe, 2, device="cpu", model_parallel=2, args=args)
    for got, want in zip(card, cpu, strict=True):
        assert got["drop_frac"] == pytest.approx(want["drop_frac"], rel=1e-6)
        assert want["drop_frac"] > 0
        assert got["lb_loss"] == pytest.approx(want["lb_loss"], rel=1e-5)
        for key in ("y", "dx"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=1e-4)
        for key in want["dp"]:
            np.testing.assert_allclose(got["dp"][key], want["dp"][key], atol=1e-4, rtol=1e-4)


def test_gloo_takes_cuda_tensors_where_the_mesh_does_not_stage(cuda_device):
    """launch.mesh.HOST_STAGED lists the (backend, op) pairs whose CUDA
    tensors the mesh copies through the host itself; every op the port runs
    and the list leaves out must take CUDA tensors of each dtype the port
    reduces on gloo, give the right values and leave them on the card."""
    import torch_dist_bodies as bodies
    from repro_torch.launch.dist import spawn
    from repro_torch.launch.mesh import HOST_STAGED
    for res in spawn(bodies.staging, 2, device="cuda:0", model_parallel=2):
        assert res["backend"] == "gloo"
        for dtype, checks in ((k, v) for k, v in res.items() if k.startswith("torch.")):
            for op in ("psum", "pmax", "all_gather"):
                assert checks[op], (dtype, op)
            assert checks["devices"] == ["cuda:0"], dtype
        # per dtype: psum and pmax (all_reduce), all_gather; two copies a staged one
        staged = (2 * (("gloo", "all_reduce") in HOST_STAGED)
                  + (("gloo", "all_gather") in HOST_STAGED))
        assert res["counts"] == {"collectives": 3 * 4, "staged_copies": 2 * 4 * staged}

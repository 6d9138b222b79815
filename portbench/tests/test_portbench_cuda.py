"""On the card: the profiler names the port's kernels as the benchmark
reads them, and each roofline share stays under 100% at a cell's shapes.
Each test decides inside itself whether a card is there."""
from __future__ import annotations

import pytest
import torch

from portbench import roofline as rl
from portbench.tracing import Tracer, summarize


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's hand-written kernels)")


@pytest.mark.cuda
def test_profiled_kernels_and_their_rooflines():
    _card()
    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*s):
        return torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)

    s, b, smax = 4096, 8, 8192
    q, k, v = rn(1, s, 28, 128), rn(1, s, 4, 128), rn(1, s, 4, 128)
    kc, vc, qd = rn(b, smax, 4, 128), rn(b, smax, 4, 128), rn(b, 28, 128)
    lens = torch.full((b,), 6000, dtype=torch.int32, device="cuda")
    x, Bm, Cm = rn(1, s, 80, 64), rn(1, s, 1, 128), rn(1, s, 1, 128)
    dt = torch.rand((1, s, 80), generator=g, device="cuda") * 0.1
    A, D = -torch.rand((80,), generator=g, device="cuda") - 1, torch.ones(80, device="cuda")

    def work():
        ops.flash_attention(q, k, v, impl="kernel")
        ops.decode_attention(qd, kc, vc, lens, impl="kernel")
        ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=128, impl="kernel")

    work()
    tr = Tracer(True)
    tr.start()
    with tr.span("engine.step"):
        work()
        torch.cuda.synchronize()
    tr.stop()
    s_ = summarize(*tr.raw_events(), rl.kernel_of)
    assert s_.kernels_by_kernel == {"flash_attention": 1, "decode_attention": 1, "ssd_scan": 1}
    least = {"flash_attention": rl.least_seconds(*rl.flash_counts(s, 28, 4, 128)),
             "decode_attention": rl.least_seconds(*rl.decode_counts([6000] * b, 28, 4, 128)),
             "ssd_scan": rl.least_seconds(*rl.ssd_counts(s, 80, 64, 1, 128))}
    for k_, t in least.items():
        share = t / s_.device_s_by_kernel[k_]
        assert 0 < share <= 1.05, (k_, share)
    assert 0 < s_.busy_s <= s_.window_s

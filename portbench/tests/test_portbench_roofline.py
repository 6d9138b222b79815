"""The counts behind the rooflines and the MFU against hand-worked values,
and the reduction of a trace on made-up events."""
from __future__ import annotations

import pytest

from portbench import roofline as rl
from portbench.bench import find_cell, model_config
from portbench.tracing import summarize


def test_flash_counts_by_hand():
    # S = 4: 10 visible pairs; per head QK^T and PV, 2 * 2 * 10 * hd
    f, b = rl.flash_counts(4, h=2, kv=1, hd=8)
    assert f == 4 * 10 * 2 * 8
    assert b == 2 * (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8)     # q and out; k and v


def test_decode_counts_by_hand():
    f, b = rl.decode_counts([3, 5], h=4, kv=2, hd=16)
    assert f == 4 * 8 * 4 * 16
    assert b == 2 * (2 * 8 * 2 * 16 + 2 * 2 * 4 * 16) + 4 * 2


def test_effective_lengths_clamp_at_smax():
    assert rl.effective_lengths([0, 7, 15, 16, 40], 16) == [1, 8, 16, 16, 16]


def test_ssd_counts_by_hand():
    f, b = rl.ssd_counts(10, h=2, p=4, g=1, n=8)
    assert f == 10 * 2 * (5 * 4 * 8 + 2 * 4)
    assert b == 2 * 10 * 2 * 4 * 2 + 4 * 10 * 2 + 2 * 2 * 10 * 1 * 8 + 4 * 2 * 2 + 4 * 2 * 4 * 8


def test_least_time_takes_the_larger_bound():
    assert rl.least_seconds(989e12, 0.0) == pytest.approx(1.0)
    assert rl.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert rl.least_seconds(989e9, 3.35e12) == pytest.approx(1.0)


def test_matmul_params_of_the_configurations():
    q = model_config(find_cell("qwen2-7b.agent-spec").config)
    # 28 x (3584 x (28 + 8) x 128 + 3584 x 3584 + 3 x 3584 x 18944)
    assert rl.matmul_params(q) == 28 * (3584 * 36 * 128 + 3584 * 3584 + 3 * 3584 * 18944)
    m = model_config(find_cell("mamba2-2.7b.agent-spec").config)
    # 64 x (2560 x (2 x 5120 + 2 x 128 + 80) + 5120 x 2560)
    assert rl.matmul_params(m) == 64 * (2560 * (10240 + 256 + 80) + 5120 * 2560)
    assert rl.attention_layers(q) == 28 and rl.ssd_layers(q) == 0
    assert rl.attention_layers(m) == 0 and rl.ssd_layers(m) == 64


def test_model_flops_leave_speculative_work_out():
    q = model_config(find_cell("qwen2-7b.agent-spec").config)
    shapes = {"prefill": [(100, False), (100, True)],
              "step": [([10, 20, 0], [True, False, False])]}
    want = rl.prefill_flops(q, 100) + rl.decode_flops(q, [11])
    assert rl.model_flops(q, shapes, 16384) == pytest.approx(want)
    # a prefill: 2 per weight and token, the LM head at its last position, causal attention
    assert rl.prefill_flops(q, 100) == pytest.approx(
        2 * rl.matmul_params(q) * 100 + 2 * 3584 * 152064 + 28 * 4 * 5050 * 28 * 128)


def test_kernel_least_seconds_sum_their_calls():
    q = model_config(find_cell("qwen2-7b.agent-spec").config)
    shapes = {"prefill": [(1000, False), (2000, True)], "step": [([5, 9], [True, True])]}
    out = rl.kernel_least_seconds(q, shapes, 16384)
    want = 28 * (rl.least_seconds(*rl.flash_counts(1000, 28, 4, 128))
                 + rl.least_seconds(*rl.flash_counts(2000, 28, 4, 128)))
    assert out["flash_attention"] == pytest.approx(want)
    assert out["decode_attention"] == pytest.approx(
        28 * rl.least_seconds(*rl.decode_counts([6, 10], 28, 4, 128)))
    assert out["ssd_scan"] == 0.0


@pytest.mark.parametrize("name,kernel", [
    ("void (anonymous namespace)::flash_attention_bf16_kernel<128>(__nv_bfloat16 const*)",
     "flash_attention"),
    ("_ZN12_GLOBAL__N_123decode_attention_kernelILi128EEEvPK13__nv_bfloat16", "decode_attention"),
    ("void (anonymous namespace)::ssd_scan_kernel<64, 128, 128>(Args)", "ssd_scan"),
    ("void (anonymous namespace)::flash_bwd_dq_bf16_kernel<128>()", None),
    ("nvjet_tst_192x208_64x4_1x2_h_bz_coopB_NNT", None),
])
def test_kernel_names(name, kernel):
    assert rl.kernel_of(name) == kernel


def test_summarize_made_up_trace():
    ms = 1_000_000
    spans = [("engine.add_request", 0, 10 * ms), ("engine.step", 12 * ms, 20 * ms),
             ("loop.tool_wait", 20 * ms, 30 * ms)]
    dev = [("flash_attention_bf16_kernel<128>", 1 * ms, 4 * ms), ("gemm", 3 * ms, 6 * ms),
           ("decode_attention_kernel<128>", 13 * ms, 15 * ms), ("gemm", 16 * ms, 18 * ms)]
    s = summarize(dev, spans, (0, 30 * ms), rl.kernel_of)
    assert s.window_s == pytest.approx(0.030)
    assert s.busy_s == pytest.approx(0.005 + 0.004)        # [1, 6] and [13, 15] + [16, 18]
    assert s.device_s_by_span["engine.add_request"] == pytest.approx(0.006)
    assert s.device_s_by_span["engine.step"] == pytest.approx(0.004)
    assert s.device_s_by_kernel == pytest.approx({"flash_attention": 0.003,
                                                  "decode_attention": 0.002})
    assert s.spans == {"engine.add_request": 1, "engine.step": 1, "loop.tool_wait": 1}
    # idle: [0, 1] and [6, 10] in add_request, [10, 12] outside every span, [12, 13],
    # [15, 16] and [18, 20] in step, [20, 30] waiting on tools
    assert s.idle_s_by_span["engine.add_request"] == pytest.approx(0.005)
    assert s.idle_s_by_span["loop.other"] == pytest.approx(0.002)
    assert s.idle_s_by_span["engine.step"] == pytest.approx(0.004)
    assert s.idle_s_by_span["loop.tool_wait"] == pytest.approx(0.010)
    assert sum(s.idle_s_by_span.values()) + s.busy_s == pytest.approx(s.window_s)
    assert s.top_ops[0] == ("gemm", pytest.approx(0.005))

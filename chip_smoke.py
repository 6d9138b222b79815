#!/usr/bin/env python3
"""Smoke test of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, one line of output each (or more), and after each phase a line
``clock <phase>: <s> s since the run began`` (the wall clock since the
script started), so that a reader sees which phase grew:
  1. the card's name and power limit (nvidia-smi), then the build of the
     hand-written CUDA kernels from src/repro_torch/kernels/csrc, with
     ptxas's registers, spills and shared memory per kernel instantiation
     and, where the toolkit has cuobjdump, the tensor-core (HMMA)
     instructions in each kernel's SASS (the SSD scan, the flash backward
     and the SSD backward must spill nothing, and the SSD scan's bf16
     instantiations, the flash backward's bf16 dK/dV and dQ kernels and
     the SSD backward's bf16 kernels must have HMMA; one line for each
     backward gives its instantiations' registers, spills and HMMA count,
     and one the SSD backward's blocks an SM and heads a block at phase T's
     steps);
  2. each kernel against its plain PyTorch version (attention: bf16 at
     2e-2, f32 at 2e-5; the SSD scan: bf16 at 2e-2, f32 at 3e-4) at the
     serving paths' shapes and at long shapes (for the SSD scan also a chain
     of 32 chunks over 4 sequences, zamba2-1.2b's prompts at 64 heads
     and N = 64, and the reduced configs' shape, P = 32, N = 16, chunk 32;
     for attention also zamba2-1.2b's shared block, 32 heads of head_dim
     64, the reduced configs' head_dim 32, qwen3-moe-30b-a3b's 32 heads over
     4 and musicgen-medium's 24 over 24 of head_dim 64; zamba2-7b's cell
     at head_dim 224: flash at S = 2048 and 4096 over 32 heads of 32,
     decode at 34 rows to Smax 4096, and the SSD scan at 112 heads over 2
     groups, N = 64, at S = 2048 and 4096), every kernel also against a second
     call of itself (bitwise), with its time, the plain
     version's time, the time of one library call computing the same
     function (scaled_dot_product_attention for attention, a yardstick the
     port never calls; no single PyTorch call computes the SSD scan or
     unnormalized decode partials) and the least time the card could take
     (bound); and the flash-attention backward kernel (training), with the
     forward's log-sum-exp, against their plain versions (bf16 2e-2, f32
     2e-5; the LSE 2e-5) at musicgen-medium's training step (4, 128, 24
     heads over 24 of 64), qwen2-7b at S = 2048 causal and under a window of
     1024, zamba2-1.2b's shared attention at S = 2048 and reduced
     granite-8b's training step (head_dim 32), timed beside SDPA's forward +
     backward through autograd; and the SSD backward kernel (training)
     against ssd_scan_bwd_plain on the forward kernel's chunk states (every
     gradient, bf16 2e-2, f32 3e-4, each also times the gradient's largest
     magnitude as atol), bitwise from call to call, with the forward's y and
     final state unchanged bit for bit by writing those states, at the three
     built (P, N, chunk) with ragged chunks, two groups, h0 and d(final),
     mamba2-2.7b at S = 2048, phase T's steps (4 x 512 tokens at 80 heads,
     N = 128, and 64 heads, N = 64) and the reduced run's (8 x 64), timed
     beside its bound, the plain backward and, for reference only, autograd
     over ssd_scan_plain;
  3. each serving path at full width (bf16, random weights from a seed)
     through the speculative agent loop (1 episode; 3 until phase D came
     and 2 until the int8 hybrid came, the cuts that keep the whole run
     inside its time), speculation off then on, every decode step replayed
     as the engine's CUDA graph, with the kernels' launch counts over that
     run (the prefills'; the wrappers never see a replay's launches) and
     the profiles of 3 served decode steps, every slot decoding, whose
     trace must list each decode kernel's launches a step, and of a
     19-token prefill: qwen2-7b (28 layers; flash and
     decode attention); qwen2-7b sequence-sharded over a local mesh of 4
     shards on the card, with the same weights, with a bf16 and then an
     int8 KV cache (the split-KV partials kernel in every layer of every
     step, 4 launches each); then mamba2-2.7b (64 layers; the SSD scan in
     every prefill); then zamba2-1.2b (38 Mamba2 layers and 6 applications
     of one shared attention block of head_dim 64: the SSD scan in every
     layer of a prefill, flash and decode attention in every application);
     the same zamba2-1.2b weights with an int8 KV cache (the same launches;
     the cache's values int8), with the int8-vs-bf16 log-softmax gap of a
     teacher-forced decode and both caches' bytes printed; then
     qwen3-moe-30b-a3b (48 layers, 128 experts top-8, 61 GB: the MoE
     path; with the peak device memory and the share of routed slots that
     drop per decode step, over 16 replayed steps of a fresh engine); then
     musicgen-medium (48 layers, head_dim
     64);
  4. after each model's run, a batched engine slot against a standalone
     prefill + decode at full width, teacher-forced, and the kernel path
     against the oracle path; for the sharded runs, the sharded engine's
     slot against the unsharded standalone decode, and sharded engines
     against unsharded ones, int8 and bf16 caches, on log-softmax (bound:
     the unsharded kernel path against the oracle path); with the qwen2-7b
     weights, the same check under a sliding window of 64 (a rolling buffer
     of 64 rows) with a 100-token prompt, then that rolling decode against
     the full forward under the window mask on log-softmax (bound: 1.5
     times a full cache's decode against its own forward; the rows laid out
     unrotated, as the JAX package's prefill leaves them, must exceed it);
     with the zamba2-1.2b weights, the int8 engine's check, then sharded
     engines against unsharded ones as for qwen2-7b (the partials kernel 6
     x 4 launches a step of each sharded engine);
     qwen3-moe-30b-a3b's check runs at capacity factor E / k, where no slot
     drops (the batched step routes 4 tokens, the standalone decode 1);
     after musicgen-medium, a prefill from frontend embeddings against the
     oracle path; then the serving CLI (``launch/serve.py``'s ``main``) on
     every arch, reduced (the SSD scan must launch for mamba2-2.7b and
     zamba2-1.2b);
  T. training (``launch/train.py``): full-width musicgen-medium (48 layers,
     remat, bf16, random weights from seed 0) for 5 steps of 4 x 128 tokens,
     each step's loss, grad norm and wall time, the peak device memory and
     the kernels' launches (flash forward 96 a step, backward 48 calls of 3
     launches); a run stopped after step 2 (its async checkpoint) and one
     resumed from it, whose losses of steps 3 to 5 (the last two after
     updates from the restored optimizer state) must equal the
     uninterrupted run's bit for bit; one more step timed on the host's
     clock and the next under torch.profiler (device time, kernels, busy
     share, the flash kernels' shares, the forward and backward alone);
     that step's gradients through the kernels against those through the
     oracle attention (``TRAIN_BOUND``), and a control, the backward kernel
     fed a zero o (so delta = rowsum(dO o) = 0), which must fall outside
     that bound; then full-width mamba2-2.7b (64 layers, 2.83 B params) and
     zamba2-1.2b (38 Mamba2 layers and 6 applications of a shared attention
     block) for 3 steps of 4 x 512 tokens each through SsdScanFn (the SSD
     forward 2 launches a layer, remat; the backward BWD_KERNELS a layer;
     the hybrid's attention 1 flash forward and one backward call an
     application), each step's loss, grad norm and wall, the peak memory,
     one step under torch.profiler, that step's gradients against the
     oracle path (the sequential SSD recurrence) within TRAIN_BOUND, and a
     control, the SSD backward without the decays' cotangent, whose A_log
     and w_dt leaves must fall outside it; the bf16 loss against the oracle
     printed (not held) beside the same forward through ssd_scan_plain at
     chunk 64, 128 and 256 and through ssd_scan_chained_plain; the loss held
     in f32 instead (the parameters and config in float32, forward only,
     the f32 kernels against the oracle) within the loss limit, and a
     control, each SSD's state dropped between chunks, that must miss it; no
     SSM checkpoint is written;
     then reduced mamba2-2.7b and reduced granite-8b trained 100 steps each
     on the card, whose losses must drop by more than 0.5;
  X. the dry-run tooling (src/repro_torch/launch/dryrun.py), which needs
     no card and launches none of the kernels (their counts must stay 0):
     (a) its CLI on qwen2-7b decode_32k on the 256-rank mesh and
     qwen3-moe-30b-a3b decode_32k on the 512-rank one, each in a process of
     its own (a fake process group, meta DTensors): each must give status
     ok, and its roofline terms and per-device bytes are printed; (b)
     meanwhile phase T's musicgen-medium step (4 x 128) counted on meta
     tensors on one device: its FLOPs and compute and memory terms beside
     phase T's device ms, which must be at least the larger term (a
     roofline is a lower bound), and phase T's peak memory, which must be
     at least the dry-run's state bytes; both ratios printed;
  R. the B-PASTE runtime (src/repro_torch/core/runtime.py), which runs
     none of the kernels (their counts must stay 0): (a) the speculative-
     serving demos of launch/speculative_serving.py with their asserts;
     (b) benchmarks/bench_scheduler.py's serve-box cell at c = 256 on the
     host admission path, with every pool above 2 candidates on the card
     (``host_admit_max=2``) and the same on the CPU; the three summaries
     must agree outside the wall-clock keys; then the reference greedy at
     c = 3 scoring on the card against the fused pass; (c) one admission
     pass at K = 12, 96, 768 and 3072 candidates: ``admit_beam`` on the
     card (host wall, and device time and launches from torch.profiler),
     ``_admit_numpy`` on the host and ``score_beam`` per call;
  S. the port's static checker (src/repro_torch/staticcheck.py) held
     against the card: ``staticcheck.main(["--strict"])`` must return 0
     (files checked, findings, baselined sites and the C2 reach printed);
     every call the checker's C2 finds free of host syncs is run under
     ``torch.cuda.set_sync_debug_mode("error")``, where any sync raises and
     fails the run: in phase 3, after each served setup's profiles, one
     eager batched decode step and one 19-token prefill as
     ``_profile_steps`` makes them (qwen2-7b, sharded x4 with a bf16 and an int8 cache,
     mamba2-2.7b, zamba2-1.2b with a bf16 and an int8 cache,
     qwen3-moe-30b-a3b, musicgen-medium); in
     phase T one more musicgen-medium train_step; here one score_beam on
     the card at K = 96. The control: one forced-device admit_beam pass on
     the same tables under ``"warn"`` must raise sync warnings, each at the
     line of core/admission.py the checker's baseline names, one per
     iteration (picks with demand + 1);
  D. multi-device over torch.distributed (``launch.dist.spawn``): ranks
     that share the card, every one on cuda:0, their collectives over gloo
     (the card's name and power limit first; one JSON line per check,
     printed by rank 0). In one spawn of 4 ranks: D1, full-width qwen2-7b
     (rank 0 makes the weights and hands them to the others by CUDA IPC, one
     copy on the card), the cache sequence-sharded over the 4 ranks (each
     holds 48 of 192 rows), bf16 then int8, serving one episode of the
     speculative agent loop in lockstep: per rank the partials kernel's
     launches a step (28), collectives and staged host copies a step, host
     ms a step and the loop's summary (all equal); then a 100-token prefill
     and 6 greedy steps against the single-process LocalMesh and unsharded
     paths on log-softmax, under phase 4's bound (the unsharded kernels
     against the oracle path); D2, full-width qwen3-moe-30b-a3b (61 GB,
     shared the same way), expert parallel over the 4 ranks (32 experts
     each), then expert TP over 3 of them (128 % 3 != 0, d_ff 768 / 3), a
     19-token prefill and 4 decode steps at capacity factor E / k against
     the single-process MoE on log-softmax within its kernel-vs-oracle gap,
     drop_frac equal call for call, and the card's memory in use; D4,
     elastic restore of a reduced MoE model's state (a chip call's disk cap
     leaves no room for a full-width checkpoint beside phase T's): saved
     from the 4 ranks (one expert each), restored onto 2 (two each),
     bitwise. Then D3, full-width musicgen-medium data parallel over 2
     ranks, each with its own 21.8 GB of training state: one step's
     gradients (2 of the 4 x 128 rows a rank, summed over the ranks)
     against the single-process step on the whole batch, computed first
     (TRAIN_BOUND: loss, grad norm, leaves), after a control (each rank on
     its own half, no reduce) that must miss it and compressed_grad_sync
     over a 2-rank pod axis on those per-rank gradients (within 2 % of their
     exact mean, every rank equal); that step's update, then a second
     through train_step, each step's loss and grad norm against the single
     process's; the flash forward and backward kernels on each rank;
  5. one JSON line on the kernels, six of them (the backward kernels with
     phase T's launches, the forward kernels with their training launches
     beside the serving counts, every kernel with phase D's launches summed
     over the ranks as ``dist_launches``, and the forward kernels with the
     served int8 zamba2-1.2b run's as ``int8_hybrid_launches``, unsharded,
     so no partials; the decode kernels' serving counts are those of the
     profiled steps' trace; flash, decode and the SSD scan also with their
     times and bounds at zamba2-7b's cell's longest shapes as
     ``zamba2_7b_at``); last, one JSON line on the device.

Exits non-zero without a CUDA device, outside a checkout of the repository,
or on any failure. Imports nothing of JAX or of the JAX package.
"""
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

SEED = 0
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM dense: tensor bf16, fp32 FMA
PEAK_BYTES = 3.35e12                                            # H100 SXM HBM3
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
SSD_TOL = {torch.bfloat16: 2e-2, torch.float32: 3e-4}  # tests/test_kernels.py's SSD tolerance
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
L2_FLUSH_BYTES = 128 << 20      # larger than the 50 MB L2: each timed call starts cold
# phase T: one full-width bf16 training step through the kernels against the
# same step through the oracle path (attn_impl="ref": the materialized
# attention, which rounds its scores to bf16, and the sequential SSD
# recurrence): relative loss and grad-norm gaps, and per leaf (wq/wk/wv; the
# Mamba2 layers' w_x, w_B, w_C, w_dt, A_log, D) the max |difference| over max
# |oracle| and the cosine. Each limit is 2-6x the largest sound reading of
# musicgen-medium on an H100 (loss 1.7e-5, grad norm 5.0e-4, leaf 0.045,
# cosine 0.9986); a backward without delta must fall outside it (PERF.md).
# The SSM archs' loss is held to the loss limit in f32 (ssm_training): at
# their depth a bf16 forward's own noise reaches 2e-4-4e-4 of the loss
# whichever correct SSD runs in it (independent f32 chunkings read 3e-6 to
# 2e-4 against the oracle), so their bf16 loss gap is printed beside its
# same-run spread and not held
TRAIN_BOUND = {"loss": 1e-4, "grad_norm": 2e-3, "leaf_rel": 0.1, "leaf_cos": 0.995}


def _time_ms(fn, iters, flush):
    """Mean device time of one call. Each timed call is queued behind a
    sleep kernel that outlasts the host's queueing of it, so the CUDA events
    around the call time the device alone, not the host's dispatch (this
    holds while one call launches fewer kernels than a stream queues, about
    a thousand). The L2 cache is flushed before each call, outside the
    events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    sleep_cycles = int(10 * (time.perf_counter() - t0) * 2e9)  # ten calls' time at 2 GHz
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _bound(n_bytes, flops, dtype):
    by_bytes, by_ops = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _check(name, got, want, dtype, tols=TOL):
    err = (got.float() - want.float()).abs().max().item()
    tol = tols[dtype]
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError(f"{name}: kernel and plain version disagree, max abs err {err}")
    return err


def flash_case(ops, gen, flush, b, s, h, kv, d, dtype, window, timed):
    F = torch.nn.functional
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dtype)
    kw = dict(causal=True, window=window)
    want = ops.flash_attention(q, k, v, impl="plain", **kw)
    got = ops.flash_attention(q, k, v, impl="kernel", **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.flash_attention(q, k, v, impl="kernel", **kw)), \
        f"flash_attention {[b, s, h, kv, d]}: two calls differ"
    case = {"shape": [b, s, h, kv, d], "dtype": str(dtype).split(".")[1], "window": window,
            "max_abs_err": _check(f"flash_attention {[b, s, h, kv, d]} window {window}",
                                  got, want, dtype)}
    if not timed:
        return case
    pos = torch.arange(s)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    flops = 4 * int(mask.sum()) * d * h * b
    case["bound_ms"], case["bound_by"] = _bound(_nbytes(q, k, v, got), flops, dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib_mask = None if window is None else mask.cuda()

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=lib_mask,
                                              is_causal=window is None, enable_gqa=True)

    case["library_err"] = (library().transpose(1, 2).float() - want.float()).abs().max().item()
    iters = 20 if s > 512 else 50
    case["ms"] = _time_ms(lambda: ops.flash_attention(q, k, v, impl="kernel", **kw), iters, flush)
    case["plain_ms"] = _time_ms(lambda: ops.flash_attention(q, k, v, impl="plain", **kw),
                                iters, flush)
    case["library_ms"] = _time_ms(library, iters, flush)
    return case


def flash_bwd_case(ops, fa, gen, flush, b, s, h, kv, d, dtype, window):
    """The backward kernel against flash_attention_bwd_plain on the same
    (q, k, v, o, lse, dO), o and lse from the forward kernel, whose o is
    held against flash_attention_plain (``TOL``) and whose LSE against the
    plain version's (2e-5); bitwise from call to call.
    Timed cold: the backward kernel alone (ms), the plain backward
    (plain_ms), the kernels' forward + backward through autograd
    (fwd_bwd_ms), and SDPA's forward + backward through autograd
    (library_ms, a yardstick the port never calls); and one cold call
    under torch.profiler, its device time split by kernel (kernel_ms:
    delta, dK/dV, the GQA sum where grp > 1, dQ). The bound counts the
    backward's five products over the visible pairs (S = q k^T, dP = dO
    v^T, dV, dK, dQ: 10 D operations a pair and head) and its bytes: q, k,
    v, o, dO, lse read once, dq, dk, dv written once."""
    from torch.profiler import ProfilerActivity, profile
    F = torch.nn.functional
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dtype)
    do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    kw = dict(causal=True, window=window, scale=d ** -0.5)
    name = f"flash_attention_bwd {[b, s, h, kv, d]} window {window}"
    o, lse = fa.flash_attention_kernel(q, k, v, return_lse=True, **kw)
    o_plain, lse_plain = fa.flash_attention_fwd_lse_plain(q, k, v, **kw)
    o_err = _check(f"{name} o", o, o_plain, dtype)
    lse_err = (lse - lse_plain).abs().max().item()
    assert torch.allclose(lse, lse_plain, atol=2e-5, rtol=2e-5), f"{name}: lse err {lse_err}"
    assert torch.equal(o, fa.flash_attention_kernel(q, k, v, **kw)), \
        f"{name}: o differs with and without lse"
    got = fa.flash_attention_bwd_kernel(q, k, v, o, lse, do, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    again = fa.flash_attention_bwd_kernel(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, g) for a, g in zip(again, got, strict=True)), \
        f"{name}: two calls differ"
    case = {"shape": [b, s, h, kv, d], "dtype": str(dtype).split(".")[1], "window": window,
            "o_err": o_err, "lse_err": lse_err,
            "max_abs_err": max(_check(f"{name} {g_name}", g, w, dtype)
                               for g_name, g, w in zip(("dq", "dk", "dv"), got, want,
                                                       strict=True))}
    pos = torch.arange(s)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    flops = 10 * int(mask.sum()) * d * h * b
    case["bound_ms"], case["bound_by"] = _bound(_nbytes(q, k, v, o, do, lse, *got), flops, dtype)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    lib_do = do.transpose(1, 2)
    lib_mask = None if window is None else mask.cuda()

    def fwd_bwd():
        return torch.autograd.grad(ops.flash_attention(*leaves, window=window), leaves, do)

    def library():
        out = F.scaled_dot_product_attention(*lib_leaves, attn_mask=lib_mask,
                                             is_causal=window is None, enable_gqa=True)
        return torch.autograd.grad(out, lib_leaves, lib_do)

    iters = 10 if s > 512 else 30
    case["ms"] = _time_ms(lambda: fa.flash_attention_bwd_kernel(q, k, v, o, lse, do, **kw),
                          iters, flush)
    case["plain_ms"] = _time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw),
                                iters, flush)
    case["fwd_bwd_ms"] = _time_ms(fwd_bwd, iters, flush)
    case["library_ms"] = _time_ms(library, iters, flush)
    flush.zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fa.flash_attention_bwd_kernel(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
    case["kernel_ms"] = {re.search(r"flash_bwd_\w+", e.key).group(0): e.self_device_time_total / 1e3
                         for e in prof.key_averages() if "flash_bwd_" in e.key}
    return case


def decode_case(ops, gen, flush, b, h, kv, d, smax, dtype, window, timed):
    F = torch.nn.functional
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(dtype)
    kc = torch.randn((b, smax, kv, d), generator=gen, device="cuda").to(dtype)
    vc = torch.randn((b, smax, kv, d), generator=gen, device="cuda").to(dtype)
    lengths = torch.randint(1, smax + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
    want = ops.decode_attention(q, kc, vc, lengths, impl="plain", window=window)
    got = ops.decode_attention(q, kc, vc, lengths, impl="kernel", window=window)
    torch.cuda.synchronize()
    lens = lengths.tolist()
    again = ops.decode_attention(q, kc, vc, lengths, impl="kernel", window=window)
    assert torch.equal(got, again), f"decode_attention {[b, smax]} lengths {lens}: two calls differ"
    case = {"shape": [b, h, kv, d, smax], "dtype": str(dtype).split(".")[1], "window": window,
            "lengths": lens,
            "max_abs_err": _check(f"decode_attention {[b, h, kv, d, smax]} lengths {lens}",
                                  got, want, dtype)}
    if not timed:
        return case
    visited = sum(min(n, smax) - (max(0, n - window) if window is not None else 0) for n in lens)
    n_bytes = _nbytes(q, got, lengths) + 2 * visited * kv * d * kc.element_size()
    case["bound_ms"], case["bound_by"] = _bound(n_bytes, 4 * visited * h * d, dtype)
    pos = torch.arange(smax, device="cuda")[None, :]
    lib_mask = pos < lengths[:, None]
    if window is not None:
        lib_mask &= pos >= lengths[:, None] - window
    lib_mask = lib_mask[:, None, None, :]
    q4, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(q4, kt, vt, attn_mask=lib_mask, enable_gqa=True)

    case["library_err"] = (library()[:, :, 0].float() - want.float()).abs().max().item()
    kw = dict(window=window)
    case["ms"] = _time_ms(lambda: ops.decode_attention(q, kc, vc, lengths, impl="kernel", **kw),
                          50, flush)
    case["plain_ms"] = _time_ms(
        lambda: ops.decode_attention(q, kc, vc, lengths, impl="plain", **kw), 50, flush)
    case["library_ms"] = _time_ms(library, 50, flush)
    return case


def partials_case(ops, da, gen, flush, smax, lengths, dtype, window, timed, h=28, kv=4,
                  d=128):
    """The split-KV partials over the 4 slices of a (4, smax, kv, d) cache
    (by default qwen2-7b's batch, kv heads and head_dim; 28 query heads),
    each slice a view of the cache, with f32 pre-scaled q as the sharded
    decode passes it; without a window the four are also combined and held
    against decode attention over the whole cache. Timed per launch over a
    sweep of the 4 slices (one layer of a sharded decode step)."""
    b = 4
    q = torch.randn((b, h, d), generator=gen, device="cuda") * d ** -0.5
    kc = torch.randn((b, smax, kv, d), generator=gen, device="cuda").to(dtype)
    vc = torch.randn((b, smax, kv, d), generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    chunk = smax // 4
    views = [(kc[:, lo:lo + chunk], vc[:, lo:lo + chunk], torch.clamp(lens - lo, 0, chunk))
             for lo in range(0, smax, chunk)]
    kw = dict(scale=1.0, window=window)
    err, parts = 0.0, []
    for r, (kv_k, kv_v, eff) in enumerate(views):
        want = ops.decode_attention_partials(q, kv_k, kv_v, eff, impl="plain", **kw)
        got = ops.decode_attention_partials(q, kv_k, kv_v, eff, impl="kernel", **kw)
        torch.cuda.synchronize()
        again = ops.decode_attention_partials(q, kv_k, kv_v, eff, impl="kernel", **kw)
        assert all(torch.equal(a, g) for a, g in zip(again, got, strict=True)), \
            f"decode_attention_partials slice {r}: two calls differ"
        for name, g, w in zip(("acc", "m", "l"), got, want, strict=True):
            assert torch.isfinite(g).all(), f"partials {name} of slice {r} is not finite"
            err = max(err, _check(f"decode_attention_partials {[b, smax, h, kv, d]} slice {r} "
                                  f"{name}", g, w, dtype))
        parts.append(got)
    effs = [v[2].tolist() for v in views]
    assert any(0 < e < chunk for row in effs for e in row) and any(0 in row for row in effs)
    case = {"shape": [b, smax, h, kv, d], "dtype": str(dtype).split(".")[1], "window": window,
            "lengths": lengths, "slice_lengths": effs, "max_abs_err": err}
    if window is None:
        acc, _, denom = da.combine_partials(*(torch.stack(t) for t in zip(*parts, strict=True)))
        out = acc / torch.clamp(denom[..., None], min=1e-30)
        whole = ops.decode_attention(q, kc, vc, lens, impl="plain", **kw)
        case["combined_err"] = _check(f"decode_attention_partials {[b, smax]} combined",
                                      out.reshape(b, h, d), whole, dtype)
    if not timed:
        return case
    visited = sum(e - (max(0, e - window) if window is not None else 0)
                  for row in effs for e in row)
    n_bytes = (4 * _nbytes(q, lens, *parts[0]) + 2 * visited * kv * d * kc.element_size())
    case["bound_ms"], case["bound_by"] = _bound(n_bytes / 4, 4 * visited * h * d / 4, dtype)

    def sweep(impl):
        for kv_k, kv_v, eff in views:
            ops.decode_attention_partials(q, kv_k, kv_v, eff, impl=impl, **kw)

    case["ms"] = _time_ms(lambda: sweep("kernel"), 50, flush) / 4
    case["plain_ms"] = _time_ms(lambda: sweep("plain"), 50, flush) / 4
    case["library_ms"] = None   # no single PyTorch call returns unnormalized partials
    return case


def ssd_case(ops, gen, flush, b, s, h, p, g, n, dtype, with_h0, timed, chunk=128):
    x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
    dt = torch.empty((b, s, h), device="cuda").uniform_(0.001, 0.1, generator=gen)
    A = -torch.empty((h,), device="cuda").uniform_(1.0, 16.0, generator=gen)
    B = torch.randn((b, s, g, n), generator=gen, device="cuda").to(dtype)
    C = torch.randn((b, s, g, n), generator=gen, device="cuda").to(dtype)
    D = torch.randn((h,), generator=gen, device="cuda")
    h0 = torch.randn((b, h, p, n), generator=gen, device="cuda") if with_h0 else None
    args = (x, dt, A, B, C, D)
    kw = dict(chunk=chunk, initial_state=h0)
    want_y, want_h = ops.ssd_scan(*args, impl="plain", **kw)
    got_y, got_h = ops.ssd_scan(*args, impl="kernel", **kw)
    torch.cuda.synchronize()
    name = f"ssd_scan {[b, s, h, p, g, n]} chunk {chunk} h0 {with_h0}"
    again = ops.ssd_scan(*args, impl="kernel", **kw)
    assert torch.equal(got_y, again[0]) and torch.equal(got_h, again[1]), \
        f"{name}: two calls differ"
    case = {"shape": [b, s, h, p, g, n], "chunk": chunk, "dtype": str(dtype).split(".")[1],
            "h0": with_h0,
            "max_abs_err": max(_check(f"{name} y", got_y, want_y, dtype, SSD_TOL),
                               _check(f"{name} state", got_h, want_h, dtype, SSD_TOL))}
    if not timed:
        return case
    # operations per chunk and head with q valid rows: C B^T and its product
    # with x (2 q^2 N + 2 q^2 P), the inter-chunk term and the state update (4 q N P)
    rows = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    flops = b * h * sum(2 * q * q * n + 2 * q * q * p + 4 * q * n * p for q in rows)
    n_bytes = _nbytes(*args, got_y, got_h) + (_nbytes(h0) if with_h0 else 0)
    case["bound_ms"], case["bound_by"] = _bound(n_bytes, flops, dtype)
    iters = 20 if s > 512 else 50
    case["ms"] = _time_ms(lambda: ops.ssd_scan(*args, impl="kernel", **kw), iters, flush)
    case["plain_ms"] = _time_ms(lambda: ops.ssd_scan(*args, impl="plain", **kw), iters, flush)
    case["library_ms"] = None   # no single PyTorch call computes the SSD scan
    return case


def _check_grads(name, got, want, dtype):
    """Each SSD gradient against the plain backward's: within SSD_TOL of the
    reference (rtol) and SSD_TOL times its largest magnitude (atol), since
    ddt and dA sum terms of hundreds that cancel. Returns the largest
    |difference| and that over the reference's largest magnitude, per
    output."""
    tol, errs = SSD_TOL[dtype], {}
    for g_name, g, w in zip(SSD_GRADS, got, want, strict=True):
        g, w = g.float(), w.float()
        scale = w.abs().max().item()
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g_name)
        if not (torch.isfinite(g).all() and torch.allclose(g, w, atol=tol * scale, rtol=tol)):
            raise AssertionError(f"{name} {g_name}: kernel and plain version disagree, max abs "
                                 f"err {(g - w).abs().max().item()} at scale {scale}")
        err = (g - w).abs().max().item()
        errs[g_name] = [err, err / max(scale, 1e-30)]
    return errs


def ssd_bwd_case(ssd, gen, flush, b, s, h, p, g, n, chunk, dtype, with_h0, with_dfinal):
    """The SSD backward kernel against ssd_scan_bwd_plain on the same inputs
    and chunk states (the forward kernel's, written with
    ``return_chunk_states``; the forward's y and final state must be the same
    bit for bit as without them, and the chunk states agree with the plain
    version's); bitwise from call to call. Timed cold: the backward kernel
    (ms, both launches), the plain backward (plain_ms) and, for reference
    only, autograd over ssd_scan_plain (autograd_ms, forward included). The
    bound counts, per chunk of q valid rows, the causal pairs' products
    (C B^T once per group; dy x^T, M^T dy, dG B and dG^T C per head: 2 N + 4
    P + 4 N operations a pair and head) and the state terms (u, h_c^T dy, gn
    B and gn^T x: 8 q P N a head), and its bytes: x, dt, A, B, C, D, the
    chunk states, dy and d(final) read once, the seven gradients written
    once. No single PyTorch call computes this backward (library_ms None)."""
    x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
    dt = torch.empty((b, s, h), device="cuda").uniform_(0.001, 0.1, generator=gen)
    A = -torch.empty((h,), device="cuda").uniform_(1.0, 16.0, generator=gen)
    B = torch.randn((b, s, g, n), generator=gen, device="cuda").to(dtype)
    C = torch.randn((b, s, g, n), generator=gen, device="cuda").to(dtype)
    D = torch.randn((h,), generator=gen, device="cuda")
    h0 = torch.randn((b, h, p, n), generator=gen, device="cuda") if with_h0 else None
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
    df = torch.randn((b, h, p, n), generator=gen, device="cuda") if with_dfinal else None
    args = (x, dt, A, B, C, D)
    name = f"ssd_scan_bwd {[b, s, h, p, g, n]} chunk {chunk} h0 {with_h0} dfinal {with_dfinal}"
    y, final = ssd.ssd_scan_kernel(*args, chunk=chunk, initial_state=h0)
    y_t, final_t, h_in = ssd.ssd_scan_kernel(*args, chunk=chunk, initial_state=h0,
                                             return_chunk_states=True)
    _, _, h_in_plain = ssd.ssd_scan_plain(*args, chunk=chunk, initial_state=h0,
                                          return_chunk_states=True)
    torch.cuda.synchronize()
    assert torch.equal(y, y_t) and torch.equal(final, final_t), \
        f"{name}: the forward's y or final state changes when it writes the chunk states"
    h_in_err = _check(f"{name} chunk states", h_in, h_in_plain, dtype, SSD_TOL)
    got = ssd.ssd_scan_bwd_kernel(*args, h_in, dy, df, chunk=chunk)
    want = ssd.ssd_scan_bwd_plain(*args, h_in, dy, df, chunk=chunk)
    torch.cuda.synchronize()
    again = ssd.ssd_scan_bwd_kernel(*args, h_in, dy, df, chunk=chunk)
    assert all(torch.equal(a, c) for a, c in zip(again, got, strict=True)), \
        f"{name}: two calls differ"
    errs = _check_grads(name, got, want, dtype)
    case = {"shape": [b, s, h, p, g, n], "chunk": chunk, "dtype": str(dtype).split(".")[1],
            "h0": with_h0, "dfinal": with_dfinal, "chunk_states_err": h_in_err,
            "err_abs_rel": errs, "max_abs_err": max(e[0] for e in errs.values())}
    rows = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    pairs = [q * (q + 1) // 2 for q in rows]
    flops = b * sum(2 * pr * n * g + h * pr * (4 * p + 4 * n) + 8 * h * q * p * n
                    for q, pr in zip(rows, pairs, strict=True))
    n_bytes = _nbytes(*args, h_in, dy, *got) + sum(_nbytes(t) for t in (h0, df) if t is not None)
    case["bound_ms"], case["bound_by"] = _bound(n_bytes, flops, dtype)
    leaves = [t.detach().requires_grad_() for t in args]
    h0_leaf = None if h0 is None else h0.detach().requires_grad_()

    def autograd_plain():
        yp, fp = ssd.ssd_scan_plain(*leaves, chunk=chunk, initial_state=h0_leaf)
        outs, cots = [yp], [dy]
        if df is not None:
            outs, cots = outs + [fp], cots + [df]
        return torch.autograd.grad(outs, leaves + ([h0_leaf] if h0 is not None else []), cots)

    iters = 5 if b * s * h >= 100_000 else 20
    case["ms"] = _time_ms(lambda: ssd.ssd_scan_bwd_kernel(*args, h_in, dy, df, chunk=chunk),
                          iters, flush)
    case["plain_ms"] = _time_ms(lambda: ssd.ssd_scan_bwd_plain(*args, h_in, dy, df, chunk=chunk),
                                iters, flush)
    case["autograd_ms"] = _time_ms(autograd_plain, iters, flush)
    case["library_ms"] = None   # no single PyTorch call computes the SSD backward
    return case


def _profile(label, run, calls, named, weight_bytes):
    """Device time of one call from a torch.profiler trace (the sum of its
    kernels' times) over ``run``, which makes ``calls`` calls and
    synchronises, against the host's wall time per call, with the named
    kernels' own shares and the weight bytes a call reads (every weight but
    the embedding table, of which it reads a row per token). ``named`` is a
    list of (name, the name of its __global__ function); returns each named
    kernel's launches in the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) / calls * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / calls / 1e3
    assert device_ms > 0, "the profiler recorded no device time"
    launches = sum(e.count for e in kernels) / calls
    own, traced = "", {}
    for name, symbol in named:
        mine = [e for e in kernels if symbol in e.key]
        assert mine, f"the trace holds no {name} kernel"
        traced[name] = sum(e.count for e in mine)
        mine_ms = sum(e.self_device_time_total for e in mine) / calls / 1e3
        own += (f"; {name} {mine_ms:.4f} ms ({mine_ms / device_ms:.3f} of the device time) "
                f"in {sum(e.count for e in mine) / calls:.0f} launches")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    shares = ", ".join(f"{e.key[:48]} {e.self_device_time_total / calls / 1e3:.3f} ms"
                       for e in top)
    print(f"phase 3 {label} (profiler, {calls} calls): device {device_ms:.3f} ms in "
          f"{launches:.0f} kernels, wall {wall_ms:.3f} ms, device busy "
          f"{device_ms / wall_ms:.3f} of the wall time{own}; weights read "
          f"{weight_bytes / 1e9:.3f} GB ({weight_bytes / PEAK_BYTES * 1e3:.3f} ms at "
          f"{PEAK_BYTES / 1e12} TB/s); top kernels: {shares}", flush=True)
    return traced


SYNC_CHECKED = []  # phase S: (label, seconds) of each call run under sync debug mode "error"
RUN_T0 = time.time()  # the run's start, for the clock line after each phase


def clock(phase):
    """The line that closes a phase: wall seconds since the run began."""
    print(f"clock {phase}: {time.time() - RUN_T0:.1f} s since the run began", flush=True)


def under_sync_mode(mode, fn):
    """fn() under torch.cuda.set_sync_debug_mode(mode), the mode reset to 0
    after, and the sync warnings it raised: (result, warnings). Under
    "error" a sync raises instead, and is not caught."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(mode)
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, [w for w in caught if "called a synchronizing" in str(w.message)]


def sync_checked(label, fn):
    """Phase S: fn() under set_sync_debug_mode("error"), recorded and printed."""
    t0 = time.time()
    out, syncs = under_sync_mode("error", fn)
    assert not syncs, [str(w.message) for w in syncs]
    SYNC_CHECKED.append((label, time.time() - t0))
    print(f"phase S {label} under set_sync_debug_mode('error'): no sync "
          f"({SYNC_CHECKED[-1][1]:.3f} s)", flush=True)
    return out


def _release(engine):
    """Every slot of ``engine`` free again, as a caller releases one."""
    for s in engine.slots:
        s.active, s.request_id = False, None


def _fill(engine, prompt_len=19):
    """Every slot of ``engine`` released, then admitted with a prompt of its
    own of ``prompt_len`` tokens, the length of a speculative observation."""
    _release(engine)
    for i in range(engine.max_batch):
        engine.add_request(list(range(2 + i, 2 + i + prompt_len)), request_id=i)


def _profile_steps(M, params, engine, label, decode_kernels, prefill_kernels, per_step,
                   calls=3):
    """Profile served decode steps, ``engine.step()`` with every slot
    decoding (on a card each replays the engine's CUDA graph) and, unless
    ``prefill_kernels`` is None, the prefill of a 19-token prompt, the
    length of a speculative observation; each list names the repository's
    kernels the call runs (a Mamba2 decode step runs none). The trace must
    hold ``per_step[name]`` launches of each decode kernel a step, and
    every step must replay. Returns each decode kernel's launches in the
    trace, its slots released after."""
    cfg = engine.cfg
    weight_bytes = _nbytes(*_tensors({k: v for k, v in params.items() if k != "embed"}))
    _fill(engine)
    prompt = torch.arange(2, 21, device="cuda")[None]

    def decode():
        for _ in range(calls):
            assert engine.step(), "every slot has finished"
        torch.cuda.synchronize()

    def prefill():
        for _ in range(calls):
            M.prefill(params, cfg, {"tokens": prompt}, max_len=engine.max_len)
        torch.cuda.synchronize()

    replays0 = engine.graph_replays
    traced = _profile(f"{label} decode step at batch {engine.max_batch}", decode, calls,
                      decode_kernels, weight_bytes)
    assert engine.graph_replays - replays0 == 3 * calls, "a served step did not replay"
    assert traced == {name: n * calls for name, n in per_step.items()}, (traced, per_step)
    if prefill_kernels is not None:
        _profile(f"{label} prefill of {prompt.shape[1]} tokens", prefill, calls,
                 prefill_kernels, weight_bytes)
    # phase S: the same calls once each, eagerly, where no sync may happen
    tokens = torch.as_tensor(engine.pending_tokens, dtype=torch.int64).cuda()
    active = torch.ones(engine.max_batch, dtype=torch.bool, device="cuda")
    sync_checked(f"{label} decode_step at batch {engine.max_batch}",
                 lambda: M.decode_step(params, cfg, engine.cache, tokens, active=active,
                                       mesh_info=engine.mesh_info))
    sync_checked(f"{label} prefill of {prompt.shape[1]} tokens",
                 lambda: M.prefill(params, cfg, {"tokens": prompt}, max_len=engine.max_len,
                                   mesh_info=engine.mesh_info))
    _release(engine)
    return traced


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for item in items for t in _tensors(item)]


def init_model(M, cfg):
    t0 = time.time()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    print(f"phase 3 init: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"{n_params / 1e9:.3f} B params {cfg.dtype} in {time.time() - t0:.1f} s", flush=True)
    return params


def serve_model(M, ServingEngine, serve_agent_loop, cfg, params, pe, episodes, counters,
                label, mesh_info=None):
    """Phase 3 for one model: warm up, then serve the episodes with
    speculation off and on, the kernels' counts (``counters``: name ->
    (module, attribute)) set to 0 just before and read just after. Every
    served step must replay the engine's CUDA graph, whose kernels the
    counters do not see: ``_profile_steps`` counts them in a trace."""
    engine = ServingEngine(cfg, params, max_batch=4, max_len=192, mesh_info=mesh_info,
                           device="cuda")
    serve_agent_loop(False, cfg, engine, episodes[:1], pe, reason_tokens=1)   # warm-up
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    steps0, replays0 = engine.steps_executed, engine.graph_replays
    runs = {}
    for spec_on in (False, True):
        dt, steps, hits, spec = serve_agent_loop(spec_on, cfg, engine, episodes, pe)
        runs[spec_on] = spec
        print(f"phase 3 {label} serve speculation={'on' if spec_on else 'off'}: {steps} "
              f"decode steps in {dt:.3f} s ({steps / dt:.2f} steps/s, "
              f"{dt / steps * 1e3:.2f} ms/step), admitted={spec.admitted} "
              f"promotions={spec.promotions} preemptions={spec.preemptions} hits={hits}",
              flush=True)
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    engine_steps = engine.steps_executed - steps0
    assert engine.graph_replays - replays0 == engine_steps, "a served step did not replay"
    prefills = 2 * len(episodes) + runs[True].admitted
    print(f"phase 3 {label} launches: {launches} over {prefills} prefills and "
          f"{engine_steps} engine steps of {cfg.n_layers} layers", flush=True)
    assert runs[True].admitted > 0, "speculation admitted no slot"
    return engine, launches, prefills, engine_steps


def check_model(M, cfg, params, engine, label, need=5, prompt=(5, 6, 7, 8)):
    """Phase 4 for one model: a batched slot of ``engine`` against a
    standalone prefill + decode with ``cfg``, teacher-forced, and the
    engine's own path (sharded where it is) against the oracle path."""
    prompt = list(prompt)
    toks = torch.tensor([prompt], device="cuda")
    mi = engine.mesh_info
    ref_cfg = dataclasses.replace(engine.cfg, attn_impl="ref")
    lg, cache = M.prefill(params, cfg, {"tokens": toks}, max_len=192)
    lg_path, cache_path = M.prefill(params, engine.cfg, {"tokens": toks}, max_len=192)
    lg_ref, cache_ref = M.prefill(params, ref_cfg, {"tokens": toks}, max_len=192)
    tok = torch.argmax(lg, -1)
    forced, toks_single, corr = [int(tok[0])], [], []
    for _ in range(6):
        pair = torch.stack([lg_path[0, :cfg.vocab_size], lg_ref[0, :cfg.vocab_size]])
        corr.append(float(torch.corrcoef(pair)[0, 1]))
        lg, cache = M.decode_step(params, cfg, cache, tok)
        lg_path, cache_path = M.decode_step(params, engine.cfg, cache_path, tok, mesh_info=mi)
        lg_ref, cache_ref = M.decode_step(params, ref_cfg, cache_ref, tok, mesh_info=mi)
        assert lg.shape == (1, cfg.padded_vocab) and torch.isfinite(lg[:, :cfg.vocab_size]).all()
        assert torch.isfinite(lg_path[:, :cfg.vocab_size]).all()
        tok = torch.argmax(lg, -1)
        toks_single.append(int(tok[0]))
        forced.append(int(tok[0]))
    slot = engine.add_request(prompt, request_id=1)
    toks_batched = []
    for i in range(6):
        engine.pending_tokens[slot] = forced[i]
        toks_batched.append(engine.step()[slot])
    agree = sum(a == b for a, b in zip(toks_batched, toks_single, strict=True))
    print(f"phase 4 {label} teacher-forced: batched {toks_batched} single {toks_single} "
          f"agree {agree}/6; kernel-vs-oracle logit correlation min {min(corr):.6f}", flush=True)
    assert agree >= need, (toks_batched, toks_single)
    assert min(corr) > 0.99, corr


def _decode_vs_forward(M, params, cfg, prompt, steps, unrotate=False):
    """max |log-softmax difference| of each greedy decode step after a
    prefill of ``prompt`` (max_len 192) against the oracle path's full
    forward (``attn_impl="ref"``) over the same tokens. ``unrotate`` first
    moves the cache's rows back to the order the JAX package's prefill
    leaves them in (positions in order from row 0)."""
    oracle = dataclasses.replace(cfg, attn_impl="ref")
    seq = list(prompt)
    lg, cache = M.prefill(params, cfg, {"tokens": torch.tensor([seq], device="cuda")},
                          max_len=192)
    if unrotate:
        for name in ("k", "v"):
            cache[name].copy_(torch.roll(cache[name], -(len(seq) % cache[name].shape[2]), 2))
    errs = []
    for _ in range(steps):
        tok = torch.argmax(lg, -1)
        seq.append(int(tok[0]))
        lg, cache = M.decode_step(params, cfg, cache, tok)
        full, _ = M.forward(params, oracle, {"tokens": torch.tensor([seq], device="cuda")})
        diff = (torch.log_softmax(lg[:, :cfg.vocab_size].float(), -1)
                - torch.log_softmax(full[:, -1, :cfg.vocab_size].float(), -1))
        errs.append(diff.abs().max().item())
    return errs


def check_rolling(M, cfg, params, window=64, prompt=range(5, 105), steps=6):
    """Phase 4: the rolling buffer's decode after a prompt longer than the
    buffer (100 tokens into 64 rows, 100 % 64 != 0) against the full forward
    under the window mask, on log-softmax. The bound is 1.5 times the same
    distance for a cache of all 192 rows with no window, two bf16 roundings
    of the same model (~0.09 at full width). A row written over while still
    in the window moves the log-softmax far more: the same cache with its
    rows unrotated must exceed the bound, or the check could not see it."""
    swa = dataclasses.replace(cfg, sliding_window=window)
    errs = {"full cache": _decode_vs_forward(M, params, cfg, prompt, steps),
            "rolling": _decode_vs_forward(M, params, swa, prompt, steps),
            "rolling, rows unrotated": _decode_vs_forward(M, params, swa, prompt, steps,
                                                          unrotate=True)}
    bound = 1.5 * max(errs["full cache"])
    print(f"phase 4 {cfg.name} rolling window {window}, {len(prompt)}-token prompt, decode vs "
          f"full forward, max |log-softmax difference| per step (bound {bound:.4f}): "
          f"{json.dumps(errs)}", flush=True)
    assert max(errs["rolling"]) <= bound, errs
    assert min(errs["rolling, rows unrotated"]) > bound, errs


def check_sharded_engines(M, ServingEngine, cfg, params, mesh_info, counters, attn_layers,
                          steps=6):
    """Phase 4: sharded engines against unsharded ones, int8 and bf16
    caches, the same requests and tokens, on log-softmax of every active
    slot. The prompts (61 and 120 tokens) put keys in the first three of
    the four shards, so the combine adds partials of several shards. The
    bound is the unsharded kernel path against the oracle path
    (``attn_impl="ref"``) on the same requests: two roundings of the same
    bf16 model, whose log-softmax differ by ~0.08 at full width, so the
    2e-2 of tests/test_perf_features.py::test_sharded_decode_multidevice
    (a reduced model) holds for no two paths here; the CPU tests hold the
    sharded path to it at reduced size. A dropped or misplaced shard moves
    the log-softmax by far more. Each sharded engine's steps must launch
    the partials kernel ``attn_layers`` x shards times a step, the others
    never (``counters``: name -> (module, attribute))."""
    int8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    configs = {"int8": (int8, None),
               "int8 sharded": (dataclasses.replace(int8, sharded_decode_attn=True), mesh_info),
               "bf16": (cfg, None),
               "bf16 sharded": (dataclasses.replace(cfg, sharded_decode_attn=True), mesh_info),
               "oracle": (dataclasses.replace(cfg, attn_impl="ref"), None)}
    engines = {name: ServingEngine(c, params, max_batch=4, max_len=192, mesh_info=mi,
                                   device="cuda") for name, (c, mi) in configs.items()}
    pairs = {"int8 sharded vs unsharded": ("int8", "int8 sharded"),
             "bf16 sharded vs unsharded": ("bf16", "bf16 sharded"),
             "kernel vs oracle, unsharded": ("bf16", "oracle")}
    for eng in engines.values():
        eng.add_request(list(range(2, 63)), request_id=1)
        eng.add_request(list(range(2, 122)), request_id=2, speculative=True)
    tokens = torch.as_tensor(engines["bf16"].pending_tokens, dtype=torch.int64).cuda()
    active = torch.tensor([True, True, False, False], device="cuda")
    errs = {name: [] for name in pairs}
    module, attr = counters["decode_attention_partials"]
    partials = dict.fromkeys(engines, 0)
    for _ in range(steps):
        lsm = {}
        for name, eng in engines.items():
            before = getattr(module, attr)
            lg, eng.cache = M.decode_step(params, eng.cfg, eng.cache, tokens, active=active,
                                          mesh_info=eng.mesh_info)
            partials[name] += getattr(module, attr) - before
            lsm[name] = torch.log_softmax(lg[:2, :cfg.vocab_size], dim=-1)
        for name, (a, b) in pairs.items():
            errs[name].append((lsm[a] - lsm[b]).abs().max().item())
        tokens[:2] = torch.argmax(lsm["bf16"], dim=-1)
    assert engines["int8 sharded"].cache["k"][0].dtype == torch.int8
    floor = max(errs["kernel vs oracle, unsharded"])
    print(f"phase 4 {cfg.name} max |log-softmax difference| over 2 slots per step (bound: "
          f"the kernel-vs-oracle maximum {floor:.4f}): {json.dumps(errs)}; partials launches "
          f"over {steps} steps: {json.dumps(partials)}", flush=True)
    assert max(errs["int8 sharded vs unsharded"]) <= floor, errs
    assert max(errs["bf16 sharded vs unsharded"]) <= floor, errs
    per_engine = attn_layers * mesh_info.n_model * steps
    assert partials["int8 sharded"] == partials["bf16 sharded"] == per_engine, partials
    assert partials["int8"] == partials["bf16"] == partials["oracle"] == 0, partials


def _cache_bytes(cache):
    """(K/V bytes, all bytes) of a cache."""
    kv = _nbytes(*_tensors([cache["k"], cache["v"]]))
    return kv, _nbytes(*_tensors(cache))


def int8_gap(M, cfg, params, prompt=range(5, 105), steps=6):
    """max |log-softmax difference| of an int8 cache against a bf16 one on
    the same tokens: a prefill of ``prompt``, then ``steps`` greedy decode
    steps of the bf16 cache, the int8 cache teacher-forced with its tokens."""
    int8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    toks = torch.tensor([list(prompt)], device="cuda")
    lg, cache = M.prefill(params, cfg, {"tokens": toks}, max_len=192)
    lg8, cache8 = M.prefill(params, int8, {"tokens": toks}, max_len=192)

    def gap():
        return (torch.log_softmax(lg[:, :cfg.vocab_size], -1)
                - torch.log_softmax(lg8[:, :cfg.vocab_size], -1)).abs().max().item()

    gaps = [gap()]
    for _ in range(steps):
        tok = torch.argmax(lg, -1)
        lg, cache = M.decode_step(params, cfg, cache, tok)
        lg8, cache8 = M.decode_step(params, int8, cache8, tok)
        gaps.append(gap())
    return gaps


def record_moe_drops(moe_mod):
    """Wrap ``moe_mod.moe_forward`` so that each call on one token per row
    (a layer of a decode step) appends its drop_frac to the list returned;
    the second value restores the original."""
    drops, real = [], moe_mod.moe_forward

    def recording(p, x, *args, **kw):
        y, aux = real(p, x, *args, **kw)
        if x.shape[1] == 1:
            drops.append(aux["drop_frac"])
        return y, aux

    moe_mod.moe_forward = recording
    return drops, lambda: setattr(moe_mod, "moe_forward", real)


def moe_drops(M, moe_mod, ServingEngine, params, cfg, steps=16):
    """The share of routed slots that drop per decode step (the mean over
    the layers): over ``steps`` served steps of a fresh engine, every slot
    decoding from a prompt of its own, and over one eager step of 4
    distinct tokens, all slots active. The engine captures its graph at
    its first step, the layers' last calls, whose drop fractions each
    replay rewrites: they are read after each step. At batch 4 each expert
    holds one slot."""
    engine = ServingEngine(cfg, params, max_batch=4, max_len=192, device="cuda")
    _fill(engine)
    drops, restore = record_moe_drops(moe_mod)
    try:
        per_step = []
        for _ in range(steps):
            assert engine.step(), "every slot has finished"
            per_step.append(torch.stack(drops[-cfg.n_layers:]).mean().item())
        assert engine.graph_replays == steps, "a served step did not replay"
        M.decode_step(params, cfg, engine.cache, torch.arange(2, 6, device="cuda"),
                      active=torch.ones(4, dtype=torch.bool, device="cuda"))
        distinct = torch.stack(drops[-cfg.n_layers:]).mean().item()
    finally:
        restore()
    print(f"phase 3 {cfg.name} drop_frac per decode step at batch {engine.max_batch} (capacity "
          f"{moe_mod.capacity(engine.max_batch, cfg)} per expert, mean over {cfg.n_layers} "
          f"layers): over {len(per_step)} served steps of 4 slots with 19-token prompts mean "
          f"{sum(per_step) / len(per_step):.4f}, min {min(per_step):.4f}, max "
          f"{max(per_step):.4f}; tokens 2-5, all active: {distinct:.4f}; a 19-token prefill "
          f"has capacity {moe_mod.capacity(19, cfg)}; per step: "
          f"{json.dumps([round(d, 4) for d in per_step])}", flush=True)
    assert all(0.0 <= d < 1.0 for d in per_step + [distinct]), per_step


def check_embeds(M, cfg, params, seq=19):
    """A prefill from frontend embeddings (1, seq, D) through the kernel
    path against the oracle path (``attn_impl="ref"``), on the last
    position's logits."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    emb = torch.randn((1, seq, cfg.d_model), generator=gen, device="cuda")
    lg, _ = M.prefill(params, cfg, {"embeds": emb}, max_len=192)
    lg_ref, _ = M.prefill(params, dataclasses.replace(cfg, attn_impl="ref"), {"embeds": emb},
                          max_len=192)
    pair = torch.stack([lg[0, :cfg.vocab_size], lg_ref[0, :cfg.vocab_size]])
    corr = float(torch.corrcoef(pair)[0, 1])
    print(f"phase 4 {cfg.name} prefill from embeds {[1, seq, cfg.d_model]}: kernel-vs-oracle "
          f"logit correlation {corr:.6f}", flush=True)
    assert torch.isfinite(lg[:, :cfg.vocab_size]).all() and corr >= 0.99, corr


WALL_CLOCK_KEYS = {"sched_us_per_admit", "sched_us_per_tick"}  # the scheduler's own wall clock
ADMIT_KS = (12, 96, 768, 3072)  # pool sizes of one timed admission pass (N = 12, R = 4)


def _strip(summary):
    return {k: v for k, v in summary.items() if k not in WALL_CLOCK_KEYS}


def _same_summary(a, b, what):
    diffs = {k: (a.get(k), v) for k, v in _strip(b).items() if a.get(k) != v}
    if diffs or set(_strip(a)) != set(_strip(b)):
        raise AssertionError(f"{what}: summaries differ on {diffs}")


def _serve_box_cell(run_mode, pe, box, c, **kw):
    """benchmarks/bench_scheduler.py's serve-box cell (24 cpu, accel 8,
    batched model steps, event scheduler) at concurrency c. Returns the
    summary and the host wall time of the run."""
    from repro_torch.core.workload import WorkloadConfig, make_episodes

    eps = make_episodes(WorkloadConfig(seed=11, n_episodes=c, arrival_stagger=0.5,
                                       shared_frac=0.5, shared_pool=4))
    t0 = time.perf_counter()
    s = run_mode(eps, pe, "bpaste", box, seed=7, max_concurrent_episodes=c, record_log=False,
                 model_max_batch=8, **kw).summary()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return s, time.perf_counter() - t0


def _counting(module, attr, counts):
    """Wrap ``module.attr`` so that each call adds one to ``counts`` under
    the device type of its first tensor argument; returns the original."""
    real = getattr(module, attr)

    def counted(*args, **kw):
        first = next(a for a in (*args, *kw.values()) if isinstance(a, torch.Tensor))
        counts[first.device.type] = counts.get(first.device.type, 0) + 1
        return real(*args, **kw)

    setattr(module, attr, counted)
    return real


def _admission_pool(pe, k):
    """``k`` candidates: tree hypotheses from a HypothesisBuilder (the
    runtime's settings) over the prefixes of the serve-box cell's 256
    episodes, then, where those run out, chains as
    benchmarks/bench_admission.py::_beam builds them."""
    from repro_torch.core.events import DEFAULT_TOOLS
    from repro_torch.core.hypothesis import BranchHypothesis, HypothesisBuilder, Node, NodeKind
    from repro_torch.core.workload import WorkloadConfig, episodes_to_traces, make_episodes

    traces = episodes_to_traces(make_episodes(WorkloadConfig(
        seed=11, n_episodes=256, arrival_stagger=0.5, shared_frac=0.5, shared_pool=4)))
    builder = HypothesisBuilder(pe, assembly="tree", max_nodes=11)
    pool = []
    for trace in traces:
        for cut in range(1, len(trace)):
            pool.extend(builder.build(trace[:cut], beam_width=12))
        if len(pool) >= k:
            return pool[:k], k
    n_tree = len(pool)
    for i in range(k - n_tree):
        tools = ["grep", "read", "parse", "search"][: 1 + i % 4]
        nodes = [Node(j, NodeKind.TOOL, t, DEFAULT_TOOLS[t].level, DEFAULT_TOOLS[t].rho,
                      DEFAULT_TOOLS[t].base_latency) for j, t in enumerate(tools)]
        pool.append(BranchHypothesis(10**6 + i, nodes, [(j - 1, j) for j in range(1, len(tools))],
                                     0.95 - 0.05 * (i % 10), context_key=("x",)))
    return pool, n_tree


def _pass_profile(run, calls):
    """(host wall ms, device ms, kernels, copies) per call of ``run``, which
    makes ``calls`` calls and synchronises; device time and launches from a
    torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) / calls * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / calls / 1e3
    assert device_ms > 0, "the profiler recorded no device time"
    copies = sum(e.count for e in events if "memcpy" in e.key.lower()
                 or "memset" in e.key.lower()) / calls
    kernels = sum(e.count for e in events) / calls - copies
    return wall_ms, device_ms, kernels, copies


def admission_times(pe, box, device):
    """Phase R(c): one admission pass at each pool size of ADMIT_KS, on the
    card (``admit_beam`` through ``fused_admit``, and alone on tables
    already there) and on the host (``_admit_numpy``), with ``score_beam``
    per call; the two paths must admit the same set."""
    from repro_torch.core import admission, scoring
    from repro_torch.core.runtime import RuntimeConfig

    cap = box.cap_array()
    auth = 0.25 * cap
    slack, budget = cap - auth, RuntimeConfig().budget.as_array()
    sc = scoring.Scorer(box, k_max=12, n_max=12, device=device)
    rows = []
    for k in ADMIT_KS:
        hyps, n_tree = _admission_pool(pe, k)
        pb = scoring.pack_beam(hyps, admission.bucket_k(k, sc.k_max), sc.n_max)
        calls = max(3, min(50, 3000 // k))

        def host(calls=calls, hyps=hyps, pb=pb):
            for _ in range(calls):
                res = admission.fused_admit(hyps, sc, slack, budget, auth, packed=pb,
                                            small_beam_threshold=10**9)
            return res

        def dev(calls=calls, hyps=hyps, pb=pb):
            for _ in range(calls):
                res = admission.fused_admit(hyps, sc, slack, budget, auth, packed=pb,
                                            small_beam_threshold=0)
            return res

        want, got = host(1), dev(1)
        if sorted(h.hid for h in got.admitted) != sorted(h.hid for h in want.admitted):
            raise AssertionError(f"K={k}: the device pass admitted "
                                 f"{[h.hid for h in got.admitted]}, the host pass "
                                 f"{[h.hid for h in want.admitted]}")
        t0 = time.perf_counter()
        host()
        host_ms = (time.perf_counter() - t0) / calls * 1e3
        tab = scoring.device_tables(pb, device, w=np.ones(pb.q.shape[0]),
                                    memo_mask=np.zeros_like(pb.node_lat), auth_rho=auth,
                                    cap=cap, limit=np.minimum(slack, budget), lam=sc.lam,
                                    mu=sc.mu, idle_window=8.0, model_delay=0.0,
                                    spec_cost=np.zeros(pb.q.shape[0]), shed_penalty=0.0)
        stab = {k2: v for k2, v in tab.items() if k2 not in ("w", "limit", "auth_rho")}
        stab["admitted_rho"] = tab["auth_rho"]

        def alone(calls=calls, tab=tab):
            for _ in range(calls):
                admission.admit_beam(**tab, n_nodes=sc.n_max)
            if device == "cuda":
                torch.cuda.synchronize()

        def score(calls=calls, stab=stab):
            for _ in range(calls):
                scoring.score_beam(**stab, n_nodes=sc.n_max)
            if device == "cuda":
                torch.cuda.synchronize()

        costly = {h.hid for h, r in zip(hyps, pb.rho, strict=False) if r.any()}
        row = {"K": k, "tree_hyps": n_tree, "admitted": len(got.admitted),
               "admitted_with_demand": sum(h.hid in costly for h in got.admitted),
               "host_numpy_ms": host_ms}
        if device == "cuda":
            for name, fn in (("fused_admit_device", dev), ("admit_beam_alone", alone),
                             ("score_beam", score)):
                wall, dms, kern, copies = _pass_profile(fn, calls)
                row.update({f"{name}_wall_ms": wall, f"{name}_device_ms": dms,
                            f"{name}_kernels": kern, f"{name}_copies": copies})
        else:
            for name, fn in (("fused_admit_device", dev), ("score_beam", score)):
                t0 = time.perf_counter()
                fn()
                row[f"{name}_wall_ms"] = (time.perf_counter() - t0) / calls * 1e3
        print(f"phase R(c) admission pass {json.dumps(row)}", flush=True)
        rows.append(row)
    wins = [r["K"] for r in rows if r["fused_admit_device_wall_ms"] < r["host_numpy_ms"]]
    print(f"phase R(c) pool sizes where the {device} pass beats the host's: {wins}", flush=True)
    return rows


def _recording_steps(steps_mod, record):
    """Wrap ``steps_mod.train_step`` so that each step appends its loss,
    grad norm and wall time (to a synchronised end) to ``record``; returns
    the original."""
    real = steps_mod.train_step

    def recorded(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        record.append({"loss": float(out[2]["loss"]), "grad_norm": float(out[2]["grad_norm"]),
                       "wall_s": time.perf_counter() - t0})
        return out

    steps_mod.train_step = recorded
    return real


def _grad_agreement(got, want):
    """Max |difference| over max |reference| and the cosine of two gradients."""
    g, w = got.float().flatten(), want.float().flatten()
    rel = ((g - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
    cos = (torch.dot(g, w) / (g.norm() * w.norm()).clamp(min=1e-30)).item()
    return rel, cos


def _train_bound_misses(loss, ref_loss, norm, ref_norm, agree):
    """The readings of one step against the oracle path's that fall outside
    ``TRAIN_BOUND``, as [name, reading, limit]."""
    misses = []
    for name, got, ref in (("loss", loss, ref_loss), ("grad_norm", norm, ref_norm)):
        rel = abs(got - ref) / abs(ref)
        if not rel <= TRAIN_BOUND[name]:
            misses.append([name, rel, TRAIN_BOUND[name]])
    for key, (rel, cos) in agree.items():
        if not rel <= TRAIN_BOUND["leaf_rel"]:
            misses.append([f"{key} leaf_rel", rel, TRAIN_BOUND["leaf_rel"]])
        if not cos >= TRAIN_BOUND["leaf_cos"]:
            misses.append([f"{key} leaf_cos", cos, TRAIN_BOUND["leaf_cos"]])
    return misses


# the kernels of a decode step, which a replayed CUDA graph launches past
# their wrappers' counters
DECODE_KERNELS = ("decode_attention", "decode_attention_partials")


def kernel_counters():
    """name -> (module, attribute) of each kernel wrapper's launch count."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    return {"flash_attention": (fa, "launches"), "decode_attention": (da, "launches"),
            "decode_attention_partials": (da, "partials_launches"),
            "ssd_scan": (ssd, "launches"), "flash_attention_bwd": (fa, "bwd_launches"),
            "ssd_scan_bwd": (ssd, "bwd_launches")}


def training_phase(counters=None, launches=None, steps=5, seq_len=128, batch=4, restart_at=2,
                   readings=None):
    """Phase T: full-width musicgen-medium trained on the card through the
    port's training driver (flash forward and backward kernels on the
    path), stopped and resumed from a checkpoint, profiled over one step and
    held against the oracle attention path; then full-width mamba2-2.7b and
    zamba2-1.2b (``ssm_training``); then reduced mamba2-2.7b and granite-8b
    trained 100 steps each, which must learn. Records the training paths'
    launch counts in ``launches``, and in ``readings`` musicgen-medium's
    step: its shape, its device ms from the profiler and the peak device
    memory of its 5-step run (phase X holds the dry-run's terms to them)."""
    counters = kernel_counters() if counters is None else counters
    launches = {} if launches is None else launches
    readings = {} if readings is None else readings
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import train
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import steps as steps_mod

    arch = "musicgen-medium"
    cfg = get_config(arch)
    bwd_per_call = fa.bwd_kernels(cfg.eff_n_heads, cfg.eff_n_kv_heads)
    state_gb = cfg.n_params() * 12 / 1e9
    print(f"phase T {arch}: {cfg.n_layers} layers d_model {cfg.d_model} {cfg.n_params() / 1e9:.3f} "
          f"B params, remat {cfg.remat}; params and grads bf16, m and v f32: {state_gb:.3f} GB of "
          f"training state", flush=True)
    kw = dict(reduced=False, seq_len=seq_len, global_batch=batch, device="cuda", log_every=1)
    record = []
    real = _recording_steps(steps_mod, record)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    print(f"phase T checkpoints under {build}: {shutil.disk_usage(build).free / 1e9:.1f} GB free",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="ckpt_", dir=build) as ckpt_dir:
        try:
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            params, opt_state, losses = train(arch, steps=steps, **kw)
            wall = time.time() - t0
            counts = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
            peak = torch.cuda.max_memory_allocated() / 1e9
            readings[arch] = {"seq_len": seq_len, "batch": batch, "peak_bytes": peak * 1e9}
            for i, r in enumerate(record):
                print(f"phase T {arch} step {i}: {json.dumps(r)}", flush=True)
            print(f"phase T {arch} {steps} steps of {batch} x {seq_len} tokens: "
                  f"{wall:.1f} s wall; peak device memory {peak:.3f} GB "
                  f"(state {state_gb:.3f} GB); launches {counts}", flush=True)
            assert counts["flash_attention"] == 2 * cfg.n_layers * steps, counts  # remat: twice
            assert counts["flash_attention_bwd"] == bwd_per_call * cfg.n_layers * steps, counts
            assert counts["ssd_scan"] == counts["ssd_scan_bwd"] == counts["decode_attention"] == 0
            assert counts["decode_attention_partials"] == 0, counts
            assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in record)
            launches["flash_attention_bwd"] = counts["flash_attention_bwd"]
            launches["flash_attention_train"] = counts["flash_attention"]
            del params, opt_state
            torch.cuda.empty_cache()

            # a run stopped after step `restart_at` (its checkpoint written by
            # the async writer while the loop returns), then a run resumed from
            # it to step `steps`: its losses must be the uninterrupted run's bit
            # for bit, those after the first resumed update included (so the
            # restored m, v and step are held as well as the params). Two
            # checkpoints of 18.2 GB in all: a machine may cap what one run
            # writes to its disk
            record.clear()
            t0 = time.time()
            _, _, first = train(arch, steps=restart_at, ckpt_dir=ckpt_dir, **kw)
            saved = sorted(os.listdir(ckpt_dir))
            t1 = time.time()
            params, opt_state, resumed = train(arch, steps=steps, ckpt_dir=ckpt_dir, **kw)
            print(f"phase T {arch} stopped after step {restart_at} ({t1 - t0:.1f} s, checkpoints "
                  f"{saved}) and resumed to step {steps} ({time.time() - t1:.1f} s): losses "
                  f"{first!r} + {resumed!r} against {losses!r} uninterrupted", flush=True)
            assert saved == [f"step_{restart_at}"], saved
            assert len(resumed) >= 2 and first + resumed == losses, (first, resumed, losses)
        finally:
            steps_mod.train_step = real

    # two more steps: one timed on the host's clock (no checkpoint write in
    # flight), one under torch.profiler; then the model's forward and
    # backward alone under the profiler, so the optimizer's share shows
    dc = DataConfig(seed=0, seq_len=seq_len + 1, global_batch=batch)
    tbatch = [{k: torch.from_numpy(v).cuda() for k, v in batch_at(cfg, dc, i).items()}
              for i in (steps, steps + 1)]
    oc = opt_mod.AdamWConfig(lr=3e-4, total_steps=max(steps, 10), warmup_steps=max(2, steps // 10))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt_state, _ = steps_mod.train_step(params, opt_state, tbatch[0], cfg=cfg, opt_cfg=oc)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    fa_fwd, fa_bwd = fa.launches, fa.bwd_launches

    def traced(fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        assert kernels and sum(e.self_device_time_total for e in kernels) > 0, \
            "the profiler recorded no device time"
        return out, kernels

    (params, opt_state, metrics), kernels = traced(lambda: steps_mod.train_step(
        params, opt_state, tbatch[1], cfg=cfg, opt_cfg=oc))
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    row = {"loss": float(metrics["loss"]), "device_ms": device_ms,
           "kernels": sum(e.count for e in kernels), "wall_ms": wall_ms,
           "busy": device_ms / wall_ms}
    for label, symbol in (("flash_fwd", "flash_attention_bf16_kernel"),
                          ("flash_bwd", "flash_bwd_")):
        mine = [e for e in kernels if symbol in e.key]
        assert mine, f"the trace holds no {symbol} kernel"
        row[f"{label}_ms"] = sum(e.self_device_time_total for e in mine) / 1e3
        row[f"{label}_share"] = row[f"{label}_ms"] / device_ms
        row[f"{label}_kernel_launches"] = sum(e.count for e in mine)
    row["flash_fwd_launches"] = fa.launches - fa_fwd
    row["flash_bwd_launches"] = fa.bwd_launches - fa_bwd
    assert (row["flash_fwd_launches"], row["flash_bwd_launches"]) == (
        2 * cfg.n_layers, bwd_per_call * cfg.n_layers), row
    assert row["flash_bwd_kernel_launches"] == row["flash_bwd_launches"], row
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    row["top"] = [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in top]
    _, fb_kernels = traced(lambda: steps_mod.loss_and_grads(params, cfg, tbatch[1]))
    row["forward_backward_device_ms"] = sum(e.self_device_time_total for e in fb_kernels) / 1e3
    row["forward_backward_kernels"] = sum(e.count for e in fb_kernels)
    readings[arch]["device_ms"] = device_ms
    print(f"phase T {arch} one step (wall from the step before, device from torch.profiler): "
          f"{json.dumps(row)}", flush=True)

    # the same step's gradients through the kernels and through the oracle
    check = tbatch[1]
    ref_cfg = dataclasses.replace(cfg, attn_impl="ref")
    _, m_k, g_k = steps_mod.loss_and_grads(params, cfg, check)
    _, m_r, g_r = steps_mod.loss_and_grads(params, ref_cfg, check)
    n_k, n_r = opt_mod.global_norm(g_k).item(), opt_mod.global_norm(g_r).item()
    loss_k, loss_r = float(m_k["loss"]), float(m_r["loss"])
    layers = (0, cfg.n_layers // 2, cfg.n_layers - 1)
    agree = {f"{w}[{i}]": _grad_agreement(g_k["blocks"][i]["attn"][w], g_r["blocks"][i]["attn"][w])
             for i in layers for w in ("wq", "wk", "wv")}
    print(f"phase T {arch} one step, kernels against the oracle path (attn_impl='ref'): loss "
          f"{loss_k!r} / {loss_r!r}, grad_norm {n_k!r} / {n_r!r}; per leaf (max |diff| / max "
          f"|ref|, cosine): {json.dumps(agree)}", flush=True)
    misses = _train_bound_misses(loss_k, loss_r, n_k, n_r, agree)
    assert not misses, misses

    # the control: the backward kernel fed a zero o, so that dS = P dP with
    # no delta, a wrong gradient, must fall outside the bound
    real_bwd = fa.flash_attention_bwd_kernel
    fa.flash_attention_bwd_kernel = (
        lambda q, k, v, o, *a, **kw: real_bwd(q, k, v, torch.zeros_like(o), *a, **kw))
    try:
        _, m_c, g_c = steps_mod.loss_and_grads(params, cfg, check)
    finally:
        fa.flash_attention_bwd_kernel = real_bwd
    n_c, loss_c = opt_mod.global_norm(g_c).item(), float(m_c["loss"])
    agree_c = {f"{w}[{i}]": _grad_agreement(g_c["blocks"][i]["attn"][w], g_r["blocks"][i]["attn"][w])
               for i in layers for w in ("wq", "wk", "wv")}
    misses = _train_bound_misses(loss_c, loss_r, n_c, n_r, agree_c)
    print(f"phase T {arch} control, the backward without delta, against the oracle path: loss "
          f"{loss_c!r}, grad_norm {n_c!r}; per leaf {json.dumps(agree_c)}; outside TRAIN_BOUND: "
          f"{json.dumps(misses)}", flush=True)
    assert misses, "a backward without delta passed TRAIN_BOUND"
    # phase S: one more step, where no sync may happen
    sync_checked(f"{arch} train_step ({batch} x {seq_len})", lambda: steps_mod.train_step(
        params, opt_state, tbatch[0], cfg=cfg, opt_cfg=oc))
    del params, opt_state, g_k, g_r, g_c
    torch.cuda.empty_cache()

    # the Mamba2 and hybrid families at full width, through SsdScanFn
    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        ssm_training(arch, counters, launches)

    # reduced mamba2-2.7b, 100 steps (P 32, N 16, chunk 32 at seq 64: two chunks)
    from repro_torch.kernels import ssd_scan as ssd
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.time()
    _, _, losses = train("mamba2-2.7b", reduced=True, steps=100, seq_len=64, global_batch=8,
                         lr=3e-3, device="cuda", log_every=0)
    counts = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    print(f"phase T mamba2-2.7b reduced, 100 steps: loss {losses[0]!r} -> {losses[-1]!r} in "
          f"{time.time() - t0:.1f} s; launches {counts}", flush=True)
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    small = get_config("mamba2-2.7b").reduced()
    assert not small.remat and counts["ssd_scan"] == small.n_layers * 100, counts
    assert counts["ssd_scan_bwd"] == ssd.BWD_KERNELS * small.n_layers * 100, counts
    assert counts["flash_attention"] == counts["flash_attention_bwd"] == 0, counts

    # reduced granite-8b, 100 steps: the twin of test_training_reduces_loss
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.time()
    _, _, losses = train("granite-8b", reduced=True, steps=100, seq_len=64, global_batch=8,
                         lr=3e-3, device="cuda", log_every=0)
    counts = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    print(f"phase T granite-8b reduced, 100 steps: loss {losses[0]!r} -> {losses[-1]!r} in "
          f"{time.time() - t0:.1f} s; launches {counts}", flush=True)
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    small = get_config("granite-8b").reduced()
    assert counts["flash_attention"] == small.n_layers * 100, counts
    assert counts["flash_attention_bwd"] == fa.bwd_kernels(
        small.eff_n_heads, small.eff_n_kv_heads) * small.n_layers * 100, counts


def _loss_with_ssd(steps_mod, params, cfg, batch, ssd_fn=None):
    """The loss of ``batch``, forward only, with every SSD scan through
    ``ssd_fn`` (ops.ssd_scan's signature; None: ops.ssd_scan itself)."""
    from repro_torch.kernels import ops
    real = ops.ssd_scan
    ops.ssd_scan = ssd_fn or real
    try:
        with torch.no_grad():
            return float(steps_mod.loss_fn(params, cfg, batch)[1]["loss"])
    finally:
        ops.ssd_scan = real


def _ssd_plain_at(at):
    """ops.ssd_scan through ssd_scan_plain at chunk length ``at``."""
    from repro_torch.kernels import ssd_scan as ssd

    def scan(x, dt, A, B, C, D, *, chunk, impl=None, initial_state=None):
        return ssd.ssd_scan_plain(x, dt, A, B, C, D, chunk=at, initial_state=initial_state)
    return scan


def _ssd_chained(x, dt, A, B, C, D, *, chunk, impl=None, initial_state=None):
    """ops.ssd_scan through ssd_scan_chained_plain (the forward kernel's
    algorithm and bf16 rounding points in PyTorch)."""
    from repro_torch.kernels import ssd_scan as ssd
    return ssd.ssd_scan_chained_plain(x, dt, A, B, C, D, chunk=chunk, initial_state=initial_state)


def _ssd_state_dropped(x, dt, A, B, C, D, *, chunk, impl=None, initial_state=None):
    """A wrong SSD, the f32 loss check's control: ssd_scan_plain chunk after
    chunk, each chunk from a zero state (the state is dropped between
    chunks)."""
    from repro_torch.kernels import ssd_scan as ssd
    ys, final = [], None
    for s0 in range(0, x.shape[1], chunk):
        cut = slice(s0, s0 + chunk)
        y, final = ssd.ssd_scan_plain(x[:, cut], dt[:, cut], A, B[:, cut], C[:, cut], D,
                                      chunk=chunk, initial_state=initial_state if s0 == 0 else None)
        ys.append(y)
    return torch.cat(ys, dim=1), final


def ssm_training(arch, counters, launches, steps=3, seq_len=512, batch=4):
    """Full-width ``arch`` (mamba2-2.7b or zamba2-1.2b: remat, bf16, random
    weights from seed 0) trained ``steps`` steps of batch x seq_len tokens
    through launch/train.py: the SSD forward kernel twice a layer (remat)
    and its backward once through SsdScanFn, and for the hybrid's shared
    attention (not remat'd) the flash kernels; each step's loss, grad norm
    and wall, the peak device memory against the training state, one more
    step timed on the host's clock and the next under torch.profiler. Then,
    with the optimizer state freed, that step's gradients through the
    kernels against the oracle path (attn_impl="ref": the sequential SSD
    recurrence and the materialized attention): the grad norm and the
    w_x, w_B, w_C, w_dt, A_log and D leaves of layers 0, n / 2 and n - 1
    (and the hybrid's shared wq, wk, wv) within ``TRAIN_BOUND``; the bf16
    loss gap printed, not held, beside the same forward's with the SSD
    through ssd_scan_plain at chunk 64, 128 and 256 and through
    ssd_scan_chained_plain (its spread at this depth, PERF.md); the loss
    held in f32 instead (the trained parameters and the config in float32,
    forward only: the kernels' path, the f32 SSD and flash kernels, against
    the oracle's) within the loss limit, with a control that must miss it
    (each SSD's state dropped between chunks); and a control, the backward
    kernel with the decays' cotangent dropped (dcs = 0), whose A_log and
    w_dt leaves must fall outside the bound. No checkpoint is written."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.train import train
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import steps as steps_mod

    cfg = get_config(arch)
    n_attn = sum(M._shared_attn_index(cfg, i) is not None for i in range(cfg.n_layers)) \
        if cfg.family == "hybrid" else 0
    state_gb = cfg.n_params() * 12 / 1e9
    print(f"phase T {arch}: {cfg.n_layers} Mamba2 layers, {n_attn} shared attention "
          f"applications, d_model {cfg.d_model}, {cfg.n_params() / 1e9:.3f} B params, remat "
          f"{cfg.remat}; params and grads bf16, m and v f32: {state_gb:.3f} GB of training state",
          flush=True)
    record = []
    real = _recording_steps(steps_mod, record)
    try:
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        params, opt_state, _ = train(arch, reduced=False, steps=steps, seq_len=seq_len,
                                     global_batch=batch, device="cuda", log_every=1)
        wall = time.time() - t0
        counts = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    finally:
        steps_mod.train_step = real
    peak = torch.cuda.max_memory_allocated() / 1e9
    for i, r in enumerate(record):
        print(f"phase T {arch} step {i}: {json.dumps(r)}", flush=True)
    print(f"phase T {arch} {steps} steps of {batch} x {seq_len} tokens: {wall:.1f} s wall; peak "
          f"device memory {peak:.3f} GB (state {state_gb:.3f} GB); launches {counts}", flush=True)
    assert cfg.remat and len(record) == steps
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in record), record
    assert counts["ssd_scan"] == 2 * cfg.n_layers * steps, counts            # remat: twice
    assert counts["ssd_scan_bwd"] == ssd.BWD_KERNELS * cfg.n_layers * steps, counts
    assert counts["flash_attention"] == n_attn * steps, counts               # not remat'd
    assert counts["flash_attention_bwd"] == fa.bwd_kernels(
        cfg.eff_n_heads, cfg.eff_n_kv_heads) * n_attn * steps, counts
    assert counts["decode_attention"] == counts["decode_attention_partials"] == 0, counts
    launches["ssd_scan_bwd"] = launches.get("ssd_scan_bwd", 0) + counts["ssd_scan_bwd"]
    launches["ssd_scan_train"] = launches.get("ssd_scan_train", 0) + counts["ssd_scan"]

    dc = DataConfig(seed=0, seq_len=seq_len + 1, global_batch=batch)
    tbatch = [{k: torch.from_numpy(v).cuda() for k, v in batch_at(cfg, dc, i).items()}
              for i in (steps, steps + 1)]
    oc = opt_mod.AdamWConfig(lr=3e-4, total_steps=max(steps, 10), warmup_steps=max(2, steps // 10))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt_state, _ = steps_mod.train_step(params, opt_state, tbatch[0], cfg=cfg, opt_cfg=oc)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        params, opt_state, metrics = steps_mod.train_step(params, opt_state, tbatch[1], cfg=cfg,
                                                          opt_cfg=oc)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    assert device_ms > 0, "the profiler recorded no device time"
    row = {"loss": float(metrics["loss"]), "device_ms": device_ms,
           "kernels": sum(e.count for e in kernels), "wall_ms": wall_ms,
           "busy": device_ms / wall_ms}
    named = [("ssd_fwd", "ssd_scan_kernel", 2 * cfg.n_layers),
             ("ssd_bwd", "ssd_bwd_", ssd.BWD_KERNELS * cfg.n_layers)]
    if n_attn:
        named += [("flash_fwd", "flash_attention_bf16_kernel", n_attn),
                  ("flash_bwd", "flash_bwd_", fa.bwd_kernels(cfg.eff_n_heads,
                                                             cfg.eff_n_kv_heads) * n_attn)]
    for label, symbol, want in named:
        mine = [e for e in kernels if symbol in e.key]
        row[f"{label}_ms"] = sum(e.self_device_time_total for e in mine) / 1e3
        row[f"{label}_share"] = row[f"{label}_ms"] / device_ms
        row[f"{label}_launches"] = sum(e.count for e in mine)
        assert row[f"{label}_launches"] == want, (label, row)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    row["top"] = [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in top]
    print(f"phase T {arch} one step (wall from the step before, device from torch.profiler): "
          f"{json.dumps(row)}", flush=True)

    # the same step's gradients through the kernels and through the oracle,
    # with the optimizer state freed for the oracle's saved recurrence
    del opt_state
    torch.cuda.empty_cache()
    check = tbatch[1]
    layers = (0, cfg.n_layers // 2, cfg.n_layers - 1)

    def leaves(grads):
        out = {f"{w}[{i}]": grads["blocks"][i]["ssm"][w] for i in layers
               for w in ("w_x", "w_B", "w_C", "w_dt", "A_log", "D")}
        if n_attn:
            out.update({f"shared {w}": grads["shared_attn"]["attn"][w] for w in ("wq", "wk", "wv")})
        return out

    torch.cuda.reset_peak_memory_stats()
    _, m_k, g_k = steps_mod.loss_and_grads(params, cfg, check)
    lv_k = leaves(g_k)
    n_k, loss_k = opt_mod.global_norm(g_k).item(), float(m_k["loss"])
    del g_k
    t0 = time.time()
    _, m_r, g_r = steps_mod.loss_and_grads(params, dataclasses.replace(cfg, attn_impl="ref"), check)
    oracle_s = time.time() - t0
    lv_r = leaves(g_r)
    n_r, loss_r = opt_mod.global_norm(g_r).item(), float(m_r["loss"])
    del g_r
    agree = {key: _grad_agreement(lv_k[key], lv_r[key]) for key in lv_k}
    print(f"phase T {arch} one step, kernels against the oracle path (attn_impl='ref', "
          f"{oracle_s:.1f} s, peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB): loss "
          f"{loss_k!r} / {loss_r!r}, grad_norm {n_k!r} / {n_r!r}; per leaf (max |diff| / max "
          f"|ref|, cosine): {json.dumps(agree)}", flush=True)
    # the bf16 loss gap is a reading, held in f32 below
    misses = [m for m in _train_bound_misses(loss_k, loss_r, n_k, n_r, agree) if m[0] != "loss"]
    assert not misses, misses

    # the bf16 loss reading beside its spread: the same forward through other
    # correct SSDs (f32 chunked at three chunk lengths, the forward kernel's
    # algorithm in PyTorch), all forward only, in this run
    losses = {"kernels": loss_k, "oracle": loss_r}
    losses.update({f"plain{q}": _loss_with_ssd(steps_mod, params, cfg, check, _ssd_plain_at(q))
                   for q in (64, 128, 256)})
    losses["chained"] = _loss_with_ssd(steps_mod, params, cfg, check, _ssd_chained)
    gaps = {k: abs(v - loss_r) / abs(loss_r) for k, v in losses.items() if k != "oracle"}
    print(f"phase T {arch} bf16 loss against the oracle, a reading (its limit is held in f32): "
          f"losses {json.dumps(losses)}; gaps {json.dumps(gaps)}; the correct SSDs' spread "
          f"{min(v for k, v in gaps.items() if k != 'kernels')!r} to "
          f"{max(v for k, v in gaps.items() if k != 'kernels')!r}", flush=True)

    # the loss held in f32: the trained parameters and the config in float32,
    # forward only, the kernels' path (the f32 SSD kernel, zamba2's f32 flash)
    # against the oracle's; a control with each SSD's state dropped between
    # chunks must miss the limit
    from repro_torch.tree import tree_map
    params32 = tree_map(lambda t: t.float(), params)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    loss32_k = _loss_with_ssd(steps_mod, params32, cfg32, check)
    loss32_r = _loss_with_ssd(steps_mod, params32, dataclasses.replace(cfg32, attn_impl="ref"),
                              check)
    loss32_c = _loss_with_ssd(steps_mod, params32, cfg32, check, _ssd_state_dropped)
    gap32, gap32_c = abs(loss32_k - loss32_r) / abs(loss32_r), abs(loss32_c - loss32_r) / abs(loss32_r)
    print(f"phase T {arch} f32 loss against the oracle (limit {TRAIN_BOUND['loss']}): kernels "
          f"{loss32_k!r} / oracle {loss32_r!r}, gap {gap32!r}; control, each SSD's state dropped "
          f"between chunks: {loss32_c!r}, gap {gap32_c!r}", flush=True)
    assert gap32 <= TRAIN_BOUND["loss"], ("f32 loss", gap32, TRAIN_BOUND["loss"])
    assert gap32_c > TRAIN_BOUND["loss"], ("the state-dropping control passed", gap32_c)
    del params32
    torch.cuda.empty_cache()

    # the control: the backward kernel with the decays' cotangent dropped
    real_bwd = ssd.ssd_scan_bwd_kernel
    ssd.ssd_scan_bwd_kernel = lambda *a, **kw: real_bwd(*a, **kw, drop_decay_grad=True)
    try:
        _, m_c, g_c = steps_mod.loss_and_grads(params, cfg, check)
    finally:
        ssd.ssd_scan_bwd_kernel = real_bwd
    lv_c = leaves(g_c)
    n_c, loss_c = opt_mod.global_norm(g_c).item(), float(m_c["loss"])
    del g_c
    agree_c = {key: _grad_agreement(lv_c[key], lv_r[key]) for key in lv_c}
    misses = _train_bound_misses(loss_c, loss_r, n_c, n_r, agree_c)
    print(f"phase T {arch} control, the backward without the decays' cotangent, against the "
          f"oracle path: loss {loss_c!r}, grad_norm {n_c!r}; per leaf {json.dumps(agree_c)}; "
          f"outside TRAIN_BOUND: {json.dumps(misses)}", flush=True)
    missed = {m[0].split(" ")[0] for m in misses}
    assert all(f"{w}[{i}]" in missed for i in layers for w in ("A_log", "w_dt")), \
        f"the backward without the decays' cotangent passed TRAIN_BOUND on A_log or w_dt: {misses}"
    del params, lv_k, lv_r, lv_c
    torch.cuda.empty_cache()


# phase X: the dry-run's CLI cells (decode: one token a step, so that each
# traces in seconds), each in a process of its own, since the fake default
# process group is a one-way step for its process
DRYRUN_CELLS = (("qwen2-7b", "decode_32k", "single"), ("qwen3-moe-30b-a3b", "decode_32k", "multi"))


def dryrun_phase(readings, timeout=80):
    """Phase X: the dry-run tooling (``launch/dryrun.py``), which needs no
    card and launches no kernel. (a) The CLI on ``DRYRUN_CELLS``, each laid
    out on its production mesh of 256 or 512 ranks over a fake process
    group in a subprocess of its own: each must give status ok; its terms
    and per-device bytes are printed. (b) Meanwhile, in this process, phase
    T's musicgen-medium step (``readings``) counted on meta tensors on one
    device (``dryrun.count_unsharded``): its FLOPs, compute and memory terms
    beside phase T's device ms, which must be at least the larger term (a
    roofline is a lower bound), and phase T's peak memory, which must be at
    least the dry-run's state bytes."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"), OMP_NUM_THREADS="1")
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                               "--shape", shape, "--mesh", mesh, "--out-dir", out_dir],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for arch, shape, mesh in DRYRUN_CELLS]
    try:
        arch = "musicgen-medium"
        seen = readings[arch]
        shape = ShapeConfig("train_4x128", "train", seen["seq_len"], seen["batch"])
        res = dryrun.count_unsharded(arch, shape)
        terms_ms = {k: v * 1e3 for k, v in res["terms"].items()}
        largest = max(terms_ms.values())
        row = {"flops": res["counter"].flops, "model_flops": dryrun.model_flops(res["cfg"], shape),
               "compute_ms": terms_ms["compute"], "memory_ms": terms_ms["memory"],
               "traffic_bytes": res["traffic"], "device_ms": seen["device_ms"],
               "measured_over_largest_term": seen["device_ms"] / largest,
               "state_bytes": res["state_bytes"], "peak_bytes": seen["peak_bytes"],
               "peak_over_state": seen["peak_bytes"] / res["state_bytes"],
               "trace_s": res["trace_s"]}
        print(f"phase X(b) {arch} {shape.global_batch} x {shape.seq_len} train step counted on "
              f"meta (one device) beside phase T: {json.dumps(row)}", flush=True)
        assert seen["device_ms"] >= largest, row
        assert seen["peak_bytes"] >= res["state_bytes"], row
        outs = [p.communicate(timeout=max(1.0, timeout - (time.time() - t0))) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (arch, shape, mesh), p, (stdout, stderr) in zip(DRYRUN_CELLS, procs, outs, strict=True):
        path = os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")
        assert p.returncode == 0 and os.path.exists(path), (stdout, stderr[-3000:])
        with open(path) as f:
            rec = json.load(f)
        assert rec["status"] == "ok", rec.get("error")
        keys = ("devices", "trace_s", "param_bytes_per_device", "state_bytes_per_device",
                "cache_bytes_per_device", "flops_per_device", "compute_term_s", "memory_term_s",
                "collective_term_s", "bottleneck", "attn_impl")
        print(f"phase X(a) dryrun --arch {arch} --shape {shape} --mesh {mesh}: status ok "
              f"{json.dumps({k: rec[k] for k in keys})}", flush=True)
    print(f"phase X: {time.time() - t0:.1f} s", flush=True)


def runtime_phase(device="cuda"):
    """Phase R: the B-PASTE runtime of the port. (a) the speculative-serving
    demos with their asserts; (b) the serve-box cell at c = 256 on the host
    path, with every pool above 2 on the card, and the same on the CPU
    (the three must agree outside the wall-clock keys), and the reference
    greedy at c = 3 on the card against the fused pass; (c) the times of
    one admission pass."""
    from repro_torch.core import admission, scoring
    from repro_torch.core import runtime as rt
    from repro_torch.core.events import ResourceVector
    from repro_torch.core.interference import Machine
    from repro_torch.core.patterns import PatternEngine
    from repro_torch.core.runtime import run_mode
    from repro_torch.core.workload import WorkloadConfig, episodes_to_traces, make_episodes
    from repro_torch.launch.speculative_serving import run_edge_box_demo, run_open_loop_demo

    t0 = time.time()
    run_edge_box_demo(device=device)
    run_open_loop_demo(device=device)
    print(f"phase R(a) demos: {time.time() - t0:.1f} s", flush=True)

    def engine(n):
        return PatternEngine(context_len=2, min_support=3).fit(
            episodes_to_traces(make_episodes(WorkloadConfig(seed=1, n_episodes=n))))

    pe20, pe60 = engine(20), engine(60)
    box = Machine(ResourceVector(cpu=24, mem_bw=200, io=1000, accel=8))
    passes, pools = {}, []
    real = _counting(admission, "admit_beam", passes)
    real_fused = rt.fused_admit

    def pooled(hyps, *args, **kw):
        res = real_fused(hyps, *args, **kw)
        rho = kw["memo_rho"] if kw.get("memo_rho") is not None else \
            [scoring.prefix_rho(h) for h in hyps]
        picked = {h.hid for h in res.admitted}
        pools.append((len(hyps), len(picked),
                      sum(h.hid in picked and bool(np.any(r)) for h, r in zip(hyps, rho,
                                                                            strict=True))))
        return res

    rt.fused_admit = pooled
    runs = []
    try:
        for label, kw in (("host path", {}),
                          (f"host_admit_max=2 on {device}", dict(host_admit_max=2, device=device)),
                          ("host_admit_max=2 on cpu", dict(host_admit_max=2, device="cpu"))):
            passes.clear()
            s, wall = _serve_box_cell(run_mode, pe20, box, 256, **kw)
            runs.append((s, dict(passes)))
            print(f"phase R(b) serve box c=256 {label}: makespan {float(s['makespan'])!r} "
                  f"admission passes {s['sched_admit_calls']} (admit_beam by device: {passes}) "
                  f"sched_us_per_admit {s['sched_us_per_admit']:.1f} sched_us_per_tick "
                  f"{s['sched_us_per_tick']:.1f} wall {wall:.2f} s", flush=True)
    finally:
        admission.admit_beam = real
        rt.fused_admit = real_fused
    (s1, p1), (s2, p2), (s3, p3) = runs
    assert not p1 and p2.get(device, 0) > 0 and p3.get("cpu", 0) > 0, (p1, p2, p3)
    _same_summary(s2, s3, f"c=256 on {device} against the cpu")
    _same_summary(s2, s1, f"c=256 on {device} against the host path")
    print(f"phase R(b) c=256: the three runs agree on {len(_strip(s1))} summary keys; "
          f"sched_us_per_admit {s2['sched_us_per_admit']:.1f} ({device} path) against "
          f"{s1['sched_us_per_admit']:.1f} (host path)", flush=True)
    sizes = [n for n, _, _ in pools]
    big = [(a, d) for n, a, d in pools if n > 2]
    print(f"phase R(b) c=256 fused_admit calls over the three runs: {len(pools)}; pool largest "
          f"{max(sizes)}, mean {sum(sizes) / len(sizes):.1f}, above 512 (the default "
          f"host_admit_max): {sum(n > 512 for n in sizes)}; in the {len(big)} with more than 2 "
          f"candidates, admitted per call {sum(a for a, _ in big) / len(big):.2f}, of them with "
          f"demand {sum(d for _, d in big) / len(big):.2f}", flush=True)

    thor = Machine(ResourceVector(cpu=6, mem_bw=50, io=200, accel=1))
    eps = make_episodes(WorkloadConfig(seed=11, n_episodes=6))
    scored = {}
    real = _counting(scoring, "score_beam", scored)
    try:
        mf = run_mode(eps, pe60, "bpaste", thor, seed=7, max_concurrent_episodes=3,
                      admission="fused", device=device)
        mr = run_mode(eps, pe60, "bpaste", thor, seed=7, max_concurrent_episodes=3,
                      admission="reference", device=device)
    finally:
        scoring.score_beam = real
    assert scored.get(device, 0) > 0, scored
    assert abs(mf.makespan - mr.makespan) <= 1e-9 * abs(mr.makespan), (mf.makespan, mr.makespan)
    assert (mf.reuses, mf.promotions) == (mr.reuses, mr.promotions)
    print(f"phase R(b) c=3 reference on {device} ({scored} score_beam calls) against fused: "
          f"makespan {float(mr.makespan)!r} and {float(mf.makespan)!r}, reuses {mr.reuses}, "
          f"promotions {mr.promotions}", flush=True)

    admission_times(pe20, box, device)
    print(f"phase R: {time.time() - t0:.1f} s", flush=True)


def sync_phase(k=96):
    """Phase S's own part (its decode, prefill and train calls ran in phases
    3 and T): the port's checker, one score_beam on the card under
    set_sync_debug_mode("error"), and the control, one forced-device
    admit_beam pass on the same tables under "warn", whose sync warnings
    must all sit at the line of the site the checker baselines."""
    import tempfile

    from repro_torch import staticcheck
    from repro_torch.core import admission, scoring
    from repro_torch.core.events import ResourceVector
    from repro_torch.core.interference import Machine
    from repro_torch.core.patterns import PatternEngine
    from repro_torch.core.runtime import RuntimeConfig
    from repro_torch.core.workload import WorkloadConfig, episodes_to_traces, make_episodes

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "staticcheck.json")
        rc = staticcheck.main(["--strict", "--json", path])
        with open(path) as fh:
            rep = json.load(fh)
    meta, base = rep["meta"], rep["meta"].get("baselined", [])
    print(f"phase S staticcheck --strict: rc {rc}, {meta['files_checked']} files checked, "
          f"{len(rep['findings'])} findings, {meta['functions_reached']} functions reached from "
          f"{len(staticcheck.CAPTURE_SCOPES)} capture scopes, baselined "
          f"{[(b['rule'], b['site']) for b in base]}", flush=True)
    assert rc == 0 and not rep["findings"], rep["findings"]
    synced = [b for b in base if b["rule"] == "C2-sync"]
    assert [b["site"] for b in synced] == ["core/admission.py:admit_beam"], synced
    line = int(synced[0]["detail"].split(":")[0].split()[1])        # "line N: ..."

    pe = PatternEngine(context_len=2, min_support=3).fit(
        episodes_to_traces(make_episodes(WorkloadConfig(seed=1, n_episodes=20))))
    box = Machine(ResourceVector(cpu=24, mem_bw=200, io=1000, accel=8))
    cap = box.cap_array()
    auth = 0.25 * cap
    slack, budget = cap - auth, RuntimeConfig().budget.as_array()
    sc = scoring.Scorer(box, k_max=12, n_max=12, device="cuda")
    hyps, _ = _admission_pool(pe, k)
    pb = scoring.pack_beam(hyps, admission.bucket_k(k, sc.k_max), sc.n_max)
    tab = scoring.device_tables(pb, "cuda", w=np.ones(pb.q.shape[0]),
                                memo_mask=np.zeros_like(pb.node_lat), auth_rho=auth, cap=cap,
                                limit=np.minimum(slack, budget), lam=sc.lam, mu=sc.mu,
                                idle_window=8.0, model_delay=0.0,
                                spec_cost=np.zeros(pb.q.shape[0]), shed_penalty=0.0)
    stab = {k2: v for k2, v in tab.items() if k2 not in ("w", "limit", "auth_rho")}
    stab["admitted_rho"] = tab["auth_rho"]
    scoring.score_beam(**stab, n_nodes=sc.n_max)                    # warm-up
    sync_checked(f"score_beam at K={k}", lambda: scoring.score_beam(**stab, n_nodes=sc.n_max))
    admission.admit_beam(**tab, n_nodes=sc.n_max)                   # warm-up
    (admitted, _, _), syncs = under_sync_mode(
        "warn", lambda: admission.admit_beam(**tab, n_nodes=sc.n_max))
    costly = int(((admitted > 0) & (tab["rho"] != 0).any(dim=1)).sum())
    at = sorted({(os.path.relpath(w.filename, os.path.dirname(os.path.abspath(__file__))),
                  w.lineno) for w in syncs})
    print(f"phase S control: admit_beam at K={k} on the card under set_sync_debug_mode('warn'): "
          f"{len(syncs)} sync warnings at {at}; picks with demand {costly} (+ 1: the loop's "
          f"iterations); the checker's baseline names line {line}", flush=True)
    assert syncs, "the forced-device admission pass raised no sync warning"
    assert all(w.filename.endswith(os.path.join("core", "admission.py")) and w.lineno == line
               for w in syncs), at
    assert len(syncs) == costly + 1, (len(syncs), costly)
    print(f"phase S: {len(SYNC_CHECKED)} calls under set_sync_debug_mode('error') without a "
          f"sync: {json.dumps(SYNC_CHECKED)}; this part {time.time() - t0:.1f} s", flush=True)


# ---- phase D: multi-device over torch.distributed, ranks that share the card ----

D_RANKS = 4


def _card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def _d_print(rank, what, row):
    """One JSON line of phase D, printed by rank 0."""
    if rank == 0:
        print(f"phase D {what}: {json.dumps(row)}", flush=True)


def _d_gather(row):
    """Every rank's ``row``, in rank order, on every rank."""
    import torch.distributed as dist
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, row)
    return rows


def _d_shared(rank, queue, make):
    """Rank 0 makes a tree on the card and hands it to every other rank by
    CUDA IPC through ``queue`` (one copy on the card, mapped by all)."""
    import torch.distributed as dist
    if rank == 0:
        tree = make()
        torch.cuda.synchronize()
        for _ in range(dist.get_world_size() - 1):
            queue.put(tree)
        return tree
    return queue.get()


def _d_release(rank, what):
    """After every rank has dropped its references to a shared tree: the
    memory goes back to the card (rank 0, which made it, frees it last),
    and every rank holds less than 1 GB."""
    import gc

    import torch.distributed as dist
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    dist.barrier()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    held = _d_gather(torch.cuda.memory_allocated() / 1e9)
    _d_print(rank, f"{what} released, GB allocated per rank", held)
    assert max(held) < 1.0, held


def _d_lsm(lg, cfg):
    return torch.log_softmax(lg[:, :cfg.vocab_size].float(), dim=-1)


def _d_decode(M, params, cfg, prompt, mesh_info, steps, feed=None):
    """A prefill of ``prompt`` then ``steps`` decode steps (of ``feed``, or
    greedy): the log-softmax of every step's logits and the tokens fed."""
    dev = params["embed"].device
    lg, cache = M.prefill(params, cfg, {"tokens": torch.tensor([prompt], device=dev)},
                          max_len=192, mesh_info=mesh_info)
    out, fed = [_d_lsm(lg, cfg)], []
    for i in range(steps):
        tok = torch.argmax(lg, -1) if feed is None else torch.tensor([feed[i]], device=dev)
        fed.append(int(tok[0]))
        lg, cache = M.decode_step(params, cfg, cache, tok, mesh_info=mesh_info)
        out.append(_d_lsm(lg, cfg))
    return torch.cat(out), fed


def _d_max_diff(a, b):
    return (a - b).abs().max().item()


def _phase_d_ranks(rank, mesh, queue, ckpt_dir):
    """D1, D2 and D4 on one rank of a (1, 4) mesh of ranks sharing the card."""
    import torch.distributed as dist

    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.configs import get_config
    from repro_torch.core.patterns import PatternEngine
    from repro_torch.core.workload import WorkloadConfig, episodes_to_traces, make_episodes
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_dist_mesh, make_local_mesh
    from repro_torch.launch.serve import serve_agent_loop
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.training import optimizer as opt_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    counters = kernel_counters()
    mi = M.mesh_context(mesh)
    launches = {name: 0 for name in counters}

    def zero():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        mesh.counts.update(collectives=0, staged_copies=0)

    def read():
        return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}

    # ---- D1: qwen2-7b at full width, the cache sequence-sharded over 4 ranks
    cfg = get_config("qwen2-7b")
    t0 = time.time()
    params = _d_shared(rank, queue, lambda: M.init_params(
        cfg, torch.Generator(device=mesh.device).manual_seed(SEED), device=mesh.device))
    _d_print(rank, f"D1 {cfg.name} weights shared by CUDA IPC", {
        "params_gb": sum(t.numel() * t.element_size() for t in _tensors(params)) / 1e9,
        "seconds": time.time() - t0})
    pe = PatternEngine(context_len=2, min_support=3).fit(
        episodes_to_traces(make_episodes(WorkloadConfig(seed=1, n_episodes=40))))
    episodes = make_episodes(WorkloadConfig(seed=9, n_episodes=1))
    bound = None
    for kv in ("bfloat16", "int8"):
        c = dataclasses.replace(cfg, sharded_decode_attn=True, kv_cache_dtype=kv)
        eng = ServingEngine(c, params, max_batch=4, max_len=192, mesh_info=mi,
                            device=mesh.device)
        leaf = eng.cache["k"][0] if kv == "int8" else eng.cache["k"]
        assert leaf.shape[2] == 192 // D_RANKS, leaf.shape       # this rank's slice
        if kv == "bfloat16":                 # warm-up, once
            serve_agent_loop(False, c, eng, episodes, pe, reason_tokens=1)
        zero()
        steps0 = eng.steps_executed
        dt, _, hits, spec = serve_agent_loop(True, c, eng, episodes, pe)
        torch.cuda.synchronize()
        n = eng.steps_executed - steps0
        counts = read()
        for name in ("decode_attention_partials", "flash_attention"):
            launches[name] += counts[name]
        row = {"rank": rank, "engine_steps": n, "launches": counts,
               "partials_launches_per_step": counts["decode_attention_partials"] / n,
               "collectives_per_step": mesh.counts["collectives"] / n,
               "staged_copies_per_step": mesh.counts["staged_copies"] / n,
               "host_ms_per_step": dt / n * 1e3,
               "summary": [n, spec.admitted, spec.promotions, spec.preemptions, hits],
               "tokens": [list(s.tokens) for s in eng.slots]}
        rows = _d_gather(row)
        for r in rows:
            _d_print(rank, f"D1 {cfg.name} sharded x{D_RANKS} ranks, {kv} cache, agent loop",
                     {k: v for k, v in r.items() if k != "tokens"})
            assert r["launches"]["decode_attention_partials"] == cfg.n_layers * n > 0, r
            assert r["launches"]["decode_attention"] == 0, r
            assert r["collectives_per_step"] == 3 * cfg.n_layers, r
            assert r["staged_copies_per_step"] == 0, r
            assert r["summary"] == rows[0]["summary"] and r["tokens"] == rows[0]["tokens"], r
        assert spec.admitted > 0, "speculation admitted no slot"
        del eng, spec        # the speculator holds the engine, which holds the weights

        # the logits of a 100-token prompt (its keys on 3 of the 4 ranks' slices)
        # and 6 greedy steps, against the single-process paths on rank 0
        lsm, fed = _d_decode(M, params, c, list(range(5, 105)), mi, 6)
        if rank == 0:
            local = M.mesh_context(make_local_mesh(D_RANKS, device=mesh.device))
            plain = dataclasses.replace(c, sharded_decode_attn=False)
            lsm_local, _ = _d_decode(M, params, c, list(range(5, 105)), local, 6, fed)
            lsm_plain, _ = _d_decode(M, params, plain, list(range(5, 105)), None, 6, fed)
            if bound is None:     # phase 4's bound: the unsharded bf16 kernels against the oracle
                ref = dataclasses.replace(cfg, attn_impl="ref")
                lsm_ref, _ = _d_decode(M, params, ref, list(range(5, 105)), None, 6, fed)
                lsm_bf16, _ = _d_decode(M, params, cfg, list(range(5, 105)), None, 6, fed)
                bound = _d_max_diff(lsm_bf16, lsm_ref)
            errs = {"vs LocalMesh sharded": _d_max_diff(lsm, lsm_local),
                    "vs unsharded": _d_max_diff(lsm, lsm_plain), "bound": bound}
            _d_print(rank, f"D1 {cfg.name} {kv} cache, max |log-softmax difference| over a "
                           f"100-token prefill and 6 steps", errs)
            assert max(errs["vs LocalMesh sharded"], errs["vs unsharded"]) <= bound, errs
        dist.barrier()
    del params
    _d_release(rank, f"D1 {cfg.name} weights")

    # ---- D2: qwen3-moe-30b-a3b at full width, expert parallel over 4 ranks,
    # expert TP over 3; capacity E / k (no slot drops)
    cfg = get_config("qwen3-moe-30b-a3b")
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    free = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=E / k))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = _d_shared(rank, queue, lambda: M.init_params(
        cfg, torch.Generator(device=mesh.device).manual_seed(SEED), device=mesh.device))
    _d_print(rank, f"D2 {cfg.name} weights shared by CUDA IPC", {
        "params_gb": sum(t.numel() * t.element_size() for t in _tensors(params)) / 1e9,
        "seconds": time.time() - t0})
    drops, real_moe = [], moe_mod.moe_forward

    def recording(p, x, *a, **kw):
        y, aux = real_moe(p, x, *a, **kw)
        drops.append(float(aux["drop_frac"]))
        return y, aux

    prompt = list(range(5, 24))                        # 19 tokens, a speculative prefill
    moe_mod.moe_forward = recording
    try:
        reference = None
        if rank == 0:     # the single-process MoE, kernels and oracle
            lsm_one, fed = _d_decode(M, params, free, prompt, None, 4)
            drops_one = list(drops)
            lsm_ref, _ = _d_decode(M, params, dataclasses.replace(free, attn_impl="ref"),
                                   prompt, None, 4, fed)
            reference = (fed, _d_max_diff(lsm_one, lsm_ref))
        box = [reference]
        dist.broadcast_object_list(box, src=0)
        fed, bound = box[0]
        tp_mesh = make_dist_mesh(3, ranks=[0, 1, 2], device=mesh.device)
        for label, m in (("expert parallel x4", mesh), ("expert TP x3", tp_mesh)):
            if m is not None:
                mi_m = M.mesh_context(m)
                local = sh.shard_tree(params, sh.rank_param_specs(free, m), m)
                zero()
                drops.clear()
                lsm, _ = _d_decode(M, local, free, prompt, mi_m, 4, fed)
                counts = read()
                for name in ("flash_attention", "decode_attention"):
                    launches[name] += counts[name]
                held = list(local["blocks"][0]["moe"]["w_gate"].shape)
                row = {"rank": rank, "experts_held": held, "launches": counts,
                       "collectives": m.counts["collectives"],
                       "staged_copies": m.counts["staged_copies"], "drop_frac": drops[:],
                       "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
                if rank == 0:
                    row["vs single process"] = _d_max_diff(lsm, lsm_one)
                    row["bound"] = bound
                    assert drops == drops_one, (drops, drops_one)
                    assert row["vs single process"] <= bound, row
                assert counts["flash_attention"] == cfg.n_layers, counts
                assert counts["decode_attention"] == 4 * cfg.n_layers, counts
                del local
            rows = _d_gather(row if m is not None else None)
            for r in rows:
                if r is not None:
                    _d_print(rank, f"D2 {cfg.name} {label}, a 19-token prefill and 4 steps at "
                                   f"capacity factor {free.moe.capacity_factor}", r)
        free_b, total_b = torch.cuda.mem_get_info()
        _d_print(rank, f"D2 {cfg.name} device memory in use", {
            "used_gb": (total_b - free_b) / 1e9, "total_gb": total_b / 1e9,
            "peak_allocated_gb_per_rank": [r["peak"] for r in _d_gather(
                {"peak": torch.cuda.max_memory_allocated() / 1e9})]})
    finally:
        moe_mod.moe_forward = real_moe
    del params
    _d_release(rank, f"D2 {cfg.name} weights")

    # ---- D4: elastic restore, reduced (the disk cap; see the docstring): a
    # reduced MoE model's state saved from 4 ranks, restored onto 2
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    params = M.init_params(cfg, torch.Generator(device=mesh.device).manual_seed(SEED),
                           device=mesh.device)
    opt = opt_mod.init_opt_state(params)

    def specs_on(m):
        p = sh.rank_param_specs(cfg, m)
        return {"params": p, "opt": {"m": p, "v": p, "step": sh.P()}}

    state = {"params": params, "opt": opt}
    t0 = time.time()
    path = ck.save(sh.shard_tree(state, specs_on(mesh), mesh), ckpt_dir, 1, mesh=mesh,
                   spec_tree=specs_on(mesh))
    two = make_dist_mesh(2, ranks=[0, 1], device=mesh.device)
    row = None
    if two is not None:
        got = ck.restore(ckpt_dir, 1, state, mesh=two, spec_tree=specs_on(two))
        want = sh.shard_tree(state, specs_on(two), two)
        from repro_torch.tree import leaves
        pairs = list(zip(leaves(got), leaves(want), strict=True))
        row = {"rank": rank, "leaves": len(pairs),
               "bitwise": all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs),
               "experts_held": list(got["params"]["blocks"][0]["moe"]["w_gate"].shape)}
    rows = _d_gather(row)
    _d_print(rank, f"D4 {cfg.name} saved from 4 ranks ({path}), restored onto 2",
             {"rows": rows, "seconds": time.time() - t0})
    assert all(r["bitwise"] for r in rows if r is not None), rows
    return {"launches": launches}


def _phase_d3_ranks(rank, mesh, batches, ref, steps_ref):
    """D3 on one rank of a (2, 1) mesh: musicgen-medium data parallel."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_dist_mesh
    from repro_torch.models import model as M
    from repro_torch.training import compression as C
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import steps as steps_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    counters = kernel_counters()
    cfg = get_config("musicgen-medium")
    mi = M.mesh_context(mesh)
    dev = mesh.device
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    opt = opt_mod.init_opt_state(params)
    tb = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in batches]
    layers = (0, cfg.n_layers // 2, cfg.n_layers - 1)

    def agreement(grads, metrics):
        agree = {key: _grad_agreement(grads["blocks"][i]["attn"][w], ref["leaves"][key].to(dev))
                 for key, (i, w) in ((f"{w}[{i}]", (i, w)) for i in layers
                                     for w in ("wq", "wk", "wv"))}
        loss, norm = float(metrics["loss"]), opt_mod.global_norm(grads).item()
        return loss, norm, agree, _train_bound_misses(loss, ref["loss"], norm, ref["grad_norm"],
                                                      agree)

    # the control: each rank's own half, with no reduce, must miss the bound
    rows = slice(2 * mesh.axis_index("data"), 2 * mesh.axis_index("data") + 2)
    own, m_own = steps_mod.step_grads(params, cfg, {k: v[rows] for k, v in tb[0].items()})
    _, _, _, misses = agreement(own, m_own)
    _d_print(rank, f"D3 {cfg.name} control, each rank on its own half with no reduce",
             {"outside TRAIN_BOUND": misses})
    assert misses, "ranks that skip the gradient reduce passed TRAIN_BOUND"

    # the int8 error-feedback sync over a 2-pod axis on those per-rank
    # gradients (each rank's own mean), against their exact mean, a layer
    # (and the leaves outside the layers) at a time
    pods = make_dist_mesh(pod=2, device=dev)
    worst, unequal = 0.0, 0
    groups = [{k: v for k, v in own.items() if k != "blocks"}] + own["blocks"]
    for i, group in enumerate(groups):
        synced, _ = C.compressed_grad_sync(group, C.init_error_feedback(group), pods, axis="pod")
        sizes = [t.numel() for t in _tensors(group)]
        exact = pods.pmean(torch.cat([t.float().flatten() for t in _tensors(group)]), "pod")
        got = torch.cat([t.float().flatten() for t in _tensors(synced)])
        for e, g in zip(exact.split(sizes), got.split(sizes), strict=True):
            worst = max(worst, ((g - e).abs().max() / e.abs().max()).item())
        unequal += int((pods.pmax(got, "pod") != -pods.pmax(-got, "pod")).sum())
        groups[i] = None
    row = {"rank": rank, "max |synced - mean| / max |mean| over leaves": worst,
           "elements unequal across ranks": unequal, "bytes (compressed, bf16 all-reduce)":
           C.dcn_bytes(params, 2)}
    for r in _d_gather(row):
        _d_print(rank, f"D3 {cfg.name} compressed_grad_sync over 2 pods", r)
    assert worst < 0.02 and unequal == 0, row
    del own, groups

    # two data-parallel steps; the first by hand, so that its gradients (this
    # rank's 2 rows, summed over the ranks) are held against the single
    # process's before the update, the second through train_step
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    mesh.counts.update(collectives=0, staged_copies=0)
    oc = opt_mod.AdamWConfig(lr=3e-4, total_steps=10, warmup_steps=2)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    grads, metrics = steps_mod.step_grads(params, cfg, tb[0], mi)
    loss, norm, agree, misses = agreement(grads, metrics)
    _d_print(rank, f"D3 {cfg.name} data parallel x2, one step's gradients against the single "
                   f"process's", {"loss": [loss, ref["loss"]],
                                  "grad_norm": [norm, ref["grad_norm"]], "leaves": agree,
                                  "outside TRAIN_BOUND": misses})
    assert not misses, misses
    params, opt, om = opt_mod.apply_updates(params, grads, opt, oc)   # the model axis is 1
    del grads
    torch.cuda.synchronize()
    recs = [{"loss": loss, "grad_norm": float(om["grad_norm"]),
             "wall_s": time.perf_counter() - t0}]
    t0 = time.perf_counter()
    params, opt, m = steps_mod.train_step(params, opt, tb[1], cfg=cfg, opt_cfg=oc, mesh_info=mi)
    torch.cuda.synchronize()
    recs.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                 "wall_s": time.perf_counter() - t0})
    counts = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    row = {"rank": rank, "steps": recs, "single process": steps_ref, "launches": counts,
           "collectives": mesh.counts["collectives"], "staged_copies": mesh.counts["staged_copies"],
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    for r in _d_gather(row):
        _d_print(rank, f"D3 {cfg.name} 2 data-parallel steps of 4 x 128", r)
    for got, want in zip(recs, steps_ref, strict=True):
        misses = _train_bound_misses(got["loss"], want["loss"], got["grad_norm"],
                                     want["grad_norm"], {})
        assert not misses, (recs, steps_ref, misses)
    assert counts["flash_attention"] == 2 * (1 + cfg.remat) * cfg.n_layers, counts
    assert counts["flash_attention_bwd"] == 2 * 3 * cfg.n_layers, counts
    return {"launches": counts}


def distributed_phase():
    """Phase D (see the module's docstring); returns each kernel's launches
    on its main paths, summed over the ranks."""
    import tempfile

    import torch.multiprocessing as torch_mp

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch.dist import spawn
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import steps as steps_mod

    print(f"phase D {_card_line()}: ranks over gloo, every one on cuda:0 "
          f"({torch.cuda.device_count()} card)", flush=True)
    totals = {}
    torch.cuda.empty_cache()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="ckpt_d4_", dir=build) as ckpt_dir:
        queue = torch_mp.get_context("spawn").SimpleQueue()
        for res in spawn(_phase_d_ranks, D_RANKS, model_parallel=D_RANKS,
                         args=(queue, ckpt_dir), timeout_s=600):
            for name, n in res["launches"].items():
                totals[name] = totals.get(name, 0) + n
    print(f"phase D D1, D2, D4 on {D_RANKS} ranks: {time.time() - t0:.1f} s", flush=True)

    # D3: the single-process step first, kept on the host, the card freed
    t0 = time.time()
    cfg = get_config("musicgen-medium")
    dc = DataConfig(seed=0, seq_len=129, global_batch=4)
    batches = [batch_at(cfg, dc, i) for i in (0, 1)]
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    tb = [{k: torch.from_numpy(v).cuda() for k, v in b.items()} for b in batches]
    grads, metrics = steps_mod.step_grads(params, cfg, tb[0])
    layers = (0, cfg.n_layers // 2, cfg.n_layers - 1)
    ref = {"loss": float(metrics["loss"]), "grad_norm": opt_mod.global_norm(grads).item(),
           "leaves": {f"{w}[{i}]": grads["blocks"][i]["attn"][w].cpu() for i in layers
                      for w in ("wq", "wk", "wv")}}
    del grads
    opt = opt_mod.init_opt_state(params)
    oc = opt_mod.AdamWConfig(lr=3e-4, total_steps=10, warmup_steps=2)
    steps_ref = []
    for b in tb:
        params, opt, m = steps_mod.train_step(params, opt, b, cfg=cfg, opt_cfg=oc)
        steps_ref.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
    del params, opt, tb
    torch.cuda.empty_cache()
    for res in spawn(_phase_d3_ranks, 2, args=(batches, ref, steps_ref), timeout_s=600):
        for name, n in res["launches"].items():
            totals[name] = totals.get(name, 0) + n
    print(f"phase D D3 on 2 ranks: {time.time() - t0:.1f} s", flush=True)
    return totals


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        sys.exit(1)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.patterns import PatternEngine
    from repro_torch.core.workload import WorkloadConfig, episodes_to_traces, make_episodes
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.mesh import make_local_mesh, mesh_axes, mesh_counts
    from repro_torch.launch.serve import serve_agent_loop
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving.engine import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card.splitlines()[0])

    # ---- phase 1: build -------------------------------------------------
    t0 = time.time()
    logs = _build.build()
    print(f"phase 1 build: {time.time() - t0:.1f} s for {list(_build.SOURCES)}", flush=True)
    clock("1 build")
    for name, log in logs.items():
        report = _build.ptxas_report(log)
        print(f"phase 1 {name} ptxas: {json.dumps(report)}", flush=True)
        hmma = _build.sass_hmma(_build.library_path(name))
        if hmma is not None:
            print(f"phase 1 {name} HMMA instructions per kernel in the SASS: "
                  f"{json.dumps(hmma)}", flush=True)
        if name == "ssd_scan":
            assert all(r.get("spill_bytes", 0) == 0 for r in report), report
            assert hmma is None or all(v > 0 for fn, v in hmma.items() if "bfloat16" in fn), hmma
        if name == "flash_attention_bwd":
            rows = [[r["fn"], r.get("registers"), r.get("spill_bytes", 0),
                     None if hmma is None else hmma.get(r["fn"])] for r in report]
            print(f"phase 1 flash_attention_bwd instantiations [kernel, registers, spill bytes, "
                  f"HMMA]: {json.dumps(rows)}", flush=True)
            assert all(r.get("spill_bytes", 0) == 0 for r in report), report
            tc = {fn: n for fn, n in (hmma or {}).items() if "dkdv_bf16" in fn or "dq_bf16" in fn}
            assert hmma is None or (len(tc) == 2 * len(_build.ATTENTION_HEAD_DIMS["flash_attention_bwd"])
                                    and all(tc.values())), hmma
        if name == "ssd_scan_bwd":
            rows = [[r["fn"], r.get("registers"), r.get("spill_bytes", 0),
                     None if hmma is None else hmma.get(r["fn"])] for r in report]
            print(f"phase 1 ssd_scan_bwd instantiations [kernel, registers, spill bytes, HMMA]: "
                  f"{json.dumps(rows)}", flush=True)
            assert all(r.get("spill_bytes", 0) == 0 for r in report), report
            tc = {fn: n for fn, n in (hmma or {}).items() if "ssd_bwd_kernel<__nv_bfloat16" in fn}
            assert hmma is None or (len(tc) == len(ssd.SHAPES) and all(tc.values())), hmma
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            per_sm = {f"{p}, {n}, {q}": {str(dt).split(".")[1]: ssd.bwd_slots(0, p, n, q, dt) // sms
                                         for dt in (torch.bfloat16, torch.float32)}
                      for p, n, q in ssd.SHAPES}
            plan = {arch: ssd.bwd_heads_per_block(h, 1, 16, ssd.bwd_slots(0, 64, n, 128,
                                                                              torch.bfloat16))
                    for arch, h, n in (("mamba2-2.7b", 80, 128), ("zamba2-1.2b", 64, 64))}
            print(f"phase 1 ssd_scan_bwd blocks an SM (P, N, chunk): {json.dumps(per_sm)}; heads "
                  f"a block at phase T's 4 x 512 steps over {sms} SMs: {json.dumps(plan)}",
                  flush=True)

    # ---- phase 2: kernels against their plain versions ------------------
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    cases = {"flash_attention": [], "decode_attention": [], "decode_attention_partials": [],
             "ssd_scan": []}
    for dtype in (torch.bfloat16, torch.float32):
        timed = dtype == torch.bfloat16
        for s, window in ((3, None), (19, None), (2048, None), (2048, 512)):
            cases["flash_attention"].append(
                flash_case(ops, gen, flush, 1, s, 28, 4, 128, dtype, window, timed))
        for smax, window in ((192, None), (4096, 1024), (4096, None)):
            cases["decode_attention"].append(
                decode_case(ops, gen, flush, 4, 28, 4, 128, smax, dtype, window, timed))
        # 4 slices of qwen2-7b's sharded serving cache (Smax 192, slices of 48
        # that are full, partial and empty), then 4 slices of Smax 4096
        for smax, lengths, window, timed_p in (
                (192, [65, 10, 192, 150], None, timed),
                (4096, [4096, 1, 2500, 1024], None, timed),
                (4096, [4096, 1, 2500, 1024], 1024, False)):
            cases["decode_attention_partials"].append(
                partials_case(ops, da, gen, flush, smax, lengths, dtype, window, timed_p))
        # mamba2-2.7b's prompts of 3 and 19 tokens, a ragged second chunk with
        # an initial state over two groups, a long prompt, and a long chain of
        # 32 chunks over 4 sequences with an initial state (10240 blocks)
        for b, s, g, with_h0, timed_ssd in ((1, 3, 1, False, False), (1, 19, 1, False, timed),
                                            (1, 130, 2, True, False), (1, 2048, 1, False, timed),
                                            (4, 4096, 1, True, timed)):
            cases["ssd_scan"].append(
                ssd_case(ops, gen, flush, b, s, 80, 64, g, 128, dtype, with_h0, timed_ssd))
    # zamba2-1.2b's shapes and head_dim 32, from a generator of their own, so
    # that the cases above keep the inputs they had before these were added
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for dtype in (torch.bfloat16, torch.float32):
        timed = dtype == torch.bfloat16
        # the shared attention (32 heads of 64, grp 1) at zamba2's prompts and a
        # long one; the reduced configs' head_dim 32 (4 heads over 2)
        for s, h, kv, d in ((3, 32, 32, 64), (19, 32, 32, 64), (2048, 32, 32, 64),
                            (19, 4, 2, 32)):
            cases["flash_attention"].append(
                flash_case(ops, gen, flush, 1, s, h, kv, d, dtype, None, timed))
        # zamba2's serving step (4 sequences, Smax 192) and a long cache; reduced
        # qwen2-7b's step under the serving CLI (Smax 160, head_dim 32)
        for h, kv, d, smax in ((32, 32, 64, 192), (32, 32, 64, 4096), (4, 2, 32, 160)):
            cases["decode_attention"].append(
                decode_case(ops, gen, flush, 4, h, kv, d, smax, dtype, None, timed))
        # the shared attention sharded x4 (head_dim 64, grp 1)
        cases["decode_attention_partials"].append(
            partials_case(ops, da, gen, flush, 192, [65, 10, 192, 150], dtype, None, timed,
                          h=32, kv=32, d=64))
        # zamba2's prompts of 3 and 19 tokens (64 heads, N = 64)
        for s, timed_ssd in ((3, False), (19, timed)):
            cases["ssd_scan"].append(
                ssd_case(ops, gen, flush, 1, s, 64, 64, 1, 64, dtype, False, timed_ssd))
    # qwen3-moe-30b-a3b's attention (32 heads over 4 of head_dim 128) and
    # musicgen-medium's (24 over 24 of head_dim 64) at their prompts and
    # serving step; the reduced Mamba2 and hybrid configs' SSD shape (P 32,
    # N 16, chunk 32): a 19-token prompt, a ragged third chunk with an
    # initial state, a chain of 128 chunks over 4 sequences. A generator of
    # their own, so that the cases above keep their inputs.
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for dtype in (torch.bfloat16, torch.float32):
        timed = dtype == torch.bfloat16
        for s, h, kv, d in ((3, 32, 4, 128), (19, 32, 4, 128), (19, 24, 24, 64)):
            cases["flash_attention"].append(
                flash_case(ops, gen, flush, 1, s, h, kv, d, dtype, None, timed))
        for h, kv, d in ((32, 4, 128), (24, 24, 64)):
            cases["decode_attention"].append(
                decode_case(ops, gen, flush, 4, h, kv, d, 192, dtype, None, timed))
        for b, s, h, with_h0, timed_ssd in ((1, 19, 4, False, timed), (1, 70, 8, True, False),
                                            (4, 4096, 8, True, timed)):
            cases["ssd_scan"].append(ssd_case(ops, gen, flush, b, s, h, 32, 1, 16, dtype,
                                              with_h0, timed_ssd, chunk=32))
    # zamba2-7b's cell (zamba2-7b.agent-spec-4k): its shared attention at
    # head_dim 224 (32 heads over 32) at prefills of 2048 and 4096 tokens and
    # its decode step (34 rows to Smax 4096), and its SSD scan (112 heads
    # over 2 groups, P 64, N 64) at the same prefills. A generator of their
    # own, so that the cases above keep their inputs
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for dtype in (torch.bfloat16, torch.float32):
        timed = dtype == torch.bfloat16
        for s in (2048, 4096):
            cases["flash_attention"].append(
                flash_case(ops, gen, flush, 1, s, 32, 32, 224, dtype, None, timed))
        cases["decode_attention"].append(
            decode_case(ops, gen, flush, 34, 32, 32, 224, 4096, dtype, None, timed))
        for s in (2048, 4096):
            cases["ssd_scan"].append(
                ssd_case(ops, gen, flush, 1, s, 112, 64, 2, 64, dtype, False, timed))
    # the backward kernel (training): musicgen-medium's training step (4 x 128
    # tokens, 24 heads over 24 of head_dim 64), qwen2-7b at S = 2048 causal and
    # under a window of 1024, zamba2-1.2b's shared attention at S = 2048, and
    # reduced granite-8b's training step (8 x 64, 4 heads over 2 of head_dim
    # 32); a generator of their own, so that the cases above keep their inputs
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases["flash_attention_bwd"] = []
    for dtype in (torch.bfloat16, torch.float32):
        for b, s, h, kv, d, window in ((4, 128, 24, 24, 64, None), (1, 2048, 28, 4, 128, None),
                                       (1, 2048, 28, 4, 128, 1024), (1, 2048, 32, 32, 64, None),
                                       (8, 64, 4, 2, 32, None)):
            cases["flash_attention_bwd"].append(
                flash_bwd_case(ops, fa, gen, flush, b, s, h, kv, d, dtype, window))
    # the SSD backward kernel (training): the three built (P, N, chunk) with
    # a ragged last chunk, two groups, an initial state and a cotangent of the
    # final state; mamba2-2.7b at S = 2048; phase T's full-width steps (4 x
    # 512 tokens: mamba2-2.7b's 80 heads at N = 128, zamba2-1.2b's 64 at N =
    # 64); the reduced configs' 100-step run (8 x 64, 4 heads, P 32, N 16,
    # chunk 32). A generator of their own, so that the cases above keep
    # their inputs
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cases["ssd_scan_bwd"] = []
    for dtype in (torch.bfloat16, torch.float32):
        for b, s, h, p, g, n, chunk, with_h0, with_df in (
                (2, 300, 8, 64, 2, 128, 128, True, True),
                (2, 300, 8, 64, 1, 64, 128, True, False),
                (2, 70, 8, 32, 2, 16, 32, False, True),
                (1, 2048, 80, 64, 1, 128, 128, False, False),
                (4, 512, 80, 64, 1, 128, 128, False, False),
                (4, 512, 64, 64, 1, 64, 128, False, False),
                (8, 64, 4, 32, 1, 16, 32, False, False)):
            cases["ssd_scan_bwd"].append(ssd_bwd_case(ssd, gen, flush, b, s, h, p, g, n, chunk,
                                                      dtype, with_h0, with_df))
    for name, cs in cases.items():
        for c in cs:
            print(f"phase 2 {name} {json.dumps(c)}", flush=True)
    clock("2")

    # ---- phases 3-4: each serving path at full width ----------------------
    pe = PatternEngine(context_len=2, min_support=3).fit(
        episodes_to_traces(make_episodes(WorkloadConfig(seed=1, n_episodes=40))))
    # 1 episode of the agent loop per model (3 until phase D was added, 2
    # until the int8 hybrid was: the cuts that keep the whole run inside its
    # 1200 s)
    episodes = make_episodes(WorkloadConfig(seed=9, n_episodes=1))
    counters = kernel_counters()
    launches = {}

    cfg = get_config("qwen2-7b")
    params = init_model(M, cfg)
    engine, counts, prefills, engine_steps = serve_model(
        M, ServingEngine, serve_agent_loop, cfg, params, pe, episodes, counters, cfg.name)
    assert counts["flash_attention"] == cfg.n_layers * prefills > 0, counts
    assert engine_steps > 0 and not any(counts[k] for k in DECODE_KERNELS), counts
    assert counts["ssd_scan"] == 0, counts
    decode_k = [("decode_attention", "decode_attention_kernel")]
    flash_k = [("flash_attention", "flash_attention_bf16_kernel")]
    traced = _profile_steps(M, params, engine, cfg.name, decode_k, flash_k,
                            {"decode_attention": cfg.n_layers})
    launches["flash_attention"] = counts["flash_attention"]
    launches["decode_attention"] = traced["decode_attention"]
    check_model(M, cfg, params, engine, cfg.name)
    del engine

    # the same weights under a sliding window of 64: a rolling buffer of 64
    # rows (max_len 192), a 100-token prompt rolled into it
    cfg_swa = dataclasses.replace(cfg, sliding_window=64)
    engine = ServingEngine(cfg_swa, params, max_batch=4, max_len=192, device="cuda")
    assert engine.cache["k"].shape[2] == 64
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    check_model(M, cfg_swa, params, engine, f"{cfg.name} rolling window 64",
                prompt=range(5, 105))
    counts = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    print(f"phase 4 {cfg.name} rolling window 64 launches: {counts}", flush=True)
    assert counts["flash_attention"] > 0 and counts["decode_attention"] > 0, counts
    del engine
    check_rolling(M, cfg, params)

    # the same weights, sequence-sharded over 4 shards of the cache on this card
    mesh = make_local_mesh(4)
    n_batch, n_model = mesh_counts(mesh)
    mi = M.MeshContext(mesh, *mesh_axes(mesh), n_model, n_batch)
    partials = ("decode_attention_partials", "decode_attention_kernel")
    for kv_dtype in ("bfloat16", "int8"):
        cfg_sh = dataclasses.replace(cfg, sharded_decode_attn=True, kv_cache_dtype=kv_dtype)
        label = f"{cfg.name} sharded x{n_model} {kv_dtype} cache"
        engine, counts, prefills, engine_steps = serve_model(
            M, ServingEngine, serve_agent_loop, cfg_sh, params, pe, episodes, counters, label,
            mesh_info=mi)
        assert engine_steps > 0 and not any(counts[k] for k in DECODE_KERNELS), counts
        assert counts["ssd_scan"] == 0, counts
        assert counts["flash_attention"] == cfg.n_layers * prefills > 0, counts
        traced = _profile_steps(M, params, engine, label, [partials], None,
                                {"decode_attention_partials": cfg.n_layers * n_model})
        if kv_dtype == "bfloat16":
            launches["decode_attention_partials"] = traced["decode_attention_partials"]
        if kv_dtype == "bfloat16":
            # a 100-token prompt: the slot's keys span the first three shards
            check_model(M, cfg, params, engine, label, need=6, prompt=range(5, 105))
        del engine
    check_sharded_engines(M, ServingEngine, cfg, params, mi, counters, cfg.n_layers)
    del params
    torch.cuda.empty_cache()
    clock(f"3-4 {cfg.name}")

    cfg = get_config("mamba2-2.7b")
    params = init_model(M, cfg)
    engine, counts, prefills, engine_steps = serve_model(
        M, ServingEngine, serve_agent_loop, cfg, params, pe, episodes, counters, cfg.name)
    assert counts["ssd_scan"] == cfg.n_layers * prefills > 0, counts
    assert counts["flash_attention"] == counts["decode_attention"] == 0, counts
    assert engine_steps > 0 and counts["decode_attention_partials"] == 0, counts
    launches["ssd_scan"] = counts["ssd_scan"]
    ssd_k = [("ssd_scan", "ssd_scan_kernel")]
    _profile_steps(M, params, engine, cfg.name, [], ssd_k, {})
    check_model(M, cfg, params, engine, cfg.name)
    del engine, params
    torch.cuda.empty_cache()
    clock(f"3-4 {cfg.name}")

    # the hybrid: 38 Mamba2 layers, one shared attention block (head_dim 64)
    # applied after every 6th, fresh K/V each time
    cfg = get_config("zamba2-1.2b")
    params = init_model(M, cfg)
    groups = M.hybrid_split(cfg)[0]
    # with a bf16 KV cache, then the same weights with an int8 one
    int8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    for cfg_kv, label in ((cfg, cfg.name), (int8, f"{cfg.name} int8 cache")):
        engine, counts, prefills, engine_steps = serve_model(
            M, ServingEngine, serve_agent_loop, cfg_kv, params, pe, episodes, counters, label)
        assert counts["ssd_scan"] == cfg.n_layers * prefills > 0, counts
        assert counts["flash_attention"] == groups * prefills > 0, counts
        assert engine_steps > 0 and not any(counts[k] for k in DECODE_KERNELS), counts
        counts |= _profile_steps(M, params, engine, label, decode_k, ssd_k + flash_k,
                                 {"decode_attention": groups})
        check_model(M, cfg_kv, params, engine, label)
        clock(f"3-4 {label}")
    launches["int8_hybrid"] = counts
    assert engine.cache["k"][0].dtype == engine.cache["v"][0].dtype == torch.int8
    kv8, all8 = _cache_bytes(engine.cache)
    kv16, all16 = _cache_bytes(M.init_cache(cfg, engine.max_batch, engine.max_len))
    del engine
    print(f"phase 4 {int8.name} int8 cache against the bf16 cache, max |log-softmax "
          f"difference| after a 100-token prefill and per teacher-forced step: "
          f"{json.dumps(int8_gap(M, cfg, params))}; cache bytes at batch 4 x 192 rows, K/V "
          f"{kv8} int8 vs {kv16} bf16 ({kv8 / kv16:.4f}), all leaves {all8} vs {all16}",
          flush=True)
    check_sharded_engines(M, ServingEngine, cfg, params, mi, counters, groups)
    del params
    torch.cuda.empty_cache()
    clock(f"3-4 {cfg.name} int8 checks")

    # the MoE family at full width (48 layers, 128 experts
    # top-8, 61 GB in bf16), alone on the card
    cfg = get_config("qwen3-moe-30b-a3b")
    torch.cuda.reset_peak_memory_stats()
    params = init_model(M, cfg)
    engine, counts, prefills, engine_steps = serve_model(
        M, ServingEngine, serve_agent_loop, cfg, params, pe, episodes, counters, cfg.name)
    assert counts["flash_attention"] == cfg.n_layers * prefills > 0, counts
    assert engine_steps > 0 and not any(counts[k] for k in DECODE_KERNELS), counts
    assert counts["ssd_scan"] == 0, counts
    traced = _profile_steps(M, params, engine, cfg.name, decode_k, flash_k,
                            {"decode_attention": cfg.n_layers})
    launches["flash_attention"] = counts["flash_attention"]
    launches["decode_attention"] = traced["decode_attention"]
    print(f"phase 3 {cfg.name} peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} "
          f"GB", flush=True)
    del engine
    moe_drops(M, moe_mod, ServingEngine, params, cfg)
    # the batched slot routes 4 tokens, the standalone decode 1: only a
    # capacity that drops nothing (factor E / k) lets them agree
    free = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    print(f"phase 4 {cfg.name} served at capacity factor {cfg.moe.capacity_factor}; checked "
          f"at {free.moe.capacity_factor} (capacity = tokens, no drops)", flush=True)
    engine = ServingEngine(free, params, max_batch=4, max_len=192, device="cuda")
    check_model(M, free, params, engine, f"{cfg.name} capacity factor {free.moe.capacity_factor}")
    del engine, params
    torch.cuda.empty_cache()
    clock(f"3-4 {cfg.name}")

    # the audio backbone (48 layers, 24 heads of head_dim 64), served from
    # token ids, and one prefill from frontend embeddings
    cfg = get_config("musicgen-medium")
    params = init_model(M, cfg)
    engine, counts, prefills, engine_steps = serve_model(
        M, ServingEngine, serve_agent_loop, cfg, params, pe, episodes, counters, cfg.name)
    assert counts["flash_attention"] == cfg.n_layers * prefills > 0, counts
    assert engine_steps > 0 and not any(counts[k] for k in DECODE_KERNELS), counts
    assert counts["ssd_scan"] == 0, counts
    _profile_steps(M, params, engine, cfg.name, decode_k, flash_k,
                   {"decode_attention": cfg.n_layers})
    check_model(M, cfg, params, engine, cfg.name)
    check_embeds(M, cfg, params)
    del engine, params
    torch.cuda.empty_cache()
    clock(f"3-4 {cfg.name}")

    # the serving CLI on its default device, every arch reduced
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve
    for arch, arch_cfg in ARCHS.items():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.time()
        serve.main(["--arch", arch, "--episodes", "1"])
        counts = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
        print(f"phase 4 serve CLI --arch {arch} (reduced, cuda): {time.time() - t0:.1f} s, "
              f"launches {counts}", flush=True)
        if arch_cfg.family in ("ssm", "hybrid"):
            assert counts["ssd_scan"] > 0, counts
        if arch_cfg.family != "ssm":
            assert counts["flash_attention"] > 0 and counts["decode_attention"] > 0, counts
    clock("4 serve CLI")

    # ---- phase T: training at full width (musicgen-medium, mamba2-2.7b,
    # zamba2-1.2b), then reduced ----
    readings = {}
    training_phase(counters, launches, readings=readings)
    clock("T")

    # ---- phase X: the dry-run; it launches none of the kernels ----------
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    dryrun_phase(readings)
    counts = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    assert not any(counts.values()), counts
    clock("X")

    # ---- phase R: the B-PASTE runtime; it launches none of the kernels ----
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    runtime_phase("cuda")
    counts = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    assert not any(counts.values()), counts
    clock("R")

    # ---- phase S: the static checker held against the card; its decode,
    # prefill and train calls ran in phases 3 and T; it launches none of the kernels ----
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    sync_phase()
    counts = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    assert not any(counts.values()), counts
    clock("S")

    # ---- phase D: multi-device over torch.distributed, ranks sharing the card
    t0 = time.time()
    dist_launches = distributed_phase()
    print(f"phase D: {time.time() - t0:.1f} s; launches on its paths, summed over the ranks: "
          f"{json.dumps(dist_launches)}", flush=True)
    clock("D")

    # ---- phase 5: the kernels line; then the device line -----------------
    replaces = {
        "flash_attention": "src/repro/kernels/flash_attention.py:113",
        "decode_attention": "src/repro/kernels/decode_attention.py:121",
        "decode_attention_partials": "src/repro/kernels/decode_attention.py:169",
        "ssd_scan": "src/repro/kernels/ssd_scan.py:122",
    }
    source = {name: f"src/repro_torch/kernels/csrc/{name}.cu" for name in replaces}
    source["decode_attention_partials"] = source["decode_attention"]
    def case_at(name, shape):
        return next(c for c in cases[name] if c["shape"] == shape and c["dtype"] == "bfloat16")

    path_case = {  # qwen3-moe-30b-a3b's 19-token speculative prefill and its serving step
                 "flash_attention": case_at("flash_attention", [1, 19, 32, 4, 128]),
                 "decode_attention": case_at("decode_attention", [4, 32, 4, 128, 192]),
                 "decode_attention_partials": cases["decode_attention_partials"][0],  # 4 x 48
                 "ssd_scan": cases["ssd_scan"][1]}                  # S=19 speculative prefill
    replaces["flash_attention_bwd"] = ("jax.vjp of src/repro/kernels/ops.py::"
                                       "_jnp_flash_attention (no Pallas backward exists)")
    source["flash_attention_bwd"] = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
    # musicgen-medium's training step (phase T's main path)
    path_case["flash_attention_bwd"] = case_at("flash_attention_bwd", [4, 128, 24, 24, 64])
    replaces["ssd_scan_bwd"] = ("jax.vjp of src/repro/kernels/ops.py::_jnp_ssd_chunked (no "
                                "Pallas backward exists)")
    source["ssd_scan_bwd"] = "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"
    # mamba2-2.7b's training step (phase T's full-width SSM path)
    path_case["ssd_scan_bwd"] = case_at("ssd_scan_bwd", [4, 512, 80, 64, 1, 128])
    kernels = []
    for name in replaces:
        c = path_case[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(x["max_abs_err"] for x in cases[name]),
            "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "at": {"shape": c["shape"], "dtype": c["dtype"]},
        })
    # the forward kernels' launches on the training paths (phase T), beside the serving counts
    kernels[0]["training_launches"] = launches["flash_attention_train"]
    kernels[3]["training_launches"] = launches["ssd_scan_train"]
    for k in kernels:     # phase D's main paths, every rank's launches
        k["dist_launches"] = dist_launches[k["name"]]
    for k in kernels[:4]:   # the forward kernels on the int8 zamba2-1.2b path
        k["int8_hybrid_launches"] = launches["int8_hybrid"][k["name"]]
    # the forward kernels at zamba2-7b's cell's longest shapes (that cell's
    # launches are the benchmark's to count)
    for k, shape in ((kernels[0], [1, 4096, 32, 32, 224]), (kernels[1], [34, 32, 32, 224, 4096]),
                     (kernels[3], [1, 4096, 112, 64, 2, 64])):
        c = case_at(k["name"], shape)
        k["zamba2_7b_at"] = {key: c[key] for key in ("shape", "ms", "plain_ms", "library_ms",
                                                      "bound_ms", "bound_by")}
    clock("5")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

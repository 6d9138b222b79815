"""Multi-resource co-run interference model (paper Eq. 4, §2, §5).

Bottleneck (roofline-style) slowdown: for a machine with capacity vector
cap and a co-running job set with demand vectors ρ_j, the per-dimension
utilization is u_d = Σ_j ρ_jd / cap_d; any dimension with u_d > 1 stretches
every job that uses it by u_d.  A job's slowdown is the max stretch over
the dimensions it touches:

    slow_j = max_d ( u_d if ρ_jd > 0 else 1,  1 )
    L_j^co = L_j^solo · slow_j          =>   ΔI = L^co − L^solo

This is the TPU/host-idiomatic replacement for the paper's (unspecified)
Thor SoC measurement: it captures exactly the phenomenon the paper targets
— co-location can raise aggregate throughput while delaying the critical
branch.  Deterministic, differentiable, and vectorizable (scoring.py).

Also home of the model-step batch-efficiency curve
(``batched_step_latency``): the sublinear cost model the batched model-step
service (model_service.py) charges per micro-batched invocation.

Upstream: events.py (ResourceVector).  Downstream: simulator.py (job
progress rates), scoring.py (ΔI), runtime Phase 2 (protection),
model_service.py (batch latency).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.core.events import ResourceVector


@dataclass(frozen=True)
class Machine:
    """Thor-class edge box by default: 12 cores, 100 GB/s mem, 500 MB/s io,
    1 accelerator slot."""
    capacity: ResourceVector = ResourceVector(cpu=12, mem_bw=100, io=500, accel=1)

    def cap_array(self) -> np.ndarray:
        return np.maximum(self.capacity.as_array(), 1e-9)


def utilization(demands: np.ndarray, cap: np.ndarray) -> np.ndarray:
    """demands (J, R) -> per-dim utilization (R,)."""
    if demands.size == 0:
        return np.zeros_like(cap)
    return demands.sum(axis=0) / cap


def slowdowns(demands: np.ndarray, cap: np.ndarray) -> np.ndarray:
    """Per-job slowdown factors (J,) for a co-running set."""
    if demands.size == 0:
        return np.zeros((0,))
    u = np.maximum(utilization(demands, cap), 1.0)     # (R,)
    uses = demands > 0
    per_job = np.where(uses, u[None, :], 1.0)
    return per_job.max(axis=1)


def co_run_latency(
    solo: np.ndarray, demands: np.ndarray, cap: np.ndarray
) -> np.ndarray:
    return solo * slowdowns(demands, cap)


def batched_step_latency(works: Sequence[float], marginal: float = 0.3) -> float:
    """Latency of ONE batched model invocation serving ``b = len(works)``
    coalesced reasoning steps (model_service.py).

    Continuous-batching cost model, the ``base + marginal·(b−1)`` shape the
    inference literature measures for decode batching (SPORK / Speculative
    Actions exploit the same sublinearity on the model side): the longest
    member sets the base — the batch is one forward pass per token, so it
    cannot finish before its longest sequence — and every ADDITIONAL member
    adds only ``marginal`` of its solo work (extra rows in the same matmuls
    are close to free on a memory-bound accelerator, but KV traffic and
    padding are not zero):

        L(batch) = max_i w_i + marginal · (Σ_i w_i − max_i w_i)

    Properties the scheduler relies on:
      * b=1 is EXACT: ``L([w]) = w`` — a solo dispatch costs what the
        unbatched runtime charged, which is what keeps ``max_batch=1``
        bit-identical to the pre-service behavior.
      * Sublinear but not free: serial cost Σw is reached only at
        ``marginal=1``; ``marginal=0`` would be the (unphysical) free-batch
        limit.  0 < marginal < 1 ⇒ batching strictly beats the serial queue
        and strictly loses to a second accelerator.
      * Monotone in every member's work and in batch size.
    """
    w = np.asarray(list(works), float)
    if w.size == 0:
        return 0.0
    base = float(w.max())
    return base + marginal * float(w.sum() - base)


def batch_efficiency(b: int, marginal: float = 0.3) -> float:
    """Per-step cost of a size-``b`` batch relative to serial execution, for
    equal-work members: ``(1 + marginal·(b−1)) / b``.  The calibration curve
    behind ``batched_step_latency`` — 1.0 at b=1, approaching ``marginal``
    as b grows (an 8-wide batch at marginal=0.3 costs ~0.39 of serial)."""
    b = max(int(b), 1)
    return (1.0 + marginal * (b - 1)) / b


def marginal_interference(
    cand_solo: float, cand_rho: np.ndarray,
    admitted_solo: np.ndarray, admitted_rho: np.ndarray,
    cap: np.ndarray,
) -> float:
    """ΔI_i(S): candidate's own stretch PLUS the extra stretch it inflicts on
    the already-admitted set (full marginal, §5)."""
    if admitted_rho.size == 0:
        base = np.zeros((0,))
        all_rho = cand_rho[None, :]
        all_solo = np.array([cand_solo])
        new = co_run_latency(all_solo, all_rho, cap)
        return float(new[0] - cand_solo)
    before = co_run_latency(admitted_solo, admitted_rho, cap)
    all_rho = np.concatenate([admitted_rho, cand_rho[None, :]], axis=0)
    all_solo = np.concatenate([admitted_solo, [cand_solo]])
    after = co_run_latency(all_solo, all_rho, cap)
    self_delta = after[-1] - cand_solo
    others_delta = float(np.sum(after[:-1] - before))
    return float(self_delta + others_delta)

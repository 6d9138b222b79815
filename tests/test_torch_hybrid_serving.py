"""The PyTorch port's serving engine on the hybrid family (zamba2: Mamba2 +
shared attention) against the JAX package's, on zamba2-1.2b reduced to 14
layers (two groups of 6 Mamba2 layers, each followed by the shared
attention block, and a tail of 2) at float32.

Both engines get the same weights, bridged through numpy. The port's
engine is teacher-forced with the JAX engine's token stream, and each
step's logits must lie within 1e-4 of JAX's for every active slot; the
prefilled slot states and K/V, and a preempted slot reused by a new
request, are covered on the way. The batched-against-single and agent-loop
tests of tests/test_torch_ssm_serving.py are repeated on this family.

As in tests/test_torch_ssm_serving.py, the JAX engine's conv-state leaves
are cast to f32 before the first request: JAX ``init_ssm_state`` holds
them in bf16 whatever the config's dtype (ROADMAP Queue 3, conv-state
dtype).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.patterns import PatternEngine  # noqa: E402
from repro_torch.core.workload import (  # noqa: E402
    WorkloadConfig, episodes_to_traces, make_episodes,
)
from repro_torch.launch.serve import serve_agent_loop  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

TOL = 1e-4
MAX_LEN = 64
ARCH = "zamba2-1.2b"
N_LAYERS = 14


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    cores (xdist), and this file's many small tensor ops slow down tenfold
    when each process also spreads them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bridged():
    kw = dict(dtype="float32", n_layers=N_LAYERS)
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), **kw)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    np_params = jax.tree.map(np.asarray, JM.init_params(jax.random.key(0), jcfg))
    jparams = jax.tree.map(jnp.asarray, np_params)
    return jcfg, cfg, jparams, M.params_from_numpy(np_params, cfg, device="cpu")


def _engine(bridged):
    _, cfg, _, params = bridged
    return ServingEngine(cfg, params, max_batch=4, max_len=MAX_LEN, device="cpu")


def _jax_engine(bridged):
    jcfg, _, jparams, _ = bridged
    jeng = JaxServingEngine(jcfg, jparams, max_batch=4, max_len=MAX_LEN)
    conv_x, conv_b, conv_c, ssm = jeng.cache["ssm_state"]
    # see the module docstring: the reference's conv states are bf16 until a step
    jeng.cache["ssm_state"] = tuple(a.astype(jnp.float32) for a in (conv_x, conv_b, conv_c)) \
        + (ssm,)
    return jeng


def _close_cache(eng, jeng, slots):
    leaves = list(eng.cache["ssm_state"]) + [eng.cache["k"], eng.cache["v"]]
    jleaves = list(jeng.cache["ssm_state"]) + [jeng.cache["k"], jeng.cache["v"]]
    for leaf, jleaf in zip(leaves, jleaves, strict=True):
        np.testing.assert_allclose(leaf[:, slots].numpy(), np.asarray(jleaf)[:, slots],
                                   atol=TOL, rtol=TOL)


def _forced_step(jeng, eng, jcfg, jparams):
    """One step of both engines on the JAX engine's tokens; checks logits
    and the active slots' states and K/V after the step."""
    active = [s.idx for s in jeng.slots if s.active and not s.done]
    assert active == [s.idx for s in eng.slots if s.active and not s.done]
    want, _ = JM.decode_step(jparams, jcfg, jeng.cache, jnp.asarray(jeng.pending_tokens))
    eng.pending_tokens[:] = jeng.pending_tokens
    cache = {"lengths": eng.cache["lengths"].clone(), "k": eng.cache["k"].clone(),
             "v": eng.cache["v"].clone(),
             "ssm_state": tuple(a.clone() for a in eng.cache["ssm_state"])}
    mask = torch.zeros(eng.max_batch, dtype=torch.bool).index_fill_(0, torch.tensor(active), True)
    got, _ = M.decode_step(eng.params, eng.cfg, cache,
                           torch.as_tensor(eng.pending_tokens, dtype=torch.int64), active=mask)
    jeng.step()
    out = eng.step()
    np.testing.assert_allclose(got[active].numpy(), np.asarray(want)[active],
                               atol=TOL, rtol=TOL)
    assert out == {i: int(torch.argmax(got[i])) for i in active}
    np.testing.assert_array_equal(eng.cache["lengths"].numpy(), np.asarray(jeng.cache["lengths"]))
    _close_cache(eng, jeng, active)


def test_teacher_forced_logits_match_jax(bridged):
    jcfg, cfg, jparams, _ = bridged
    jeng = _jax_engine(bridged)
    eng = _engine(bridged)
    assert eng.cache["k"].shape[0] == M.hybrid_split(cfg)[0] == 2
    requests = [([5, 6, 7, 8], 1, False), ([2, 3] + list(range(10, 27)), 2, True)]
    for prompt, rid, spec in requests:
        assert jeng.add_request(prompt, request_id=rid, speculative=spec) == \
            eng.add_request(prompt, request_id=rid, speculative=spec)
    # prefill: the same first tokens and the same slot states and K/V
    np.testing.assert_array_equal(eng.pending_tokens[:2], jeng.pending_tokens[:2])
    _close_cache(eng, jeng, [0, 1])
    for _ in range(3):
        _forced_step(jeng, eng, jcfg, jparams)
    jeng.preempt(1)
    eng.preempt(1)
    for _ in range(2):
        _forced_step(jeng, eng, jcfg, jparams)
    # a new request reuses the preempted slot over its stale states and rows
    assert jeng.add_request([9, 9, 4], request_id=3) == 1
    assert eng.add_request([9, 9, 4], request_id=3) == 1
    _close_cache(eng, jeng, [1])
    eng.pending_tokens[1] = jeng.pending_tokens[1]
    for _ in range(3):
        _forced_step(jeng, eng, jcfg, jparams)


def test_engine_batched_matches_single(bridged):
    """A batched engine slot must track a standalone prefill+decode loop
    (tests/test_infra.py::test_engine_batched_matches_single), teacher-forced."""
    _, cfg, _, params = bridged
    eng = _engine(bridged)
    eng.add_request([11, 12, 13], request_id=7)       # a neighbour in slot 0
    prompt = [5, 6, 7, 8]
    lg, cache = M.prefill(params, cfg, {"tokens": torch.tensor([prompt])}, max_len=MAX_LEN)
    tok = torch.argmax(lg, -1)
    forced = [int(tok[0])]
    toks_single = []
    for _ in range(6):
        lg, cache = M.decode_step(params, cfg, cache, tok)
        tok = torch.argmax(lg, -1)
        toks_single.append(int(tok[0]))
        forced.append(int(tok[0]))
    slot = eng.add_request(prompt, request_id=1)
    toks_batched = []
    for i in range(6):
        eng.pending_tokens[slot] = forced[i]
        out = eng.step()
        toks_batched.append(out[slot])
    agree = sum(a == b for a, b in zip(toks_batched, toks_single, strict=True))
    assert agree >= 5, (toks_batched, toks_single)


def test_serve_agent_loop_speculates(bridged):
    """The agent loop admits speculative slots on the hybrid engine."""
    _, cfg, _, params = bridged
    pe = PatternEngine(context_len=2, min_support=3).fit(
        episodes_to_traces(make_episodes(WorkloadConfig(seed=1, n_episodes=40))))
    episodes = make_episodes(WorkloadConfig(seed=9, n_episodes=2))
    eng = _engine(bridged)
    _, steps_off, _, spec_off = serve_agent_loop(False, cfg, eng, episodes, pe)
    _, steps_on, hits, spec_on = serve_agent_loop(True, cfg, eng, episodes, pe)
    assert spec_off.admitted == 0 and steps_on > steps_off
    assert spec_on.admitted > 0
    assert spec_on.admitted == spec_on.promotions + spec_on.preemptions
    assert hits == spec_on.promotions
    assert eng.slack() == eng.max_batch

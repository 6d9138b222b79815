"""The PyTorch port's serving engine against the JAX package's.

Both engines get the same weights (qwen2-7b reduced, float32, random
non-zero QKV biases, bridged through numpy). The port's engine is
teacher-forced with the JAX engine's token stream, so every step sees the
same inputs, and each step's logits must lie within 1e-4 of JAX's for every
active slot (logits, not argmax tokens: a near tie would make an
exact-token check flaky). The engine tests of tests/test_infra.py are
mirrored on the port.
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
from repro_torch.core.events import DEFAULT_TOOLS  # noqa: E402
from repro_torch.core.hypothesis import BranchHypothesis, Node, NodeKind  # noqa: E402
from repro_torch.core.patterns import PatternEngine  # noqa: E402
from repro_torch.core.workload import (  # noqa: E402
    WorkloadConfig, episodes_to_traces, make_episodes,
)
from repro_torch.launch.serve import serve_agent_loop  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.spec_serving import SlotSpeculator, render_observation  # noqa: E402

TOL = 1e-4
MAX_LEN = 64


@pytest.fixture(scope="module")
def bridged():
    jcfg = dataclasses.replace(jax_get_config("qwen2-7b").reduced(), dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(), dtype="float32")
    np_params = jax.tree.map(np.asarray, JM.init_params(jax.random.key(0), jcfg))
    rng = np.random.default_rng(0)
    attn = np_params["blocks"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = (0.1 * rng.normal(size=attn[name].shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, np_params)
    return jcfg, cfg, jparams, M.params_from_numpy(np_params, cfg, device="cpu")


def _engine(bridged):
    _, cfg, _, params = bridged
    return ServingEngine(cfg, params, max_batch=4, max_len=MAX_LEN, device="cpu")


def _forced_step(jeng, eng, jcfg, jparams):
    """One step of both engines on the JAX engine's tokens; checks logits."""
    active = [s.idx for s in jeng.slots if s.active and not s.done]
    assert active == [s.idx for s in eng.slots if s.active and not s.done]
    want, _ = JM.decode_step(jparams, jcfg, jeng.cache, jnp.asarray(jeng.pending_tokens))
    eng.pending_tokens[:] = jeng.pending_tokens
    cache = {name: t.clone() for name, t in eng.cache.items()}
    got, _ = M.decode_step(eng.params, eng.cfg, cache,
                           torch.as_tensor(eng.pending_tokens, dtype=torch.int64),
                           active=torch.zeros(eng.max_batch, dtype=torch.bool).index_fill_(
                               0, torch.tensor(active), True))
    jeng.step()
    out = eng.step()
    np.testing.assert_allclose(got[active].numpy(), np.asarray(want)[active],
                               atol=TOL, rtol=TOL)
    assert out == {i: int(torch.argmax(got[i])) for i in active}
    np.testing.assert_array_equal(eng.cache["lengths"].numpy(), np.asarray(jeng.cache["lengths"]))


def test_teacher_forced_logits_match_jax(bridged):
    jcfg, cfg, jparams, _ = bridged
    jeng = JaxServingEngine(jcfg, jparams, max_batch=4, max_len=MAX_LEN)
    eng = _engine(bridged)
    requests = [([5, 6, 7, 8], 1, False), ([2, 3] + list(range(10, 27)), 2, True)]
    for prompt, rid, spec in requests:
        assert jeng.add_request(prompt, request_id=rid, speculative=spec) == \
            eng.add_request(prompt, request_id=rid, speculative=spec)
    # prefill logits agree: the JAX engine's first token is the port's argmax too
    np.testing.assert_array_equal(eng.pending_tokens[:2], jeng.pending_tokens[:2])
    for _ in range(3):
        _forced_step(jeng, eng, jcfg, jparams)
    jeng.preempt(1)
    eng.preempt(1)
    for _ in range(2):
        _forced_step(jeng, eng, jcfg, jparams)
    # a new request reuses the preempted slot over its stale rows
    assert jeng.add_request([9, 9, 4], request_id=3) == 1
    assert eng.add_request([9, 9, 4], request_id=3) == 1
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


def test_engine_speculative_promote_and_preempt(bridged):
    """tests/test_infra.py::test_engine_speculative_promote_and_preempt on the port."""
    _, cfg, _, _ = bridged
    eng = _engine(bridged)
    spec = SlotSpeculator(eng, budget_slots=2)
    n = Node(0, NodeKind.TOOL, "search", DEFAULT_TOOLS["search"].level,
             DEFAULT_TOOLS["search"].rho, 1.0)
    h = BranchHypothesis(77, [n], [], q=0.9, context_key=())
    spec.admit([(h, 1.0)], history_prompt=[2, 3])
    assert spec.spec_slots_used() == 1
    obs = render_observation("search", {}, "pred:77:0", cfg.vocab_size)
    got = spec.match_and_promote(obs, request_id=5)
    assert got is not None
    assert not eng.slots[got].speculative
    spec.admit([(h, 1.0)], history_prompt=[2, 3])
    spec.ensure_authoritative_room(len(eng.free_slots()) + 1)
    assert spec.spec_slots_used() == 0


def test_engine_rejects_params_on_another_device(bridged):
    _, cfg, _, params = bridged
    with pytest.raises(ValueError, match="params are on"):
        ServingEngine(cfg, params, max_batch=2, max_len=16, device="meta")


def test_serve_agent_loop_speculates(bridged):
    """The agent loop admits speculative slots, which run speculative prefills."""
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

"""The port's hybrid family (zamba2: Mamba2 + shared attention) with an
int8 KV cache, against the JAX package's ``prefill`` and ``decode_step``.

zamba2-1.2b reduced (one group of 6 Mamba2 layers and the shared block)
and at ``n_layers=14`` (two groups and a tail of 2), JAX params bridged
through numpy. The JAX package's hybrid ``prefill`` returns the int8 K/V as
(values int8 (G, B, max_len, KV, hd), scales f32 (G, B, max_len, KV)) pairs
and its ``decode_step`` reads them; its ``init_cache`` allocates plain
``cfg.dtype`` arrays that its own decode cannot read, so its engine cannot
hold this cache. The port allocates the prefill's pairs, and JAX's model
calls are the reference throughout.

Tolerances: log-softmax within 2e-2 (tests/test_torch_int8_kv.py's bound:
a last-bit difference in K can move one quantized value by one step). The
int8 values agree except where a K or V element sits on a rounding
boundary: there they differ by one step, in at most 1 position in 4096
of a K or V leaf (measured: at most 1 of 8192 on the reduced model, 3 of
16384 at 14 layers; ``kv_quantize`` itself is bit-identical to JAX's,
tests/test_torch_int8_kv.py). Scales, and the SSM states of a prefill,
within 1e-4 (atol and rtol), the float32 tolerance of
tests/test_torch_hybrid_models.py; the states after decode steps within
1e-3, since the shared block reads the int8 values, and one value a step
apart moves the attention output, hence the states of the layers after it
(they need 1.45e-4 as atol and rtol on the 14-layer model). In bfloat16 the two
packages' roundings drift apart by more than 2e-2 in log-softmax with a
bf16 cache too (up to 0.026 on the reduced model and 0.033 at 14 layers,
0.031 already at the prefill, before any int8 read), so the bf16 bound is
the JAX run's own distance from its float32 run on the same weights, over
the run (0.030 and 0.049).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_bodies as bodies  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.patterns import PatternEngine  # noqa: E402
from repro_torch.core.workload import (  # noqa: E402
    WorkloadConfig, episodes_to_traces, make_episodes,
)
from repro_torch.launch.dist import spawn  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.serve import serve_agent_loop  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ARCH = "zamba2-1.2b"
DEPTHS = [None, 14]   # .reduced() (G = 1, no tail) and G = 2 with a tail of 2
IDS = ["reduced", "14-layers"]
LSM_TOL = 2e-2        # log-softmax, as tests/test_torch_int8_kv.py
F32_TOL = 1e-4        # scales and states, as tests/test_torch_hybrid_models.py
STATE_TOL = 1e-3      # states after decode steps, which read the int8 values
MAX_LEN = 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    cores (xdist), and this file's many small tensor ops slow down tenfold
    when each process also spreads them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="float32", n_layers=None, **kw):
    kw = {"kv_cache_dtype": "int8", "dtype": dtype, **kw}
    if n_layers is not None:
        kw["n_layers"] = n_layers
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _np_params(n_layers, seed=0):
    jcfg, _ = _cfgs(n_layers=n_layers, attn_impl="jnp")
    return jax.tree.map(np.asarray, JM.init_params(jax.random.key(seed), jcfg))


def _bridge(n_layers, dtype="float32", np_params=None):
    """(JAX config, port config, JAX params, port params) in ``dtype`` from
    one float32 draw: in bfloat16 each leaf that JAX's bf16 init holds in
    bf16 is the f32 weight rounded."""
    jcfg, cfg = _cfgs(dtype, n_layers, attn_impl="jnp")
    np_params = _np_params(n_layers) if np_params is None else np_params
    if dtype != "float32":
        structs = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg))
        np_params = jax.tree.map(lambda a, s: np.asarray(jnp.asarray(a).astype(s.dtype)),
                                 np_params, structs)
    return (jcfg, dataclasses.replace(cfg, attn_impl="auto"),
            jax.tree.map(jnp.asarray, np_params), M.params_from_numpy(np_params, cfg,
                                                                      device="cpu"))


@pytest.fixture(scope="module", params=DEPTHS, ids=IDS)
def bridged(request):
    return _bridge(request.param)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape).astype(np.int32)


def _lsm(x):
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, np.float32))
    return torch.log_softmax(x.float(), dim=-1).numpy()


def _mesh(n_model):
    return M.MeshContext(make_local_mesh(n_model, device="cpu"), ("data",), "model", n_model, 1)


def _run_both(bridged, prompt, feed, mesh_info=None):
    """JAX's prefill + decode_steps and the port's on the same tokens:
    (JAX log-softmaxes, port log-softmaxes, JAX cache, port cache)."""
    jcfg, cfg, jparams, params = bridged
    if mesh_info is not None:
        cfg = dataclasses.replace(cfg, sharded_decode_attn=True)
    want, jcache = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)}, max_len=MAX_LEN)
    got, cache = M.prefill(params, cfg, {"tokens": torch.from_numpy(prompt).long()},
                           max_len=MAX_LEN, mesh_info=mesh_info)
    wants, gots = [_lsm(want)], [_lsm(got)]
    for tok in feed:
        want, jcache = JM.decode_step(jparams, jcfg, jcache, jnp.asarray(tok))
        got, cache = M.decode_step(params, cfg, cache, torch.from_numpy(tok).long(),
                                   mesh_info=mesh_info)
        wants.append(_lsm(want))
        gots.append(_lsm(got))
    return np.stack(wants), np.stack(gots), jcache, cache


def _assert_values_close(values, jvalues):
    """int8 values equal but where an input sat on a rounding boundary:
    there one step apart, in at most 1 position in 4096 of a K or V leaf."""
    diff = np.abs(values.numpy().astype(np.int32) - np.asarray(jvalues, np.int32))
    assert diff.max() <= 1 and np.count_nonzero(diff) <= diff.size // 4096, diff.sum()


def _assert_cache_close(cache, jcache, state_tol=F32_TOL):
    for name in ("k", "v"):
        (q, s), (jq, js) = cache[name], jcache[name]
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert tuple(q.shape) == jq.shape and tuple(s.shape) == js.shape
        _assert_values_close(q, jq)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=F32_TOL, rtol=F32_TOL)
    for leaf, jleaf in zip(cache["ssm_state"], jcache["ssm_state"], strict=True):
        np.testing.assert_allclose(leaf.float().numpy(), np.asarray(jleaf, np.float32),
                                   atol=state_tol, rtol=state_tol)
    np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(jcache["lengths"]))


def test_prefill_and_decode_match_jax(bridged):
    _, cfg, _, _ = bridged
    prompt, feed = _tokens(cfg, (2, 11), seed=4), _tokens(cfg, (6, 2), seed=5)
    for steps, state_tol in ((0, F32_TOL), (6, STATE_TOL)):   # the prefill, 6 steps on
        wants, gots, jcache, cache = _run_both(bridged, prompt, feed[:steps])
        np.testing.assert_allclose(gots, wants, atol=LSM_TOL, rtol=0)
        _assert_cache_close(cache, jcache, state_tol)
    assert cache["lengths"].tolist() == [17, 17]


@pytest.mark.parametrize("n_layers", DEPTHS, ids=IDS)
def test_bfloat16_log_softmax_matches_jax(n_layers):
    np_params = _np_params(n_layers)
    cfg = _cfgs()[1]
    prompt, feed = _tokens(cfg, (2, 11), seed=4), _tokens(cfg, (6, 2), seed=5)
    wants, gots, _, cache = _run_both(_bridge(n_layers, "bfloat16", np_params), prompt, feed)
    assert cache["k"][0].dtype == torch.int8 and cache["ssm_state"][0].dtype == torch.bfloat16
    gap = np.abs(gots - wants).max(axis=(1, 2))
    # the reference's own bf16 error over the run: JAX bf16 against JAX f32
    f32, _, _, _ = _run_both(_bridge(n_layers, "float32", np_params), prompt, feed)
    own = np.abs(wants - f32).max(axis=(1, 2))
    assert gap.max() <= own.max(), (gap, own)


@pytest.mark.parametrize("n_model", [2, 4])
def test_sharded_decode_matches_jax(bridged, n_model):
    _, cfg, _, _ = bridged
    prompt, feed = _tokens(cfg, (2, 7), seed=6), _tokens(cfg, (4, 2), seed=7)
    wants, gots, jcache, cache = _run_both(bridged, prompt, feed, mesh_info=_mesh(n_model))
    np.testing.assert_allclose(gots, wants, atol=LSM_TOL, rtol=0)
    _assert_cache_close(cache, jcache, STATE_TOL)


@pytest.mark.parametrize("n_model", [None, 2], ids=["unsharded", "sharded-x2"])
def test_decode_inactive_rows_keep_values_scales_state_and_length(bridged, n_model):
    _, cfg, _, params = bridged
    mesh_info = None
    if n_model:
        cfg, mesh_info = dataclasses.replace(cfg, sharded_decode_attn=True), _mesh(n_model)
    prompt = torch.from_numpy(_tokens(cfg, (2, 5), seed=8)).long()
    _, cache = M.prefill(params, cfg, {"tokens": prompt}, max_len=16)
    before = [t.clone() for t in cache["ssm_state"] + cache["k"] + cache["v"]]
    _, cache = M.decode_step(params, cfg, cache, prompt[:, -1],
                             active=torch.tensor([True, False]), mesh_info=mesh_info)
    assert cache["lengths"].tolist() == [6, 5]
    after = cache["ssm_state"] + cache["k"] + cache["v"]
    for leaf, old in zip(after, before, strict=True):
        assert torch.equal(leaf[:, 1], old[:, 1])
    for leaf, old in zip(cache["ssm_state"], before[:4], strict=True):
        assert not torch.equal(leaf[:, 0], old[:, 0])
    for leaf, old in zip(cache["k"] + cache["v"], before[4:], strict=True):
        assert not torch.equal(leaf[:, 0, 5], old[:, 0, 5])   # row 5 written in place


@pytest.mark.parametrize("n_layers", DEPTHS + ["full"], ids=IDS + ["full-width"])
def test_init_cache_has_jax_prefill_layout(n_layers):
    """init_cache's leaves have the shapes and dtypes of jax.eval_shape of
    the JAX package's hybrid prefill cache (not of its init_cache)."""
    if n_layers == "full":
        jcfg = dataclasses.replace(jax_get_config(ARCH), kv_cache_dtype="int8")
        cfg = dataclasses.replace(get_config(ARCH), kv_cache_dtype="int8")
    else:
        jcfg, cfg = _cfgs("bfloat16", n_layers)
    batch, max_len, prompt = 3, 64, 9
    jparams = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg))
    _, jcache = jax.eval_shape(
        lambda p, t: JM.prefill(p, jcfg, {"tokens": t}, max_len=max_len), jparams,
        jax.ShapeDtypeStruct((batch, prompt), jnp.int32))
    cache = M.init_cache(cfg, batch, max_len, device="meta" if n_layers == "full" else "cpu")

    def layout(tree):
        leaves = jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
        return [(tuple(a.shape), str(a.dtype).removeprefix("torch.")) for a in leaves]

    assert layout(cache) == layout(jcache)
    assert isinstance(cache["k"], tuple) and cache["k"][0].dtype == torch.int8


@pytest.fixture(scope="module")
def bridged14():
    return _bridge(14)


def test_engine_slot_matches_single_and_jax(bridged14):
    """A batched engine slot, teacher-forced, against a single-sequence
    prefill + decode_step of the port (log-softmax within 1e-4) and of the
    JAX package (2e-2); then a preempted slot taken by a new request holds
    that request's prefilled values and scales, bit for bit."""
    jcfg, cfg, jparams, params = bridged14
    eng = ServingEngine(cfg, params, max_batch=4, max_len=MAX_LEN, device="cpu")
    assert eng.cache["k"][0].dtype == torch.int8 and eng.cache["k"][0].shape[0] == 2
    eng.add_request([11, 12, 13], request_id=7)                  # a neighbour in slot 0
    prompt = [5, 6, 7, 8]
    slot = eng.add_request(prompt, request_id=1, speculative=True)
    toks = _tokens(cfg, (6,), seed=9)
    lg, cache = M.prefill(params, cfg, {"tokens": torch.tensor([prompt])}, max_len=MAX_LEN)
    jlg, jcache = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray([prompt])}, max_len=MAX_LEN)
    assert eng.pending_tokens[slot] == int(torch.argmax(lg[0]))
    for tok in toks:
        eng.pending_tokens[slot] = tok
        snapshot = {"lengths": eng.cache["lengths"].clone(),
                    "k": tuple(t.clone() for t in eng.cache["k"]),
                    "v": tuple(t.clone() for t in eng.cache["v"]),
                    "ssm_state": tuple(t.clone() for t in eng.cache["ssm_state"])}
        active = torch.tensor([s.active and not s.done for s in eng.slots])
        batched, _ = M.decode_step(params, cfg, snapshot,
                                   torch.as_tensor(eng.pending_tokens, dtype=torch.int64),
                                   active=active)
        out = eng.step()
        lg, cache = M.decode_step(params, cfg, cache, torch.tensor([int(tok)]))
        jlg, jcache = JM.decode_step(jparams, jcfg, jcache, jnp.asarray([tok]))
        assert out[slot] == int(torch.argmax(batched[slot]))
        np.testing.assert_allclose(_lsm(batched[slot]), _lsm(lg[0]), atol=F32_TOL, rtol=0)
        np.testing.assert_allclose(_lsm(batched[slot]), _lsm(jlg[0]), atol=LSM_TOL, rtol=0)
    for name in ("k", "v"):
        _assert_values_close(eng.cache[name][0][:, slot], cache[name][0][:, 0])
        _assert_values_close(eng.cache[name][0][:, slot], jcache[name][0][:, 0])
    eng.preempt(slot)
    assert eng.add_request([9, 9, 4], request_id=3) == slot
    _, fresh = M.prefill(params, cfg, {"tokens": torch.tensor([[9, 9, 4]])}, max_len=MAX_LEN)
    for name in ("k", "v"):
        for big, small in zip(eng.cache[name], fresh[name], strict=True):
            assert torch.equal(big[:, slot], small[:, 0])
    assert eng.cache["lengths"].tolist()[slot] == 3


def test_serve_agent_loop_speculates_on_an_int8_cache(bridged14):
    """The speculative agent loop admits, promotes and preempts slots of an
    engine whose hybrid cache is int8."""
    _, cfg, _, params = bridged14
    pe = PatternEngine(context_len=2, min_support=3).fit(
        episodes_to_traces(make_episodes(WorkloadConfig(seed=1, n_episodes=40))))
    episodes = make_episodes(WorkloadConfig(seed=9, n_episodes=2))
    eng = ServingEngine(cfg, params, max_batch=4, max_len=64, device="cpu")
    _, steps_off, _, spec_off = serve_agent_loop(False, cfg, eng, episodes, pe)
    _, steps_on, hits, spec_on = serve_agent_loop(True, cfg, eng, episodes, pe)
    assert spec_off.admitted == 0 and steps_on > steps_off
    assert spec_on.admitted > 0
    assert spec_on.admitted == spec_on.promotions + spec_on.preemptions
    assert hits == spec_on.promotions
    assert eng.slack() == eng.max_batch
    assert eng.cache["k"][0].dtype == eng.cache["v"][0].dtype == torch.int8


def test_dist_mesh_decode_matches_jax(bridged14):
    """The sequence-sharded decode over a mesh of 2 gloo ranks on the CPU
    (each rank holding max_len / 2 rows of every group's values and
    scales) against JAX's unsharded int8 decode, and against the port's
    local mesh of 2 shards."""
    _, cfg, jparams, _ = bridged14
    np_params = jax.tree.map(np.asarray, jparams)
    prompt = _tokens(cfg, (2, 7), seed=6).astype(np.int64)
    feed = _tokens(cfg, (4, 2), seed=7).astype(np.int64)
    ranks = spawn(bodies.hybrid_int8_decode, 2, device="cpu", model_parallel=2,
                  args=(np_params, prompt, feed, MAX_LEN))
    wants, local, _, _ = _run_both(bridged14, prompt.astype(np.int32), feed.astype(np.int32),
                                   mesh_info=_mesh(2))
    for r in ranks:
        assert r["rows"] == (0, 2)
        got = _lsm(r["logits"])
        np.testing.assert_allclose(got, wants[1:], atol=LSM_TOL, rtol=0)
        np.testing.assert_allclose(got, local[1:], atol=F32_TOL, rtol=0)
        # values and scales of 2 groups, max_len / 2 rows on each rank
        assert [a.shape for a in r["after"]] == [(2, 2, MAX_LEN // 2, 4, 32),
                                                 (2, 2, MAX_LEN // 2, 4)] * 2
        assert r["after"][0].dtype == np.int8

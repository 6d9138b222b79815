"""The port's training side against the JAX package's, on the CPU.

Both packages get the same numpy inputs and, for the models, the same
weights: the JAX package's params as numpy, bridged into the port by
``params_from_numpy`` (JAX stacks the blocks on a leading axis; the port
keeps a list of layers, which the comparisons stack back). The JAX side
runs its jnp paths (``JAX_PLATFORMS=cpu``), which are what its
``train_step`` differentiates; the port runs autograd through its plain
versions. Tolerances:
* losses and grad norms: 1e-5 relative;
* gradients: per leaf, 1e-4 relative and 1e-4 of the leaf's largest
  |gradient| absolute (the same arithmetic in another order);
* updated parameters: everywhere within 2 x the learning rates' sum, and
  after one step within 1e-5 relative and 1e-6 absolute where the step's
  gradient is above 1e-6 in magnitude. Adam moves each parameter by about
  lr whatever the gradient's size, so the update turns on a gradient's
  last bits where it is near Adam's epsilon (1e-8), and after several
  steps on its relative error wherever it is small against the leaf's
  largest (the gradients agree to 1e-4 of that): such a parameter may move
  by up to 2 x lr in one package and not the other. After three steps the
  per-step losses and grad norms (1e-5) carry the tight comparison;
* the optimizer alone, on one numpy tree: 1e-6.
Torch runs on one intra-op thread (the suite runs under xdist).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import batch_at as jax_batch_at  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import loss as jloss  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_at  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.training import loss as tloss  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402

REL = 1e-5
GRAD_TOL = 1e-4
OPT_CFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
ARCHS = ["qwen2-7b", "musicgen-medium", "mixtral-8x7b", "mamba2-2.7b", "zamba2-1.2b"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype="float32", **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32", **kw)
    return jcfg, cfg


def _bridge(jcfg, cfg, seed=0):
    np_params = jax.tree.map(np.asarray, JM.init_params(jax.random.key(seed), jcfg))
    return jax.tree.map(jnp.asarray, np_params), M.params_from_numpy(np_params, cfg, "cpu")


def _batches(jcfg, cfg, n, seq=16, batch=2):
    """The same numpy batches from each package's copy of the pipeline."""
    out = []
    for step in range(n):
        jb = jax_batch_at(jcfg, JDataConfig(seed=3, seq_len=seq + 1, global_batch=batch), step)
        tb = batch_at(cfg, DataConfig(seed=3, seq_len=seq + 1, global_batch=batch), step)
        assert jb.keys() == tb.keys() and all(np.array_equal(jb[k], tb[k]) for k in jb)
        out.append(({k: jnp.asarray(v) for k, v in jb.items()},
                    {k: torch.from_numpy(v) for k, v in tb.items()}))
    return out


def _stacked(tree):
    """The port's tree in the JAX package's layout (blocks stacked), as numpy."""
    def stack(leaves):
        if isinstance(leaves[0], dict):
            return {k: stack([x[k] for x in leaves]) for k in leaves[0]}
        return np.stack([x.detach().float().numpy() for x in leaves])

    out = {k: (v.detach().float().numpy() if isinstance(v, torch.Tensor) else _stacked(v))
           for k, v in tree.items() if k != "blocks"}
    if "blocks" in tree:
        out["blocks"] = stack(tree["blocks"])
    return out


def _pairs(port_tree, jax_tree):
    """(key, port leaf, JAX leaf) as numpy f32, over the JAX tree's leaves."""
    got = dict(jax.tree_util.tree_flatten_with_path(_stacked(port_tree))[0])
    want = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert len(got) == len(want)
    return [(jax.tree_util.keystr(p), got[p], np.asarray(w, np.float32)) for p, w in want]


def _rel_close(got, want, rel=REL):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * max(abs(want), 1e-30), (got, want)


def _grads_close(port_grads, jax_grads):
    for key, g, w in _pairs(port_grads, jax_grads):
        atol = GRAD_TOL * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=atol, err_msg=key)


def _params_close(port_params, jax_params, jax_grads, lr_sum):
    """Within 2 x the learning rates' sum everywhere; after one step (given
    its gradients), within 1e-5 relative and 1e-6 absolute where |g| > 1e-6."""
    grads = None if jax_grads is None else dict(
        (jax.tree_util.keystr(p), np.asarray(g))
        for p, g in jax.tree_util.tree_flatten_with_path(jax_grads)[0])
    for key, p, w in _pairs(port_params, jax_params):
        assert np.abs(p - w).max() <= 2 * lr_sum + 1e-6, key
        if grads is not None:
            big = np.abs(grads[key]) > 1e-6
            np.testing.assert_allclose(p[big], w[big], rtol=REL, atol=1e-6, err_msg=key)


# ---- loss and optimizer ---------------------------------------------------

def test_softmax_xent_matches_jax_with_padded_vocab_and_masked_labels():
    rng = np.random.default_rng(0)
    vocab, padded = 50, 64
    logits = rng.normal(size=(3, 7, padded)).astype(np.float32) * 3
    logits[..., vocab:] = -1e30                      # the padded tail, as lm_logits masks it
    labels = rng.integers(0, vocab, size=(3, 7)).astype(np.int32)
    labels[0, :2] = -1                               # masked: negative ...
    labels[1, 3] = vocab + 5                         # ... in the padded tail ...
    labels[2, 6] = padded + 9                        # ... and past the padded vocab
    want_loss, want_n = jloss.softmax_xent(jnp.asarray(logits), jnp.asarray(labels), vocab)
    loss, n = tloss.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels), vocab)
    assert int(n) == int(want_n) == 21 - 4
    _rel_close(loss, want_loss)
    none_valid = -np.ones((2, 3), np.int32)
    loss0, n0 = tloss.softmax_xent(torch.from_numpy(logits[:2, :3]), torch.from_numpy(none_valid),
                                   vocab)
    assert int(n0) == 1 and float(loss0) == 0.0


def test_lr_schedule_matches_jax():
    for kw in (dict(lr=3e-4), dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.2)):
        jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
        assert jc._asdict() == tc._asdict()
        for step in range(121):
            want = jopt.lr_at(jnp.asarray(step, jnp.int32), jc)
            got = topt.lr_at(torch.tensor(step, dtype=torch.int32), tc)
            assert got.dtype == torch.float32
            _rel_close(got, want, rel=1e-6)


def _opt_tree(seed):
    """A numpy tree in the JAX layout (blocks stacked on axis 0) and the
    port's (a list of layers), with big, small and zero entries."""
    rng = np.random.default_rng(seed)
    stacked = {
        "embed": rng.normal(size=(6, 4)).astype(np.float32),
        "blocks": {"w": rng.normal(size=(3, 4, 5)).astype(np.float32),
                   "ln": rng.normal(size=(3, 4)).astype(np.float32)},
        "final_norm": rng.normal(size=(4,)).astype(np.float32),
    }
    stacked["blocks"]["w"][0, 0, :] = 0.0
    return stacked


def _unstack(tree):
    out = {k: torch.from_numpy(v.copy()) for k, v in tree.items() if k != "blocks"}
    n = next(iter(tree["blocks"].values())).shape[0]
    out["blocks"] = [{k: torch.from_numpy(v[i].copy()) for k, v in tree["blocks"].items()}
                     for i in range(n)]
    return out


@pytest.mark.parametrize("grad_scale", [1.0, 1e-3])   # clipped, and not
def test_global_norm_and_apply_updates_match_jax(grad_scale):
    params, grads = _opt_tree(1), jax.tree.map(lambda a: a * grad_scale, _opt_tree(2))
    grads["blocks"]["w"][1, 2, 3] = 3e-9                   # below Adam's epsilon
    jc, tc = jopt.AdamWConfig(**OPT_CFG), topt.AdamWConfig(**OPT_CFG)
    jp, js = jax.tree.map(jnp.asarray, params), jopt.init_opt_state(jax.tree.map(jnp.asarray,
                                                                                 params))
    tp, tg = _unstack(params), _unstack(grads)
    ts = topt.init_opt_state(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    _rel_close(topt.global_norm(tg), jopt.global_norm(jax.tree.map(jnp.asarray, grads)),
               rel=1e-6)
    for _ in range(3):                                     # the same gradients, three steps
        jp, js, jm = jopt.apply_updates(jp, jax.tree.map(jnp.asarray, grads), js, jc)
        tp, ts, tm = topt.apply_updates(tp, tg, ts, tc)
        _rel_close(tm["grad_norm"], jm["grad_norm"], rel=1e-6)
        _rel_close(tm["lr"], jm["lr"], rel=1e-6)
    assert int(ts["step"]) == 3
    for tree_t, tree_j in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for key, g, w in _pairs(tree_t, tree_j):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=key)


# ---- the train step on reduced models --------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def arch_run(request):
    """Three JAX train steps on a reduced arch at f32 (the metrics and the
    params after each) and the first step's loss_fn gradients, with the
    bridged start and the batches."""
    arch = request.param
    jcfg, cfg = _cfgs(arch)
    jparams, params = _bridge(jcfg, cfg)
    batches = _batches(jcfg, cfg, 3)
    jc = jopt.AdamWConfig(**OPT_CFG)
    step = jax.jit(lambda p, s, b: jsteps.train_step(p, s, b, cfg=jcfg, opt_cfg=jc))
    (_, aux), grads = jax.value_and_grad(lambda p, b: jsteps.loss_fn(p, jcfg, b), has_aux=True)(
        jparams, batches[0][0])
    jp, js, record = jparams, jopt.init_opt_state(jparams), []
    for jb, _ in batches:
        jp, js, m = step(jp, js, jb)
        record.append({"metrics": m, "params": jp})
    return arch, cfg, params, batches, record, aux, grads


def test_loss_and_grads_match_jax(arch_run):
    arch, cfg, params, batches, _, aux, jax_grads = arch_run
    total, metrics, grads = tsteps.loss_and_grads(params, cfg, batches[0][1])
    _rel_close(metrics["loss"], aux["loss"])
    if arch == "mixtral-8x7b":
        assert float(metrics["aux_loss"]) > 0
        _rel_close(metrics["aux_loss"], aux["aux_loss"])
    assert int(metrics["n_tokens"]) == int(aux["n_tokens"])
    _grads_close(grads, jax_grads)
    if arch == "musicgen-medium":                # fed embeddings: the token embedding is unused
        assert not grads["embed"].any()


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_matches_jax(arch_run, n_steps):
    _, cfg, params, batches, record, _, jax_grads = arch_run
    params = jax.tree.map(torch.clone, params)
    tc = topt.AdamWConfig(**OPT_CFG)
    state = topt.init_opt_state(params)
    lr_sum = 0.0
    for i in range(n_steps):
        params, state, m = tsteps.train_step(params, state, batches[i][1], cfg=cfg, opt_cfg=tc)
        for key in ("loss", "aux_loss", "grad_norm", "lr"):
            _rel_close(m[key], record[i]["metrics"][key])
        lr_sum += float(m["lr"])
    assert int(state["step"]) == n_steps
    _params_close(params, record[n_steps - 1]["params"],
                  jax_grads if n_steps == 1 else None, lr_sum)


def test_microbatches_match_jax_scan():
    _microbatches_match_jax_scan("qwen2-7b")


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_microbatches_match_jax_scan_on_the_ssm_families(arch):
    """The same for the Mamba2 and hybrid families, whose gradients run
    through the SSD scan's backward."""
    _microbatches_match_jax_scan(arch)


def _microbatches_match_jax_scan(arch):
    jcfg, cfg = _cfgs(arch)
    jparams, params = _bridge(jcfg, cfg, seed=1)
    (jb, tb), = _batches(jcfg, cfg, 1, batch=4)
    jc, tc = jopt.AdamWConfig(**OPT_CFG), topt.AdamWConfig(**OPT_CFG)
    jp, _, jm = jax.jit(lambda p, s, b: jsteps.train_step(
        p, s, b, cfg=jcfg, opt_cfg=jc, microbatches=2))(jparams, jopt.init_opt_state(jparams), jb)
    tp, _, tm = tsteps.train_step(params, topt.init_opt_state(params), tb, cfg=cfg, opt_cfg=tc,
                                  microbatches=2)
    for key in ("loss", "grad_norm", "n_tokens"):
        _rel_close(tm[key], jm[key])
    grads = jax.jit(jax.grad(lambda p, b: jsteps.loss_fn(p, jcfg, b)[0]))(jparams, jb)
    _params_close(tp, jp, grads, float(tm["lr"]))


@pytest.mark.parametrize("arch", ["qwen2-7b", "zamba2-1.2b", "mamba2-2.7b"])
def test_remat_gives_the_same_gradients(arch):
    """cfg.remat recomputes each block (each Mamba2 layer of the hybrid) in
    the backward pass: the gradients are equal to those without it."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             batch_at(cfg, DataConfig(seed=5, seq_len=17, global_batch=2), 0).items()}
    _, m0, g0 = tsteps.loss_and_grads(params, cfg, batch)
    _, m1, g1 = tsteps.loss_and_grads(params, dataclasses.replace(cfg, remat=True), batch)
    assert torch.equal(m0["loss"], m1["loss"])
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1), strict=True):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_head_padding_grads_stay_zero():
    """Padded wo rows receive zero gradient (exact semantics forever): the
    twin of tests/test_perf_features.py's."""
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(),
                              n_heads=3, n_kv_heads=3, head_dim=16, d_model=48,
                              head_pad_multiple=4)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    opt = topt.init_opt_state(params)
    p2, _, _ = tsteps.train_step(params, opt, batch, cfg=cfg,
                                 opt_cfg=topt.AdamWConfig(total_steps=5, warmup_steps=1))
    hd = cfg.resolved_head_dim
    for blk in p2["blocks"]:
        assert blk["attn"]["wo"][3 * hd:, :].float().abs().max() == 0.0


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-2.7b"])
def test_prefill_and_serve_step_match_jax(arch):
    """steps.prefill_step, then steps.serve_step fed back its own int32
    tokens for three steps, against JAX's: the same greedy tokens and
    lengths, and the logits within 1e-4."""
    jcfg, cfg = _cfgs(arch)
    jparams, params = _bridge(jcfg, cfg)
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jnxt, jcache = jsteps.prefill_step(jparams, {"tokens": jnp.asarray(prompt)}, cfg=jcfg,
                                       max_len=16)
    nxt, cache = tsteps.prefill_step(params, {"tokens": torch.from_numpy(prompt)}, cfg=cfg,
                                     max_len=16)
    assert nxt.dtype == torch.int32
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    for _ in range(3):
        jnxt, jlogits, jcache = jsteps.serve_step(jparams, jcache, jnxt, cfg=jcfg)
        nxt, logits, cache = tsteps.serve_step(params, cache, nxt, cfg=cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(jcache["lengths"]))


def test_training_reduces_loss():
    """100 steps on the bigram stream must actually learn: the twin of
    tests/test_models.py::test_training_reduces_loss, through the port's
    CLI entry point on the CPU."""
    from repro_torch.launch.train import train
    _, _, losses = train("granite-8b", reduced=True, steps=100, seq_len=64,
                         global_batch=8, log_every=0, lr=3e-3, device="cpu")
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_ssm_training_reduces_loss():
    """Reduced mamba2-2.7b, 100 steps through the CLI's entry point on the
    CPU (two chunks of 32 per sequence): the twin of chip_smoke's run on
    the card through the SSD kernels."""
    from repro_torch.launch.train import train
    _, _, losses = train("mamba2-2.7b", reduced=True, steps=100, seq_len=64,
                         global_batch=8, log_every=0, lr=3e-3, device="cpu")
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])

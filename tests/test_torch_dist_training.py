"""Training over a mesh of processes (gloo ranks on the CPU): the
data-parallel train step, ``train(use_mesh=True)``, the int8
error-feedback gradient sync and the elastic checkpoint restore, against
the JAX package and the port's single-process paths.

* Reduced qwen2-7b at f32 over 2 data-parallel ranks, with labels masked
  so that the ranks' token counts differ: each step's loss, aux loss, grad
  norm and learning rate within 1e-5 of the single-process port's and of
  JAX's ``train_step`` on the global batch, and the params after one step
  as tests/test_torch_training.py holds them (within 2 x lr everywhere,
  1e-5 relative where the gradient exceeds 1e-6); with 2 microbatches too.
* Reduced mixtral-8x7b under a (2, 2) mesh (the experts over the model
  axis, the aux loss per batch shard) against JAX's ``train_step`` with
  ``mesh_info`` on a (2, 2) mesh of 4 host devices (a subprocess, as
  tests/test_perf_features.py runs its meshes), held the same way.
* ``launch.train.train(use_mesh=True, device="cpu")``, reduced granite-8b
  (bf16), 6 steps on 2 ranks: the first loss within 1e-6 of
  ``use_mesh=False``'s, the others within 1e-4 (the bf16 gradients'
  rounding), the
  ranks' params equal, and a run resumed onto the mesh from the step-3
  checkpoint equal to the uninterrupted one, bit for bit.
* The cases of tests/test_compression.py: error feedback unbiased over
  steps, the round trip's error bound, a 4-pod sync within 2 % of the mean
  with every pod equal, ``dcn_bytes``; and quantize_ef bit for bit
  against JAX's.
* The twin of tests/test_infra.py::test_elastic_restore_across_meshes: a
  reduced MoE model's state saved from 4 ranks (one expert each), restored
  onto 2 (two each), every leaf bitwise its block.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_bodies as bodies  # noqa: E402
from repro.training import compression as JC  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402
from repro_torch.checkpoint import checkpoint as ck  # noqa: E402
from repro_torch.launch.dist import spawn  # noqa: E402
from repro_torch.training import compression as C  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from test_torch_training import (  # noqa: E402
    OPT_CFG, _batches, _bridge, _cfgs, _params_close, _rel_close,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("loss", "aux_loss", "grad_norm", "lr")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masked_batch(jcfg, cfg, batch=4, seq=16):
    """A batch of ``batch`` rows whose first rows lose most of their
    labels (negative, or past the vocabulary): the data-parallel ranks'
    token counts differ."""
    (jb, tb), = _batches(jcfg, cfg, 1, seq=seq, batch=batch)
    labels = tb["labels"].numpy().copy()
    labels[0, :11] = -1
    labels[1, 3] = cfg.vocab_size + 5
    out = {"tokens": tb["tokens"].numpy().astype(np.int64), "labels": labels.astype(np.int64)}
    return out, {k: jnp.asarray(v) for k, v in out.items()}


def _np_tree(jparams):
    return jax.tree.map(np.asarray, jparams)


def _jax_steps(jparams, jcfg, jbatch, n, microbatches=1, mesh_info=None):
    """JAX's train_step n times: each step's metrics, the params after
    each step and the first step's gradients (the microbatches' mean, as
    the step takes it)."""
    import functools
    jc = jopt.AdamWConfig(**OPT_CFG)
    state = jopt.init_opt_state(jparams)
    step = jax.jit(functools.partial(jsteps.train_step, cfg=jcfg, opt_cfg=jc,
                                     mesh_info=mesh_info, microbatches=microbatches))
    grad = jax.jit(jax.grad(lambda p, b: jsteps.loss_fn(p, jcfg, b, mesh_info)[0]))
    parts = [grad(jparams, {k: v.reshape((microbatches, -1) + v.shape[1:])[i]
                            for k, v in jbatch.items()}) for i in range(microbatches)]
    grads = jax.tree.map(lambda *g: sum(g) / microbatches, *parts)
    metrics, params = [], [jparams]
    for _ in range(n):
        p, state, m = step(params[-1], state, jbatch)
        params.append(p)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, params[1:], grads


@pytest.fixture(scope="module")
def qwen_dp():
    jcfg, cfg = _cfgs("qwen2-7b")
    jparams, _ = _bridge(jcfg, cfg, seed=2)
    batch, jbatch = _masked_batch(jcfg, cfg)
    ranks = spawn(bodies.dp_suite, 2, device="cpu",
                  args=(_np_tree(jparams), "qwen2-7b", batch, {"mb1": (1, 2), "mb2": (2, 1)}))
    return jcfg, cfg, jparams, batch, jbatch, ranks


@pytest.mark.parametrize("run", ["mb1", "mb2"])
def test_dp_step_matches_jax_and_the_single_process_port(qwen_dp, run):
    jcfg, cfg, jparams, batch, jbatch, ranks = qwen_dp
    microbatches, n = {"mb1": (1, 2), "mb2": (2, 1)}[run]
    j_metrics, j_params, j_grads = _jax_steps(jparams, jcfg, jbatch, n, microbatches)
    params = tree_map(torch.clone, bodies.params_of(_np_tree(jparams), cfg))
    state = topt.init_opt_state(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    single = []
    for _ in range(n):
        params, state, m = tsteps.train_step(params, state, tb, cfg=cfg,
                                             opt_cfg=topt.AdamWConfig(**OPT_CFG),
                                             microbatches=microbatches)
        single.append(m)
    assert ranks[0][run]["n_tokens"] != ranks[1][run]["n_tokens"]
    lr_sum = sum(m["lr"] for m in j_metrics)
    for res in ranks:
        out = res[run]
        for i in range(n):
            for key in METRICS:
                _rel_close(out["metrics"][i][key], j_metrics[i][key])
                _rel_close(out["metrics"][i][key], single[i][key])
        got = tree_map(torch.from_numpy, out["params"])
        _params_close(got, j_params[-1], j_grads if n == 1 else None, lr_sum)
        for a, b in zip(bodies.leaves(got), bodies.leaves(params), strict=True):
            np.testing.assert_allclose(a.numpy(), b.detach().numpy(), atol=2 * lr_sum + 1e-6)
        # one gather of every gradient leaf and of the 3 metrics over the data
        # axis, and one psum of the token count per microbatch, per step
        leaves = len(bodies.leaves(got))
        assert out["counts"] == {"collectives": leaves + 3 + microbatches, "staged_copies": 0}


MIXTRAL_SCRIPT = """
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "tests")
import jax
import numpy as np
from repro import compat
from repro.models.model import MeshContext
import test_torch_dist_training as T
with open(sys.argv[1], "rb") as f:
    np_params, batch = pickle.load(f)
from test_torch_training import _cfgs
jcfg, _ = _cfgs("mixtral-8x7b")
mesh = compat.make_mesh((2, 2), ("data", "model"))
mi = MeshContext(mesh, ("data",), "model", 2, 2)
jparams = jax.tree.map(jax.numpy.asarray, np_params)
jbatch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
metrics, params, grads = T._jax_steps(jparams, jcfg, jbatch, 2, mesh_info=mi)
with open(sys.argv[2], "wb") as f:
    pickle.dump((metrics, jax.tree.map(np.asarray, (params[0], grads))), f)
print("JAX_MESH_TRAIN_OK")
"""


def test_dp_ep_step_matches_jax_under_a_mesh(tmp_path):
    """Reduced mixtral-8x7b, 2 steps on a (2, 2) mesh: data parallel over 2
    rows a shard, experts 2 a rank, the load-balance loss and the capacity
    per batch shard, against JAX's train_step with the same mesh."""
    import pickle
    import subprocess
    import sys
    jcfg, cfg = _cfgs("mixtral-8x7b")
    jparams, _ = _bridge(jcfg, cfg, seed=4)
    batch, _ = _masked_batch(jcfg, cfg)
    with open(tmp_path / "in.pkl", "wb") as f:
        pickle.dump((_np_tree(jparams), batch), f)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", MIXTRAL_SCRIPT, str(tmp_path / "in.pkl"),
                        str(tmp_path / "out.pkl")], capture_output=True, text=True, env=env,
                       timeout=300, cwd=ROOT)
    assert "JAX_MESH_TRAIN_OK" in r.stdout, r.stderr[-3000:]
    with open(tmp_path / "out.pkl", "rb") as f:
        j_metrics, (j_params1, j_grads) = pickle.load(f)
    ranks = spawn(bodies.dp_suite, 4, device="cpu", model_parallel=2,
                  args=(_np_tree(jparams), "mixtral-8x7b", batch, {"one": (1, 1),
                                                                    "two": (1, 2)}))
    for res in ranks:
        for i in range(2):
            for key in METRICS:
                _rel_close(res["two"]["metrics"][i][key], j_metrics[i][key])
        got = tree_map(torch.from_numpy, res["one"]["params"])
        _params_close(got, j_params1, j_grads, j_metrics[0]["lr"])
        assert res["one"]["metrics"][0]["aux_loss"] > 0


def test_train_use_mesh_matches_a_single_process(tmp_path):
    from repro_torch.launch.train import train
    ranks = spawn(bodies.train_on_mesh, 2, device="cpu", args=(str(tmp_path),))
    _, _, want = train("granite-8b", reduced=True, steps=6, seq_len=16, global_batch=4,
                       log_every=0, device="cpu")
    for res in ranks:
        # the first step's loss is the mean of the same losses, summed in
        # another order; after it the params (bf16) differ by the rounding of
        # their gradients, summed over the ranks' rows in f32 here and over
        # all rows in one bf16 product there
        assert res["losses"][0] == pytest.approx(want[0], rel=1e-6)
        np.testing.assert_allclose(res["losses"], want, rtol=1e-4)
        assert res["resumed"] == res["losses"][3:] and res["same_params"] and res["step"] == 6
    for a, b in zip(bodies.leaves(ranks[0]["params"]), bodies.leaves(ranks[1]["params"]),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    assert ck.latest_step(str(tmp_path / "full")) == 6


# ---- the int8 error-feedback sync (tests/test_compression.py) ------------

def test_error_feedback_unbiased_over_steps():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32)) * 1e-3
    err = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    steps = 50
    for _ in range(steps):
        q, scale, err = C.quantize_ef(g, err)
        acc = acc + C.dequantize(q, scale)
    true = g * steps
    assert float((acc - true).abs().max() / true.abs().max()) < 0.01


def test_quantize_roundtrip_error_bounded():
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.normal(size=(128,)).astype(np.float32))
    q, scale, err = C.quantize_ef(g, torch.zeros_like(g))
    deq = C.dequantize(q, scale)
    assert float((deq - g).abs().max()) <= float(scale) * 0.5 + 1e-9
    np.testing.assert_allclose((deq + err).numpy(), g.numpy(), atol=1e-6)


def test_quantize_ef_matches_jax_bit_for_bit():
    rng = np.random.default_rng(2)
    g = rng.normal(size=(33, 17)).astype(np.float32)
    e = 1e-3 * rng.normal(size=(33, 17)).astype(np.float32)
    jq, js, je = JC.quantize_ef(jnp.asarray(g), jnp.asarray(e))
    q, s, ne = C.quantize_ef(torch.from_numpy(g), torch.from_numpy(e))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(ne.numpy(), np.asarray(je))


def test_compressed_sync_over_four_pods():
    rng = np.random.default_rng(0)
    g_all = rng.normal(size=(4, 32)).astype(np.float32)
    ranks = spawn(bodies.compressed_sync, 4, device="cpu", pod=4, args=(g_all, 3))
    want = g_all.mean(0)
    for rank, res in enumerate(ranks):
        assert res["coords"]["pod"] == rank
        got = res["synced"][0]["g"]
        assert np.abs(got - want).max() / np.abs(want).max() < 0.02
        np.testing.assert_array_equal(got, ranks[0]["synced"][0]["g"])   # every pod equal
        # two all-gathers a sync (the int8 payloads of both leaves, the scales)
        assert res["counts"] == {"collectives": 2 * 3, "staged_copies": 0}
    # error feedback: the mean of the synced values over 3 steps nears the mean
    mean3 = np.mean([s["g"] for s in ranks[0]["synced"]], axis=0)
    assert np.abs(mean3 - want).max() <= np.abs(ranks[0]["synced"][0]["g"] - want).max() + 1e-7


def test_dcn_bytes_accounting():
    g = {"a": torch.zeros(1000), "b": torch.zeros(24)}
    comp, bf16 = C.dcn_bytes(g, 2)
    assert comp < bf16 / 3
    assert (comp, bf16) == JC.dcn_bytes({"a": jnp.zeros(1000), "b": jnp.zeros(24)}, 2)


# ---- the elastic restore (tests/test_infra.py) ---------------------------

def test_elastic_restore_across_meshes(tmp_path):
    """Saved on a (1, 4) mesh (one of 4 experts a rank), restored onto a
    (1, 2) mesh (two a rank): every leaf bitwise the rank's block of the
    state that was saved; the manifest holds every leaf whole."""
    paths = spawn(bodies.save_blocks, 4, device="cpu", model_parallel=4,
                  args=("mixtral-8x7b", str(tmp_path)))
    assert paths[0] == str(tmp_path / "step_7") and paths[1:] == [None] * 3
    import json
    manifest = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    assert manifest["shapes"]["params/blocks/0/moe/w_gate"][0] == 4
    assert manifest["dtypes"]["params/blocks/0/moe/w_gate"] == "bfloat16"
    for res in spawn(bodies.restore_blocks, 2, device="cpu", model_parallel=2,
                     args=("mixtral-8x7b", str(tmp_path))):
        assert all(same for _, same in res.values()), res
        assert res["params/blocks/0/moe/w_gate"][0][0] == 2
        assert res["opt/m/blocks/1/moe/w_down"][0][0] == 2

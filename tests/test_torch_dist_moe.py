"""The MoE block over a mesh of processes (gloo ranks on the CPU) against
the JAX package's ``moe_forward`` under ``shard_map`` and the port's local
path.

Reduced mixtral-8x7b at float32 (D 128, top-2, d_ff_expert 64), one
layer's weights drawn in numpy for both packages, x of (2, 7, D):

* expert parallel, E = 4, over (1, 2), (1, 4) and (2, 2) meshes (the last
  with the batch sharded over the data axis): each rank holds E / n_model
  experts, keeps the slots routed to them (the rest go to an overflow bin)
  and the partial outputs are summed over the model axis;
* expert tensor parallel, E = 6 (6 % 4 != 0) over (1, 4): every expert on
  every rank, d_ff_expert sliced 64 / 4 (the JAX package's TP branch needs
  d_ff_expert % n_model == 0);

each at capacity factor 8 (no slot drops) and 1 (slots drop). Each rank's
y is held at 1e-4 against JAX's rows and against the local path on its
rows; lb_loss and drop_frac, averaged over the batch shards as JAX
averages them, equal JAX's; and the gradient of sum(y * r) with respect to
x, the router and the rank's block of the experts equals autograd through
the local path at 1e-4 (the partial gradients are summed over the model
axis in the backward pass).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_bodies as bodies  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch.dist import spawn  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402

TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x2": (2, 2), "1x4": (4, 4), "2x2": (4, 2)}   # name: (world, model_parallel)
# case: (n_experts, capacity_factor, meshes it runs on)
CASES = {"ep4": (4, 8.0, ("1x2", "1x4", "2x2")), "ep4_drops": (4, 1.0, ("1x2", "1x4", "2x2")),
         "tp6": (6, 8.0, ("1x4",)), "tp6_drops": (6, 1.0, ("1x4",))}
D, FE = 128, 64


def _inputs():
    rng = np.random.default_rng(7)
    out = {}
    for name, (e, cf, _) in CASES.items():
        blk = {"router": 0.3 * rng.normal(size=(D, e)).astype(np.float32),
               "w_gate": 0.1 * rng.normal(size=(e, D, FE)).astype(np.float32),
               "w_up": 0.1 * rng.normal(size=(e, D, FE)).astype(np.float32),
               "w_down": 0.1 * rng.normal(size=(e, FE, D)).astype(np.float32)}
        x = rng.normal(size=(2, 7, D)).astype(np.float32)
        out[name] = (blk, x, {"moe": {"n_experts": e, "capacity_factor": cf}})
    return out


JAX_SCRIPT = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, jax, jax.numpy as jnp, numpy as np
    from repro import compat
    from repro.configs import get_config
    from repro.models import moe as moe_mod
    from repro.models.model import MeshContext
    with open(sys.argv[1], "rb") as f:
        cases, meshes = pickle.load(f)
    base = dataclasses.replace(get_config("mixtral-8x7b").reduced(), dtype="float32")
    out = {}
    for name, (blk, x, kw) in cases.items():
        cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, **kw["moe"]))
        p = {k: jnp.asarray(v) for k, v in blk.items()}
        for mesh_name, (nb, nm) in meshes[name].items():
            mesh = compat.make_mesh((nb, nm), ("data", "model"),
                                    devices=jax.devices()[:nb * nm])
            mi = MeshContext(mesh, ("data",), "model", nm, nb)
            fwd = jax.jit(lambda p, x, cfg=cfg, mi=mi: moe_mod.moe_forward(p, x, cfg, mi))
            y, aux = fwd(p, jnp.asarray(x))
            out[f"{name}/{mesh_name}"] = (np.asarray(y), float(aux["lb_loss"]),
                                          float(aux["drop_frac"]))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
    print("JAX_MOE_OK")
""")


@pytest.fixture(scope="module")
def cases():
    return _inputs()


@pytest.fixture(scope="module")
def jax_moe(cases, tmp_path_factory):
    import pickle
    d = tmp_path_factory.mktemp("jax_dist_moe")
    meshes = {name: {m: (MESHES[m][0] // MESHES[m][1], MESHES[m][1]) for m in CASES[name][2]}
              for name in CASES}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((cases, meshes), f)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(d / "in.pkl"), str(d / "out.pkl")],
                       capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert "JAX_MOE_OK" in r.stdout, r.stderr[-3000:]
    with open(d / "out.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks(cases):
    return {m: spawn(bodies.moe_suite, world, device="cpu", model_parallel=mp,
                     args=({n: c for n, c in cases.items() if m in CASES[n][2]},))
            for m, (world, mp) in MESHES.items()}


def _params(case):
    return [(name, m) for name, (_, _, meshes) in CASES.items() for m in meshes]


@pytest.mark.parametrize("name,mesh", _params(CASES))
def test_dist_moe_matches_jax_shard_map(ranks, jax_moe, name, mesh):
    y_j, lb_j, drop_j = jax_moe[f"{name}/{mesh}"]
    world, mp = MESHES[mesh]
    outs = [r[name] for r in ranks[mesh]]
    for out in outs:
        a, b = out["rows"]
        np.testing.assert_allclose(out["y"], y_j[a:b], atol=TOL, rtol=TOL)
    # one value per batch shard, averaged as the JAX package averages them
    shards = {out["rows"]: out for out in outs}
    lb = np.mean([o["lb_loss"] for o in shards.values()])
    drop = np.mean([o["drop_frac"] for o in shards.values()])
    np.testing.assert_allclose(lb, lb_j, rtol=1e-6)
    np.testing.assert_allclose(drop, drop_j, rtol=1e-6, atol=1e-7)
    if name.endswith("drops"):
        assert drop > 0
    else:
        assert drop == 0


@pytest.mark.parametrize("name,mesh", _params(CASES))
def test_dist_moe_matches_the_local_path_with_gradients(ranks, cases, name, mesh):
    blk, x, kw = cases[name]
    cfg = bodies.config("mixtral-8x7b", **kw)
    world, mp = MESHES[mesh]
    ep = cfg.moe.n_experts % mp == 0
    for out in (r[name] for r in ranks[mesh]):
        a, b = out["rows"]
        p = {k: torch.from_numpy(v).requires_grad_() for k, v in blk.items()}
        xl = torch.from_numpy(x[a:b]).requires_grad_()
        y, aux = moe_mod.moe_forward(p, xl, cfg)
        np.testing.assert_allclose(out["y"], y.detach().numpy(), atol=TOL, rtol=TOL)
        assert out["lb_loss"] == pytest.approx(aux["lb_loss"].item(), rel=1e-6)
        assert out["drop_frac"] == pytest.approx(aux["drop_frac"].item(), rel=1e-6, abs=1e-7)
        assert out["expert_shape"] == ((cfg.moe.n_experts // mp, D, FE) if ep
                                       else (cfg.moe.n_experts, D, FE // mp))
        r = torch.from_numpy(np.random.default_rng(5).normal(size=y.shape).astype(np.float32))
        (y * r).sum().backward()
        np.testing.assert_allclose(out["dx"], xl.grad.numpy(), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(out["dp"]["router"], p["router"].grad.numpy(), atol=TOL,
                                   rtol=TOL)
        mesh_like = _Rank(mp, out["rank_model"])
        specs = sh.param_specs(cfg, mesh_like)["blocks"]["moe"]
        for k in ("w_gate", "w_up", "w_down"):
            want = sh.block_of(p[k].grad, sh.Spec(*specs[k][1:]), mesh_like)
            np.testing.assert_allclose(out["dp"][k], want.numpy(), atol=TOL, rtol=TOL)


@dataclasses.dataclass
class _Rank:
    """What block_of and param_specs read of a rank on the model axis."""
    n_model: int
    model: int

    @property
    def shape(self):
        return {"data": 1, "model": self.n_model}

    @property
    def axis_names(self):
        return ("data", "model")

    def axis_size(self, axes):
        return self.n_model

    def axis_index(self, axes):
        return self.model

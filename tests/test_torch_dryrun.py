"""The port's dry-run (``launch.dryrun``) on the CPU.

* Per-device bytes (params, state, batch, cache) of every supported
  production cell on both production meshes, and of the ``--fsdp`` and
  ``--zero-opt`` train cells, equal the JAX package's ``build_cell``
  record. JAX's side runs in a subprocess: importing ``repro.launch.dryrun``
  sets XLA's host-device count to 512 for its process.
* Per-rank FLOPs: on an (8, 1) data-parallel fake mesh a rank's count
  times 8 is the unsharded step's count within 1 %.
* Against JAX's HLO FLOPs, one reduced train cell on a (4, 2) mesh (see
  ``test_per_rank_flops_beside_jax_hlo`` for the band).
* ``RankCounter`` on plain tensors, ``fsdp_act_constraint`` on plain
  tensors (bit for bit what the forward gives without it), and the CLI on
  one full-width cell.

Every port cell that needs the fake process group runs in a subprocess
(``tests/torch_dryrun_cells.py``): the fake default group is a one-way
step for its process.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, SHAPES, cell_supported, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BODY = str(ROOT / "tests" / "torch_dryrun_cells.py")
MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


def run_body(what, arg, timeout=600):
    """The last line of ``tests/torch_dryrun_cells.py what arg``, parsed."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, BODY, what, json.dumps(arg)], capture_output=True,
                       text=True, env=env, timeout=timeout, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


class _StandIn:
    def __init__(self, shape):
        self.shape = dict(shape)

    @property
    def axis_names(self):
        return tuple(self.shape)


def _cells():
    cells = []
    for mesh in MESHES:
        for arch, cfg in ARCHS.items():
            for shape in SHAPES:
                if cell_supported(cfg, shape)[0]:
                    cells.append({"arch": arch, "shape": shape.name, "mesh": mesh})
            for variant in ({"fsdp": True, "overrides": {"fsdp_act_constraint": True}},
                            {"zero_opt": True}):
                cells.append({"arch": arch, "shape": "train_4k", "mesh": mesh, **variant})
    return cells


CELLS = _cells()


@pytest.fixture(scope="module")
def jax_bytes():
    return run_body("jax_bytes", CELLS)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_every_supported_cell_is_listed():
    per_mesh = sum(1 for c in CELLS if c["mesh"] == "single" and "fsdp" not in c
                   and "zero_opt" not in c)
    assert per_mesh == 33
    assert sum(1 for *_, ok, _ in dryrun.iter_cells() if ok) == 33


@pytest.mark.parametrize("index", range(len(CELLS)),
                         ids=[f"{c['arch']}-{c['shape']}-{c['mesh']}"
                              + ("-fsdp" if c.get("fsdp") else "")
                              + ("-zero" if c.get("zero_opt") else "") for c in CELLS])
def test_bytes_per_device_equal_jax(jax_bytes, index):
    cell = CELLS[index]
    cfg, shape = dryrun.resolve_cell(cell["arch"], cell["shape"], cell.get("overrides"))
    mesh = _StandIn(MESHES[cell["mesh"]])
    layout = dryrun.cell_layout(cfg, shape, mesh, zero_opt=cell.get("zero_opt", False),
                                fsdp=cell.get("fsdp", False))
    got = dryrun.layout_bytes(layout, mesh)
    want = {k: v for k, v in jax_bytes[index].items()}
    assert got == want


def test_rank_counter_counts_products_on_plain_tensors():
    a, b = torch.empty(6, 5, device="meta"), torch.empty(5, 7, device="meta")
    with dryrun.RankCounter() as c:
        a @ b
        torch.einsum("bik,bkj->bij", torch.empty(3, 6, 5, device="meta"),
                     torch.empty(3, 5, 7, device="meta"))
        torch.nn.functional.silu(a)
    assert c.flops == 2 * 6 * 5 * 7 + 3 * 2 * 6 * 5 * 7
    assert set(c.flops_by_op) == {"mm", "bmm"}
    assert c.collectives == {}


def test_count_unsharded_train_terms():
    cfg = get_config("qwen2-7b").reduced()
    shape = ShapeConfig("t", "train", 64, 8)
    res = dryrun.count_unsharded(cfg, shape)
    # 3 passes (the forward, and the backward's two) of the projections' 2 N
    # FLOPs a token and of attention's two products per head and layer
    D, F, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.padded_vocab
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    proj = L * (D * (H + 2 * KV) * hd + H * hd * D + 3 * D * F) + D * V
    tokens = shape.global_batch * shape.seq_len
    attn = L * 2 * 2 * shape.global_batch * H * shape.seq_len ** 2 * hd
    assert res["counter"].flops == 3 * (2 * tokens * proj + attn)
    assert res["terms"]["compute"] == res["counter"].flops / dryrun.PEAK_FLOPS
    assert res["terms"]["memory"] == res["traffic"]["total"] / dryrun.HBM_BW


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-moe-30b-a3b", "mamba2-2.7b",
                                  "zamba2-1.2b", "musicgen-medium"])
def test_fsdp_act_constraint_leaves_plain_tensors_bit_identical(arch):
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    if cfg.frontend == "tokens":
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))}
    else:
        batch = {"embeds": torch.from_numpy(
            rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32))}
    mi = M.mesh_context(make_local_mesh(1, device="cpu"))
    on = dataclasses.replace(cfg, fsdp_act_constraint=True)
    for mesh_info in (None, mi):
        want, want_aux = M.forward(params, cfg, batch, mesh_info)
        got, got_aux = M.forward(params, on, batch, mesh_info)
        assert torch.equal(got, want) and torch.equal(got_aux, want_aux)


def test_per_rank_flops_on_a_data_parallel_mesh():
    """Each of 8 data-parallel ranks runs an eighth of the step: its FLOPs
    times 8 are the unsharded step's, within 1 %; the gradients' sums over
    the data axis are its collectives."""
    cells = [{"arch": arch, "kind": "train", "seq": 64, "batch": 8, "mesh": [8, 1],
              "names": ["data", "model"], "unsharded": True}
             for arch in ("qwen2-7b", "mamba2-2.7b")]
    for rec in run_body("port", cells):
        assert rec["status"] == "ok", rec.get("traceback")
        per_rank, whole = rec["flops_per_device"], rec["unsharded_flops"]
        assert abs(per_rank * 8 - whole) <= 0.01 * whole
        assert rec["collectives"] and all(c["group"] == 8 for c in rec["collectives"].values())


def test_expert_tensor_parallel_cells():
    """Reduced mixtral-8x7b's 4 experts over a model axis of 8 ranks: expert
    tensor parallelism (every expert, its d_ff split), in a train, a prefill
    and a decode step; the block's output summed over the model axis."""
    cells = [{"arch": "mixtral-8x7b", "kind": kind, "seq": 64, "batch": 2, "mesh": [2, 8],
              "names": ["data", "model"]} for kind in ("train", "prefill", "decode")]
    for rec in run_body("port", cells):
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["collectives"]["all_reduce/8"]["count"] >= 4


def test_per_rank_flops_beside_jax_hlo():
    """Reduced qwen2-7b, one train step of 8 x 64 on a (4, 2) mesh: the
    port's per-rank FLOPs (DTensor on a fake group) beside the JAX package's
    per-device HLO FLOPs (GSPMD on 8 host devices, the same specs).

    The port's rank runs exactly an eighth of the unsharded step. JAX's
    device runs 1.64x that (port / JAX 0.611 when written; the band is
    [0.55, 0.7]), all of it in attention: XLA's CPU compile runs the
    reference attention's products over the global batch's rows for its
    heads (dots of f32[2, 512, ...], 512 = 8 x 64), 8x the port's attention
    products, which run on each rank's own rows (``models.attention._flash``).
    Outside attention the two count the same products, within 1 %."""
    cell = {"arch": "qwen2-7b", "kind": "train", "seq": 64, "batch": 8, "mesh": [4, 2],
            "names": ["data", "model"], "unsharded": True}
    jax_side = run_body("jax_flops", cell)
    port, = run_body("port", [cell])
    assert port["status"] == "ok", port.get("traceback")
    assert port["flops_per_device"] * 8 == port["unsharded_flops"]
    ratio = port["flops_per_device"] / jax_side["flops"]
    assert 0.55 <= ratio <= 0.7, ratio
    attn = port["flops_by_op"]["bmm"]
    jax_outside_attention = jax_side["flops"] - 8 * attn
    assert abs(port["flops_by_op"]["mm"] / jax_outside_attention - 1) <= 0.01


def test_cli_runs_a_full_width_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on one full-width decode cell
    of the production mesh writes an ok record with the JAX package's keys."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "mamba2-2.7b", "--shape", "decode_32k", "--mesh", "single",
                        "--out-dir", str(tmp_path)], capture_output=True, text=True, env=env,
                       timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert r.stdout.startswith("OK mamba2-2.7b decode_32k single")
    rec = json.loads((tmp_path / "mamba2-2.7b__decode_32k__single.json").read_text())
    assert rec["status"] == "ok" and rec["devices"] == 256 and rec["ssd_impl"] == "plain"
    for key in ("param_bytes_per_device", "state_bytes_per_device", "cache_bytes_per_device",
                "analytic_bytes_per_device", "traffic_breakdown", "model_flops",
                "compute_term_s", "memory_term_s", "collective_term_s", "bottleneck",
                "roofline_fraction", "useful_flops_ratio", "memory_analysis",
                "collective_bytes_per_device", "collectives", "trace_s"):
        assert key in rec
    args = rec["memory_analysis"]["argument_bytes"]
    assert args == rec["param_bytes_per_device"] + rec["cache_bytes_per_device"] + 128 // 16 * 4


def test_cli_runs_the_int8_hybrid_cell(tmp_path):
    """``--kv-int8`` on zamba2-1.2b decode_32k: an ok record whose cache
    bytes a device are the hybrid prefill's int8 layout, (values int8, scales
    f32) pairs of K and V over its 6 groups, batch-sharded 16 ways over
    `data` and kv-head-sharded 16 ways over `model`, plus the 38 layers'
    SSM states (heads and d_inner over `model`) and the lengths."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "zamba2-1.2b", "--shape", "decode_32k", "--mesh", "single",
                        "--kv-int8", "--out-dir", str(tmp_path)], capture_output=True,
                       text=True, env=env, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    rec = json.loads((tmp_path / "zamba2-1.2b__decode_32k__single.json").read_text())
    assert rec["status"] == "ok", rec.get("error")
    cfg = get_config("zamba2-1.2b")
    g, b, s = M.hybrid_split(cfg)[0], 128 // 16, 32768
    kv, hd = cfg.n_kv_heads // 16, cfg.resolved_head_dim
    pairs = 2 * g * b * s * kv * (hd + 4)     # K and V: hd int8 values and an f32 scale each
    ss = cfg.ssm
    di, gn, nh = ss.d_inner(cfg.d_model), ss.n_groups * ss.d_state, ss.n_heads(cfg.d_model)
    conv = cfg.n_layers * b * (ss.d_conv - 1) * (di // 16 + 2 * gn) * 2      # bf16
    state = cfg.n_layers * b * (nh // 16) * ss.head_dim * ss.d_state * 4   # f32
    assert rec["cache_bytes_per_device"] == pairs + conv + state + b * 4

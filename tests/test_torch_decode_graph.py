"""The serving engine's decode step, eager and replayed as a CUDA graph.

On a card, outside a mesh of processes, ``ServingEngine.step`` replays one
captured graph of ``decode_step`` (``serving.engine.DecodeGraph``); on the
CPU and over gloo ranks it runs the same decode eagerly. Both write the new
lengths into ``cache["lengths"]`` in place.

CPU tests: the eligibility rule; every family's eager ``step`` against
``decode_step`` run on a copy of the cache (the engine's step before the
lengths were written in place), bit for bit, over admissions, preemptions
and slots re-admitted between steps; ``add_request`` writing the lengths
tensor that ``step`` reads. Card tests (marked ``cuda``, skipped without a
card; they import no JAX): the same script with the replayed logits held
bitwise to the eager ones too, the capture leaving the cache bit for bit as
it was, a replay's kernels in the profiler's trace, and a recapture once
``engine.cache`` is replaced.

    PYTHONPATH=src python -m pytest -q tests/test_torch_decode_graph.py
"""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.launch.mesh import DistMesh, make_local_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.engine import DecodeGraph, ServingEngine, _leaves, replays  # noqa: E402

MAX_LEN = 64

FAMILIES = {
    "dense": ("qwen2-7b", {}),
    "ssm": ("mamba2-2.7b", {}),
    "hybrid": ("zamba2-1.2b", {}),
    "hybrid-int8": ("zamba2-1.2b", {"kv_cache_dtype": "int8"}),
    "moe": ("qwen3-moe-30b-a3b", {}),
    "audio": ("musicgen-medium", {}),
    "dense-sharded-x4": ("qwen2-7b", {"sharded_decode_attn": True}),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode step is captured only there")
    return torch.device("cuda")


def _engine(family: str, device, max_batch: int = 4) -> ServingEngine:
    """A reduced engine of ``family`` whose rows never meet an end of sequence."""
    arch, changes = FAMILIES[family]
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    mesh = M.mesh_context(make_local_mesh(4, device=device)) if cfg.sharded_decode_attn else None
    return ServingEngine(cfg, params, max_batch=max_batch, max_len=MAX_LEN, eos_id=-1,
                         mesh_info=mesh, device=device)


def _copy(cache):
    return {k: tuple(t.clone() for t in v) if isinstance(v, tuple) else v.clone()
            for k, v in cache.items()}


def _held_step(eng: ServingEngine):
    """One ``eng.step()`` held bit for bit to ``decode_step`` on a copy of
    the cache: the tokens, every cache leaf and, where the step replayed,
    its logits. Returns the step's output."""
    active = torch.tensor([s.active and not s.done for s in eng.slots])
    tokens = torch.as_tensor(eng.pending_tokens, dtype=torch.int64)
    if not active.any():
        return eng.step()
    dev = eng.device
    logits, want = M.decode_step(eng.params, eng.cfg, _copy(eng.cache), tokens.to(dev),
                                 active=active.to(dev), mesh_info=eng.mesh_info)
    out = eng.step()
    best = torch.argmax(logits, dim=-1).cpu()
    assert out == {i: int(best[i]) for i in range(eng.max_batch) if active[i]}
    if eng.graph is not None:
        diff = (eng.graph.logits - logits).abs().max().item()
        assert torch.equal(eng.graph.logits, logits), f"replayed logits off by {diff}"
    for got, ref in zip(_leaves(eng.cache), _leaves(want), strict=True):
        assert torch.equal(got, ref)
    return out


def _serve_script(eng: ServingEngine, steps: int = 24) -> int:
    """Admissions, a speculative slot preempted, a slot re-admitted over
    stale rows and one left inactive, every step held (:func:`_held_step`);
    returns the steps that decoded a row."""
    eng.add_request([5, 6, 7, 8], request_id=1)
    eng.add_request(list(range(2, 21)), request_id=-1, speculative=True)
    eng.add_request([9, 9, 4], request_id=2)
    decoded = 0
    for i in range(steps):
        if i == 6:
            eng.preempt(1)
        if i == 10:
            assert eng.add_request([3, 11, 4, 11, 5], request_id=3) == 1
        if i == 15:
            eng.slots[2].active = False        # the caller releases the slot
            eng.slots[2].request_id = None
        if i == 18:
            assert eng.add_request(list(range(30, 40)), request_id=4) == 2
        decoded += bool(_held_step(eng))
    return decoded


# -- CPU --------------------------------------------------------------------

def _dist_mesh(device):
    return M.MeshContext(DistMesh(shape={"data": 1, "model": 2}, axis_names=("data", "model"),
                                  device=device, rank=0, coords={"data": 0, "model": 0},
                                  groups={}, backend="gloo"),
                         ("data",), "model", 2, 1)


@pytest.mark.parametrize("device,mesh,want", [
    ("cuda", None, True),
    ("cuda", "local", True),
    ("cuda", "dist", False),
    ("cpu", None, False),
    ("cpu", "local", False),
    ("cpu", "dist", False),
])
def test_replays_on_a_card_outside_a_mesh_of_processes(device, mesh, want):
    dev = torch.device(device)
    info = {None: None, "local": M.mesh_context(make_local_mesh(2, device="cpu")),
            "dist": _dist_mesh(dev)}[mesh]
    assert replays(dev, info) is want


@pytest.mark.parametrize("family", list(FAMILIES))
def test_eager_step_matches_decode_step(family):
    eng = _engine(family, torch.device("cpu"))
    assert _serve_script(eng) >= 20
    assert eng.graph is None and eng.graph_replays == 0


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid"])
def test_add_request_writes_the_lengths_that_step_reads(family):
    eng = _engine(family, torch.device("cpu"))
    lengths = eng.cache["lengths"]
    eng.add_request([5, 6, 7, 8], request_id=1)
    eng.step()
    assert eng.cache["lengths"] is lengths and lengths.tolist() == [5, 0, 0, 0]
    slot = eng.add_request([2, 3, 4], request_id=2)
    assert eng.cache["lengths"] is lengths and lengths[slot] == 3
    eng.step()
    assert eng.cache["lengths"] is lengths and lengths.tolist() == [6, 4, 0, 0]


# -- the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("family", list(FAMILIES))
def test_replay_matches_eager_bitwise(cuda_device, family):
    eng = _engine(family, cuda_device)
    assert _serve_script(eng) >= 20
    assert eng.graph is not None and eng.graph_replays == eng.steps_executed >= 20


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid-int8"])
def test_capture_leaves_the_cache_unchanged(cuda_device, family):
    eng = _engine(family, cuda_device)
    eng.add_request([5, 6, 7, 8], request_id=1)
    eng.add_request(list(range(2, 21)), request_id=2)
    eng.step()
    before = _copy(eng.cache)
    graph = DecodeGraph(eng)
    torch.cuda.synchronize()
    assert graph.holds(eng.cache)
    for got, ref in zip(_leaves(eng.cache), _leaves(before), strict=True):
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_a_replay_launches_the_captured_kernels(cuda_device):
    """The profiler lists every decode kernel a replay launches, by name;
    the wrappers' counter, which counts eager launches, stays still."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = _engine("dense", cuda_device)
    eng.add_request([5, 6, 7, 8], request_id=1)
    eng.step()                                  # the capture
    before = da.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
    traced = sum(e.count for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and "decode_attention_kernel" in e.key)
    assert traced == 3 * eng.cfg.n_layers
    assert da.launches == before
    assert eng.graph_replays == eng.steps_executed == 4


@pytest.mark.cuda
def test_replacing_the_cache_recaptures(cuda_device):
    eng = _engine("hybrid", cuda_device)
    eng.add_request([5, 6, 7, 8], request_id=1)
    _held_step(eng)
    first = eng.graph
    _held_step(eng)
    assert eng.graph is first
    tokens = torch.as_tensor(eng.pending_tokens, dtype=torch.int64, device=cuda_device)
    active = torch.tensor([True, False, False, False], device=cuda_device)
    _, eng.cache = M.decode_step(eng.params, eng.cfg, eng.cache, tokens, active=active)
    eng.pending_tokens[0] = 7
    assert not first.holds(eng.cache)
    _held_step(eng)
    assert eng.graph is not first and eng.graph.holds(eng.cache)
    slot = eng.add_request([2, 3, 4], request_id=2)
    assert eng.cache["lengths"][slot] == 3
    _held_step(eng)
    assert eng.cache["lengths"].tolist() == [9, 4, 0, 0]

"""The port's dry-run traced on a (2, 2, 2) ("pod", "data", "model") fake mesh:
reduced configs of every family (dense, MoE, SSM, hybrid, vlm, audio) x
{train, prefill, decode} at small shapes (train and prefill 8 x 64, a
decode cache of 64 rows for 8 sequences), plus train cells with the
FSDP layouts and the activation constraint (``--fsdp``), with ZeRO-sharded
moments (``--zero-opt``) and under a sliding window. All run in one
subprocess (``tests/torch_dryrun_cells.py``); each cell must be ok, count
FLOPs, record its collectives and agree with its own specs' bytes."""
import pytest

pytest.importorskip("torch")

from torch_dryrun_cells_common import CELLS, check_cell, traced  # noqa: E402

MESH = ([2, 2, 2], ["pod", "data", "model"])


@pytest.fixture(scope="module")
def records():
    return traced(MESH)


@pytest.mark.parametrize("index", range(len(CELLS)), ids=[c["id"] for c in CELLS])
def test_cell_traces_ok(records, index):
    check_cell(CELLS[index], records[index], MESH)

"""Model FLOPs of the authoritative prefills and decode rows in the traced
window, counted in full for a Zamba2 hybrid (``portbench/zamba2_flops.py``:
the shared blocks' 2 d-wide QKV, MLPs, LoRAs and projections too), over the
window's seconds times the card's bf16 peak (%).

A record carries no configuration, so the reader counts with the file
``configs/zamba2-7b.json``, and reads nothing where that is not the cell's:
where ``roofline.model_flops`` of the file's configuration over the
record's shapes is not the harness's count of the cell's own."""

import json
import math
from pathlib import Path

from portbench.bench import model_config
from portbench.roofline import PEAK_FLOPS_BF16
from portbench.roofline import model_flops as roofline_flops
from portbench.zamba2_flops import model_flops

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "zamba2-7b.json"


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0:
        return None
    cfg = model_config(json.loads(CONFIG.read_text()))
    smax = rec.mix["max_len"]
    if not math.isclose(roofline_flops(cfg, rec.loop.shapes, smax), rec.model_flops,
                        rel_tol=1e-12):
        return None
    f = model_flops(cfg, rec.loop.shapes, smax)
    return 100.0 * f / (t.window_s * PEAK_FLOPS_BF16) if f > 0 else None

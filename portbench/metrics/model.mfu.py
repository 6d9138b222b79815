"""Model FLOPs of the authoritative prefills and decode rows in the traced
window (``roofline.model_flops``, from their shapes) over the window's
seconds times the card's bf16 peak (%)."""

from portbench.roofline import PEAK_FLOPS_BF16


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0 or rec.model_flops <= 0:
        return None
    return 100.0 * rec.model_flops / (t.window_s * PEAK_FLOPS_BF16)

"""The share of the window's untraced part spent in prefills that hold
back rows mid-decode (%): seconds of ``serving.prefill`` spans with
``decoding`` above 0, over the part's seconds."""
from portbench.program import named, part, seconds


def read(rec):
    p = part(rec)
    if p is None:
        return None
    spans, lo, hi = p
    stalls = [s for s in named(spans, "serving.prefill") if s.attrs["decoding"] > 0]
    return 100.0 * seconds(stalls) / ((hi - lo) * 1e-9)

"""The share of the window's untraced part spent in speculative prefills
that hold back authoritative rows mid-decode (%): seconds of speculative
``serving.prefill`` spans with ``auth_decoding`` above 0, over the part's
seconds."""
from portbench.program import named, part, seconds


def read(rec):
    p = part(rec)
    if rec.mix["spec_budget_slots"] <= 0 or p is None:
        return None
    spans, lo, hi = p
    stalls = [s for s in named(spans, "serving.prefill")
              if s.attrs["speculative"] and s.attrs["auth_decoding"] > 0]
    return 100.0 * seconds(stalls) / ((hi - lo) * 1e-9)

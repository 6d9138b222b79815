"""Speculative rows among the rows decoded (%): the sum of ``spec_rows``
over the sum of ``rows`` of the ``serving.step`` spans in the window's
untraced part."""
from portbench.program import named, part


def read(rec):
    p = part(rec)
    if rec.mix["spec_budget_slots"] <= 0 or p is None:
        return None
    steps = named(p[0], "serving.step")
    rows = sum(s.attrs["rows"] for s in steps)
    return 100.0 * sum(s.attrs["spec_rows"] for s in steps) / rows if rows else None

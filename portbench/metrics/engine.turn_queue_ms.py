"""A turn's wait at the engine's door (ms): the median, over the untraced
part's turns that began with a prefill, of the start of the turn's own
``serving.prefill`` less the turn's start (its tool's return)."""
import statistics

from portbench.program import turn_prefills


def read(rec):
    p = getattr(rec, "program", None)
    pairs = turn_prefills(rec, p.spans) if p is not None else []
    if not pairs:
        return None
    return statistics.median((s.start_ns - round(t.start * 1e9)) * 1e-6 for t, s in pairs)

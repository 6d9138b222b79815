"""The share of the traced window in which no operation ran on the device
while the host's innermost program span was ``serving.step.model`` (%):
the idle gaps charged by the profiler's copies of the program's spans."""


def read(rec):
    p = getattr(rec, "program", None)
    if p is None or p.idle is None or p.idle.window_s <= 0:
        return None
    return 100.0 * p.idle.idle_s_by_span.get("serving.step.model", 0.0) / p.idle.window_s

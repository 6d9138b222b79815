"""Host wall per ``ServingEngine.step`` in the window (ms), the harness's
clock around each call (which ends by reading the tokens back)."""


def read(rec):
    c = rec.loop.counters
    return 1e3 * c.step_s / c.steps if c.steps else None

"""Device time of one decode step (ms): the device operations that ran
inside the traced ``engine.step`` spans, over their count."""


def read(rec):
    t = rec.trace
    if t is None or not t.spans.get("engine.step"):
        return None
    return 1e3 * t.device_s_by_span.get("engine.step", 0.0) / t.spans["engine.step"]

"""Device time of the prefills per 1000 prompt tokens (ms/ktok): the
device operations inside the traced ``engine.add_request`` and
``spec.admit`` spans over the prompt tokens those calls prefilled."""


def read(rec):
    t = rec.trace
    tokens = sum(s for s, _spec in rec.loop.shapes["prefill"])
    if t is None or not tokens:
        return None
    dev = t.device_s_by_span.get("engine.add_request", 0.0) + \
        t.device_s_by_span.get("spec.admit", 0.0)
    return 1e3 * dev / (tokens / 1e3)

"""Speculative slots promoted over slots admitted in the window (%), from
the turns that began in a promoted slot and the slots ``admit`` filled."""


def read(rec):
    c = rec.loop.counters
    if not c.spec_admitted:
        return None
    return 100.0 * c.spec_promoted / c.spec_admitted

"""Speculative prompt tokens over all prompt tokens prefilled in the
window (%): what speculation adds to the card's prefill work. Counted by
the harness at ``admit`` and ``add_request``."""


def read(rec):
    c = rec.loop.counters
    if rec.mix["spec_budget_slots"] <= 0 or not (c.prefill_tokens_auth + c.prefill_tokens_spec):
        return None
    return 100.0 * c.prefill_tokens_spec / (c.prefill_tokens_auth + c.prefill_tokens_spec)

"""Host wall of the authoritative ``add_request`` calls in the window per
1000 prompt tokens (ms/ktok), the harness's clock around each call."""


def read(rec):
    c = rec.loop.counters
    if not c.prefill_tokens_auth:
        return None
    return 1e3 * c.prefill_s / (c.prefill_tokens_auth / 1e3)

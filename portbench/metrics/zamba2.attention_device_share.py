"""The attention kernels' share of the device's busy time (%) in the Zamba2
cell: flash_attention's and decode_attention's device seconds in the trace
over the union of every device operation's intervals."""


def read(rec):
    t = rec.trace
    if t is None or t.busy_s <= 0:
        return None
    s = sum(t.device_s_by_kernel.get(k, 0.0) for k in ("flash_attention", "decode_attention"))
    return 100.0 * s / t.busy_s if s > 0 else None

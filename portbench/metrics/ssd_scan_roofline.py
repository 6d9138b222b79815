"""ssd_scan's share of its roofline (%): the least seconds of its traced calls
(``roofline.kernel_least_seconds``, from each call's shapes) over the
device seconds its kernels took in the trace."""

KERNEL = "ssd_scan"


def read(rec):
    t = rec.trace
    if t is None or not t.device_s_by_kernel.get(KERNEL) or not rec.least_s.get(KERNEL):
        return None
    return 100.0 * rec.least_s[KERNEL] / t.device_s_by_kernel[KERNEL]

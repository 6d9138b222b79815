"""Host ms a decode step spends enqueuing its work: the mean of the
program's ``serving.step.model`` spans (the ``decode_step`` call, and the
batch gather on a mesh) a ``serving.step``, over the window's untraced part."""
from portbench.program import named, part, seconds


def read(rec):
    p = part(rec)
    if p is None or not named(p[0], "serving.step"):
        return None
    return 1e3 * seconds(named(p[0], "serving.step.model")) / len(named(p[0], "serving.step"))

"""Host ms a decode step waits for its tokens: the mean of the program's
``serving.step.readback`` spans (``argmax`` and the copy to the host) a
``serving.step``, over the window's untraced part."""
from portbench.program import named, part, seconds


def read(rec):
    p = part(rec)
    if p is None or not named(p[0], "serving.step"):
        return None
    return 1e3 * seconds(named(p[0], "serving.step.readback")) / len(named(p[0], "serving.step"))

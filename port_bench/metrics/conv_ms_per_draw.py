"""Device milliseconds of the kernels launched inside the program's
``auv.conv`` spans (``models/resnet.py::conv``, ``models/fused.py``'s
grouped conv: the convolution with its input and kernel casts) per MC
draw, in the spans' device pass (``harness/spans.py``)."""
from harness import spans


def read(run):
    d = spans.device(run)
    if d is None or not d.draws:
        return None
    ms = d.ms("auv.conv")
    return None if ms is None else ms / d.draws

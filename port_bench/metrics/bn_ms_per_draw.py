"""Device milliseconds of the kernels launched inside the program's
``auv.bn`` spans (``models/resnet.py::batch_norm``, which the grouped
trunks' BatchNorm reaches too) per MC draw, in the spans' device pass
(``harness/spans.py``). In training this holds the forward's BatchNorm
and remat's re-forward's; BatchNorm's backward kernels fall under
``auv.backward``."""
from harness import spans


def read(run):
    d = spans.device(run)
    if d is None or not d.draws:
        return None
    ms = d.ms("auv.bn")
    return None if ms is None else ms / d.draws

"""Device milliseconds a train step of the kernels launched inside the
program's ``auv.backward`` span (``loss.backward()``) on any thread:
remat's re-forward, the eps kernel and every gradient kernel, BatchNorm's
among them, in the spans' device pass (``harness/spans.py``)."""
from harness import spans


def read(run):
    d = spans.device(run)
    if d is None or not d.batches:
        return None
    ms = d.ms("auv.backward")
    return None if ms is None else ms / d.batches

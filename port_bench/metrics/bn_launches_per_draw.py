"""Kernel launches inside the program's ``auv.bn`` spans per MC draw, in
the spans' device pass (``harness/spans.py``): about twenty unfused
operations a train-mode BatchNorm layer."""
from harness import spans


def read(run):
    d = spans.device(run)
    if d is None or not d.draws or not d.launches.get("auv.bn"):
        return None
    return d.launches["auv.bn"] / d.draws

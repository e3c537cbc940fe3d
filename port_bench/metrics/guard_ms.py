"""Host milliseconds a train step blocked in the program's ``auv.guard``
span: the NaN guard's ``finite.tolist()``, the step's one host sync,
which waits for the step's forward and backward to finish on the card
(``engine/steps.py::make_train_step``), in the spans' host pass
(``harness/spans.py``: no profiler)."""
from harness import spans


def read(run):
    h = spans.host(run)
    if h is None or not h.batches:
        return None
    ms = h.ms("auv.guard")
    return None if ms is None else ms / h.batches

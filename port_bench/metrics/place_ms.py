"""Host milliseconds a batch or step inside the program's ``auv.place``
spans: the host-to-device copies of the batch's inputs and mask
(``engine/predict.py::_placer``, ``engine/loops.py::_device_batch``), in
the spans' host pass (``harness/spans.py``: no profiler). A copy from
pageable host memory waits for the stream's queue to drain, so this reads
that wait as well as the copy."""
from harness import spans


def read(run):
    h = spans.host(run)
    if h is None or not h.batches:
        return None
    ms = h.ms("auv.place")
    return None if ms is None else ms / h.batches

"""Host milliseconds of the call that enqueues one batch's or step's MC
work (engine: the packed step, the unimodal pipeline's ``mc_logits``, the
train step with its one host sync), the median over the window's batches
of the benchmark's host-clock span around the call. The CUDA launch queue
holds a few thousand launches, so where the device is the slower side
the host blocks in the call and this reads about the device's time a
batch; it falls below it once the device outruns the host."""
import statistics


def read(run):
    spans = run.window.get("enqueue_s")
    if not spans:
        return None
    return 1e3 * statistics.median(spans)

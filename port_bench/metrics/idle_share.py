"""The device's idle share of the untraced window, in %: 1 minus its busy
time a batch or step (the union of its operations' intervals in the
steady pass, CUDA activity alone, the fill batch left out, over the
batches that pass's kernels make up) over the window's host-clock time a
batch or step. The steady window's own idle share (``busy_s`` and
``window_s`` of the result) reads higher: the profiler slows the host."""


def read(run):
    t, seen = run.idle, run.steady_batches_seen()
    done = run.window["items"] / run.cell.traffic["batch"]
    if t is None or not t.busy_us or not seen or not done:
        return None
    per_batch = run.window["seconds"] / done
    return 100.0 * (1.0 - t.busy_us / 1e6 / seen / per_batch)

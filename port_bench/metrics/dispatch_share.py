"""The share of the window, in %, that the host spent inside the calls
that enqueue each batch's MC work: the spans of ``dispatch_ms``, summed,
over the window's host-clock time. The rest is placement, the drain of
the previous batch's outputs to the host, and the loop's own work."""


def read(run):
    spans = run.window.get("enqueue_s")
    if not spans or run.window["seconds"] <= 0:
        return None
    return 100.0 * sum(spans) / run.window["seconds"]

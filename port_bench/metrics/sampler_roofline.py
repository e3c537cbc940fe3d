"""The sampler kernels' share of their roofline, in %: the sum of each
call's least time (``harness.bounds``) over the sum of the same calls'
device times. The calls are the program's launch counters over the
traced batches or steps, each at the cell's shape; nothing is read when
the trace's sampler kernels are not exactly those calls."""
from harness.bounds import least_ms, sampler_call


def read(run):
    ks = run.trace.sampler_kernels()
    calls = [c for c in run.sampler_calls() if c[1]]
    if not ks or len(ks) != sum(c[1] for c in calls):
        return None
    least = sum(n * least_ms(*sampler_call(kind, run.P, draws, i, o, fast))
                for kind, n, draws, i, o, fast in calls)
    return 100.0 * least / (sum(d[3] for d in ks) / 1e3)

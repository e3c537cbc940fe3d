"""Kernel launches of the model layers (every kernel but the samplers'
and the optimizer's) per MC draw in the traced batches or steps."""


def read(run):
    k = run.trace.model_kernels()
    if not k or not run.draws:
        return None
    return len(k) / run.draws

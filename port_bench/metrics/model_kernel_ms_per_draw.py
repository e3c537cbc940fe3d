"""Device milliseconds of the model layers' kernels (every kernel but the
samplers' and the optimizer's) per MC draw in the traced batches or
steps."""


def read(run):
    k = run.trace.model_kernels()
    if not k or not run.draws:
        return None
    return sum(d[3] for d in k) / 1e3 / run.draws

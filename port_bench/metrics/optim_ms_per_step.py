"""Device milliseconds of the kernels launched inside the optimizer's
step (torch's ``Optimizer.step#`` span) per traced step."""


def read(run):
    k = run.trace.optimizer_kernels()
    if not k or not run.batches:
        return None
    return sum(d[3] for d in k) / 1e3 / run.batches

"""Device operations (kernels, copies, fills) in the traced window an observation."""


def read(run):
    return run.trace.device_ops / run.observations if run.observations and run.trace.device_ops else None

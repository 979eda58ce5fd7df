"""pipeline.launches: device operations (kernels, copies, memsets) a
volume, from the trace: a count that fusing launches or removing host
round trips lowers."""


def read(trace):
    return trace.launches() or None

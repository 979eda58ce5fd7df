"""expansion.ms: device ms a volume in the expansion pyramid layer (``benchmarks/trace.py``'s
rule); nothing where the layer ran no operation."""


def read(trace):
    return trace.layer_ms("expansion pyramid")

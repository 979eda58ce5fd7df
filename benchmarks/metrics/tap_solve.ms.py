"""tap_solve.ms: device ms a volume in the tap solve layer (``benchmarks/trace.py``'s
rule); nothing where the layer ran no operation."""


def read(trace):
    return trace.layer_ms("tap solve")

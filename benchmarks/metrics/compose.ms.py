"""compose.ms: device ms a volume in the compose pass layer (``benchmarks/trace.py``'s
rule); nothing where the layer ran no operation."""


def read(trace):
    return trace.layer_ms("compose pass")

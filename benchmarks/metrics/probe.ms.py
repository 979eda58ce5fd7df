"""probe.ms: device ms a volume in the probe layer (``benchmarks/trace.py``'s
rule 1: every device event launched inside ``bench.probe``, the CLI's
auto-bound probe); nothing where the layer ran no operation."""

from benchmarks import trace as tracing


def read(trace):
    return trace.layer_ms(tracing.PROBE_LAYER)

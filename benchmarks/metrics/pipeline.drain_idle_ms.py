"""pipeline.drain_idle_ms: device idle ms a volume in the gaps that began
inside any other ``fdt.drain.*`` span (the input's copy, the pad's index
vector, the memory query, ...; ``benchmarks/drains.py``).  0 where there
was none; nothing without the program's spans."""

from benchmarks import drains


def read(trace):
    return drains.idle_ms(
        trace, lambda site: site not in ("resize_matrix", "blur_index"))

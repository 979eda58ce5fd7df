"""resize.drain_idle_ms: device idle ms a volume in the gaps that began
inside an ``fdt.drain.resize_matrix`` span, the copy of a resize's weight
matrix to the card (``benchmarks/drains.py``).  0 where there was none;
nothing without the program's spans."""

from benchmarks import drains


def read(trace):
    return drains.idle_ms(trace, lambda site: site == "resize_matrix")

"""expansion.drain_idle_ms: device idle ms a volume in the gaps that began
inside an ``fdt.drain.blur_index`` span, the copy of a pyramid correlation's
index vector to the card (``benchmarks/drains.py``).  0 where there was
none; nothing without the program's spans."""

from benchmarks import drains


def read(trace):
    return drains.idle_ms(trace, lambda site: site == "blur_index")

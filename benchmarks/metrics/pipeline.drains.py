"""pipeline.drains: the program's drains a volume, its ``fdt.drain.*``
spans in the window (``benchmarks/drains.py``): the calls that held the host
until the card's stream drained.  0 where it made none; nothing without
the program's spans."""

from benchmarks import drains


def read(trace):
    return drains.count(trace)

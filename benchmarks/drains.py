"""The program's drains in a traced window, read from ``Trace``'s host
events: each ``fdt.drain.<site>`` span is one call that held the host until
the card's stream drained (``flowdenoising_tpu_torch/utils/tracing.py``).

A gap of the device (``Trace.gaps``) belongs to the drain it began in, and
counts whole, to the next device event: the drain left the card idle for
that long.  A gap that began outside every drain counts nowhere here.

Every value is None where the trace holds none of the program's spans (no
``fdt.pass``, which each pass opens), so a program from before the spans
reads nothing, and one that makes no drain reads 0.
"""

from __future__ import annotations

import bisect

DRAIN_PREFIX = "fdt.drain."
PASS_SPAN = "fdt.pass"


def spans(trace) -> list | None:
    """(start, end, site) of each drain span on the loop's thread that
    starts inside the window, by start; None without the program's
    spans."""
    if not any(e.name == PASS_SPAN for e in trace.host):
        return None
    return [(e.start, e.end, e.name[len(DRAIN_PREFIX):]) for e in trace.host
            if e.name.startswith(DRAIN_PREFIX)
            and trace.lo <= e.start <= trace.hi]


def count(trace) -> float | None:
    """Drains a volume."""
    found = spans(trace)
    return None if found is None else len(found) / trace.volumes


def idle_ms(trace, sites) -> float | None:
    """Device idle ms a volume in the gaps that began inside a drain whose
    site ``sites(site)`` accepts."""
    found = spans(trace)
    if found is None:
        return None
    starts = [lo for lo, _, _ in found]
    idle = 0
    for a, b in trace.gaps():
        # drains do not nest, so the last to start before ``a`` is the one
        # ``a`` can lie in
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a <= found[i][1] and sites(found[i][2]):
            idle += b - a
    return idle / 1e6 / trace.volumes

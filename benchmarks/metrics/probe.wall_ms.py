"""probe.wall_ms: host ms a volume of the ``bench.probe`` spans on the loop's
thread, the CLI's auto-bound probe from its first plane read to its pick;
nothing where no probe ran.  Less ``probe.ms``, the device idle that the
probe's host work (plane copies, host resizes, host round trips) leaves."""

from benchmarks import trace as tracing


def read(trace):
    found = [e.end - e.start for e in trace.host if e.name ==
             tracing.PROBE_SPAN and trace.lo <= e.start <= trace.hi]
    if not found:
        return None
    return sum(found) / 1e6 / trace.volumes

"""resize.ms: device ms a volume of the window's work launched inside the
program's ``fdt.resize`` range, each separable resize on either route
(K-resize on a CUDA float32 tensor, the dense ``bmm`` products elsewhere),
by ``Trace.launched_in``; less what rule 1 gives to the probe.  Nothing
where none ran.

A reading across ``benchmarks/trace.py``'s layers, not a layer of its
partition: K-resize's pyramid downsamples run inside ``OFE_expansion`` and
count in ``expansion.ms`` too (rule 4), its flow resizes in "other
elementwise"; the ``bmm`` products count in the resize layer (rule 3)."""

from benchmarks import trace as tracing


def read(trace):
    in_resize = trace.launched_in(tracing.RESIZE_RANGE)
    in_probe = trace.launched_in(tracing.PROBE_SPAN)
    found = [e.end - e.start for e in trace.work
             if in_resize(e) and not in_probe(e)]
    if not found:
        return None
    return sum(found) / 1e6 / trace.volumes

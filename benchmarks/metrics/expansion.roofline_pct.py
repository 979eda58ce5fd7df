"""expansion.roofline_pct: the least time the card could take for the expansion pyramid
layer's work (``benchmarks/work.py: expansion``, counted from the volume's
shape) over its device ms a volume, %; nothing where the layer ran no
operation."""

from benchmarks import work


def read(trace):
    ms = trace.layer_ms("expansion pyramid")
    if not ms:
        return None
    cell = trace.cell
    least = work.expansion(cell.shape, cell.config["sigma"], cell.flow).least_ms
    return 100.0 * least / ms

"""tap_solve.roofline_pct: the least time the card could take for the tap solve
layer's work (``benchmarks/work.py: tap_solve``, counted from the volume's
shape) over its device ms a volume, %; nothing where the layer ran no
operation."""

from benchmarks import work


def read(trace):
    ms = trace.layer_ms("tap solve")
    if not ms:
        return None
    cell = trace.cell
    least = work.tap_solve(cell.shape, cell.config["sigma"], cell.flow).least_ms
    return 100.0 * least / ms

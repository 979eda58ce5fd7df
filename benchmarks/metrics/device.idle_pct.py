"""device.idle_pct: the share of the traced window in which no operation
ran on the card, %: 1 - union of device busy intervals / window."""


def read(trace):
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

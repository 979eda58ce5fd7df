"""Per-axis passes and the three-pass pipeline."""

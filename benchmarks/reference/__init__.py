"""The plain float32 reference the benchmark's outputs are judged against."""

"""Hand-written CUDA kernels for Hopper and their launch counts.

Each kernel's wrapper (``sample.displace_sample``, ``umuf.umuf_iterate``)
runs the kernel for a CUDA tensor and the plain PyTorch version for a CPU
tensor, and raises for any other device.  ``LAUNCHES`` counts the kernel
launches of each wrapper: a run resets it and reads it afterwards to show
which kernels its path went through.
"""

from __future__ import annotations

# kernel name -> number of launches since the last reset_launches()
LAUNCHES = {"sample": 0, "umuf": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0

"""Hand-written CUDA kernels for Hopper and their launch counts.

Each kernel's wrapper (``sample.displace_sample``, ``umuf.umuf_iterate``,
``umuf_split.umuf_split_iterate``, ``compose.compose_tap``,
``compose.compose_run``, ``um.update_matrices``, ``uf.update_flow``) runs
the kernel for a CUDA tensor and the plain PyTorch version for a CPU
tensor, and raises for any other device.  ``LAUNCHES``
counts the kernel launches of each wrapper, per form: ``umuf_bf16``,
``compose_bf16``, ``compose_run_bf16`` and ``um_bf16`` count the packed
forms (the sampling source in bfloat16, ``--precision bfloat16``).  A run
resets it and reads it afterwards to show which kernels its path went
through.
"""

from __future__ import annotations

# kernel form -> number of launches since the last reset_launches()
LAUNCHES = {"compose": 0, "compose_bf16": 0, "compose_run": 0,
            "compose_run_bf16": 0, "sample": 0, "uf": 0, "um": 0,
            "um_bf16": 0, "umuf": 0, "umuf_bf16": 0, "umuf_split": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0

"""Hand-written CUDA kernels for Hopper and their launch counts.

Each kernel's wrapper (``sample.displace_sample``, ``sample.sample_split``,
``umuf.umuf_iterate``, ``umuf_split.umuf_split_iterate``,
``compose.compose_tap``, ``compose.compose_run``,
``compose.compose_run_split``, ``um.update_matrices``, ``uf.update_flow``,
``polyexp.expand_level``, ``polyexp.pyr_blur``) runs
the kernel for a CUDA tensor and the plain PyTorch version for a CPU
tensor, and raises for any other device; ``resize.resize`` (K-resize)
takes only a CUDA float32 tensor, ``ops.resize`` sending the rest to its
plain version.  ``LAUNCHES``
counts the kernel launches of each wrapper, per form: ``umuf_bf16``,
``compose_bf16``, ``compose_run_bf16`` and ``um_bf16`` count the packed
forms (the sampling source in bfloat16, ``--precision bfloat16``);
``sample_split`` and ``compose_run_split`` the split route's forms (bf16
arithmetic with no bound, ``--dtype bfloat16 --max_displacement 0``);
``polyexp`` and ``pyr_blur`` the float32 expansion pyramid's kernels, one
expansion a level and one pre-blur a level past the first (one call each,
which is several launches where it runs through device memory: a poly_n
other than 5, a pre-blur past K-pyr-blur's tiles); ``resize`` each
float32 resize on the card.  A run
resets it and reads it afterwards to show which kernels its path went
through.
"""

from __future__ import annotations

# kernel form -> number of launches since the last reset_launches()
LAUNCHES = {"compose": 0, "compose_bf16": 0, "compose_run": 0,
            "compose_run_bf16": 0, "compose_run_split": 0, "polyexp": 0,
            "pyr_blur": 0, "resize": 0, "sample": 0, "sample_split": 0,
            "uf": 0, "um": 0, "um_bf16": 0, "umuf": 0, "umuf_bf16": 0,
            "umuf_split": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0

"""Device-memory model of an axis pass, and the auto slab size built on it.

The counterpart of the JAX package's ``_auto_slab``/``pass_slab``
(``flowdenoising_tpu/core/pipeline.py``), whose constants were fitted to a
16 GB TPU.  This model is fitted to what ``torch.cuda.max_memory_allocated``
measured on one NVIDIA H100 80GB HBM3 (``scripts/torch_memory_peaks.py``):
one pass over a padded window of ``n + 2*ks2`` planes of ``h x w`` holds
``bytes_per_padded_voxel(cfg)`` bytes per padded voxel at its peak, the
window and the pass output included.  The peak scales with the plane and
the padded depth and not with the displacement bound D: the kernels clamp
their samples in place and pad nothing by D (the JAX package's
``_pad_factor`` models its TPU operands' lane padding), and the measured
peaks at D 8, 48 and no bound are equal.

Around the pass sit what the caller keeps on the device:

- in memory (``core/pipeline.py``): the input volume; with slabs also the
  whole padded stack and the pass output the slabs are written into;
- streamed (``core/stream.py``): the next window, staged while this one
  runs, and the previous window's output, still being copied back, each
  with its copy moved between the file's layout and the pass layout.

Plain Python: the CPU tests call it with a budget; on the card the budget
is ``device_budget``.
"""

from __future__ import annotations

import torch

from flowdenoising_tpu_torch.config import FilterConfig
from flowdenoising_tpu_torch.ops.farneback import split_route
from flowdenoising_tpu_torch.utils.tracing import span

# Peak bytes per padded voxel of one pass, by the pass dtype (the no-flow
# Gaussian apart): the largest ratio measured over windows of 32-272
# planes of 128x1024 to 1024^2, in every tap mode and precision, at D 8,
# 48 and no bound (scripts/torch_memory_peaks.py on one NVIDIA H100 80GB
# HBM3): 15.29 (Gaussian), 85.31 (float32: solve, compose, symmetric,
# --precision bfloat16), 97.39 (--dtype bfloat16), 53.06 (--dtype
# bfloat16 with no bound, the split route, since its tap warps and compose
# pass run in K-sample-split and K-compose-run-split; 108.10 while they
# gathered in plain PyTorch with int64 indices, 227.91 while its phase 1
# was plain PyTorch too), rounded up.
BYTES_PER_PADDED_VOXEL = {"gaussian": 16.0, "float32": 88.0,
                          "bfloat16": 100.0, "bfloat16_nobound": 56.0}
# What a presmoothed pass adds (its blurred float32 copy of the window:
# 89.31 measured against 85.31).
PRESMOOTH_BYTES_PER_PADDED_VOXEL = 4.0
# Small allocations beside the pass (the cuBLAS workspace of the resize
# products, 32 MiB measured; resize matrices, index vectors), in bytes.
OVERHEAD_BYTES = 64 * 2 ** 20
# Share of the card's free memory a pass may plan for: the rest absorbs
# the caching allocator's fragmentation (the blocks it held peaked at
# 1.3-1.6x the allocated peak in the same measurements).
HEADROOM = 0.8
# Smallest auto slab: below it the halo recompute (2*ks2 planes a window)
# dominates.
SLAB_FLOOR = 8


def bytes_per_padded_voxel(cfg: FilterConfig) -> float:
    """The model's peak bytes per padded voxel of a pass under ``cfg``."""
    if not cfg.use_flow:
        return BYTES_PER_PADDED_VOXEL["gaussian"]
    f = cfg.flow
    b = BYTES_PER_PADDED_VOXEL["bfloat16_nobound" if split_route(f) else f.dtype]
    if f.presmooth and f.presmooth > 0:
        b += PRESMOOTH_BYTES_PER_PADDED_VOXEL
    return b


def pass_bytes(cfg: FilterConfig, n_padded: int, h: int, w: int) -> int:
    """The model's peak of one pass over a padded window of ``n_padded``
    planes of ``h x w``, the window and the output included."""
    return int(bytes_per_padded_voxel(cfg) * n_padded * h * w
               + OVERHEAD_BYTES)


def resident_bytes(n: int, h: int, w: int, ks2: int, slab: int | None,
                   streamed: bool) -> int:
    """float32 bytes the caller keeps on the device beside a pass over
    windows of ``slab`` output planes (None: the whole axis of ``n``)."""
    plane = 4 * h * w
    if streamed:
        # the next window and its copy in pass layout, the previous
        # output and its copy in the file's layout
        s = n if slab is None else slab
        return plane * 2 * ((s + 2 * ks2) + s)
    if slab is None:
        return plane * n
    return plane * (n + (n + 2 * ks2) + n)


def window_peak_bytes(cfg: FilterConfig, n: int, h: int, w: int, ks2: int,
                      slab: int | None, streamed: bool = False) -> int:
    """The model's device peak while a pass of an ``n``-plane axis runs
    over windows of ``slab`` output planes (None: the whole axis)."""
    s = n if slab is None else min(slab, n)
    return (pass_bytes(cfg, s + 2 * ks2, h, w)
            + resident_bytes(n, h, w, ks2, slab, streamed))


def denoise_peak_bytes(cfg: FilterConfig, shape, ks2s, slabs=(None,) * 3,
                       streamed: bool = False) -> int:
    """The model's device peak of a 3-pass denoise of a (Z, Y, X) volume:
    the largest of its passes' (pass i filters axis i, planes in the
    pipeline's layouts)."""
    z, y, x = shape
    passes = [(z, y, x), (y, z, x), (x, z, y)]
    return max(window_peak_bytes(cfg, n, h, w, ks2, slab, streamed)
               for (n, h, w), ks2, slab in zip(passes, ks2s, slabs))


def device_budget(device) -> int | None:
    """Bytes a pass may plan for on ``device``: ``HEADROOM`` of what the
    card has free, counting the blocks the caching allocator holds unused;
    None (no model) on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    with span("fdt.drain.mem_info"):
        free, _ = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return int(HEADROOM * (free + cached))


def pass_slab(cfg: FilterConfig, n: int, h: int, w: int, ks2: int,
              budget: int | None, streamed: bool = False) -> int | None:
    """Output planes a window of this pass (None: the whole axis).

    ``cfg.slab_size`` when set; else the whole axis where the model's peak
    fits ``budget`` (None: no budget), else the largest slab that fits,
    balanced over the axis and never rounded up past the model, and not
    below ``SLAB_FLOOR``.
    """
    if cfg.slab_size is not None:
        return cfg.slab_size
    if budget is None:
        return None
    if window_peak_bytes(cfg, n, h, w, ks2, None, streamed) <= budget:
        return None
    slab = n
    while slab > SLAB_FLOOR and window_peak_bytes(
            cfg, n, h, w, ks2, slab, streamed) > budget:
        slab -= 1
    n_slabs = -(-n // slab)
    return min(slab, -(-n // n_slabs))

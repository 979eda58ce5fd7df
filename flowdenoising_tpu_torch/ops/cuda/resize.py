"""K-resize wrapper (CUDA source ``flowdenoising_tpu_torch/csrc/resize.cu``).

The kernel replaces no TPU kernel: the JAX package resizes with two dense
einsums.  ``ops.resize`` runs it on a CUDA float32 tensor over the tap
tables it keeps on the card (``ops.resize.device_table``).
"""

from __future__ import annotations

import torch

from flowdenoising_tpu_torch.ops.cuda import launch, planes


def resize(img: torch.Tensor, out_hw: tuple[int, int],
           rows: tuple[torch.Tensor, int],
           cols: tuple[torch.Tensor, int]) -> torch.Tensor:
    """K-resize: (..., H, W) float32 on the card -> (..., H', W') in one
    launch, over the tap tables ``rows`` (H -> H') and ``cols`` (W -> W'),
    each (the table on the card: n_out int32 starts, then the n_out x taps
    float32 weights' bits; taps).  Each sum is taken in ascending source
    order, as the dense products of ``ops.resize._apply_separable`` take it
    wherever cuBLAS sums in order.  Raises for any other device or dtype."""
    x = planes("resize", img)
    h, w = x.shape[1:]
    h2, w2 = out_hw
    (row_table, rtaps), (col_table, ctaps) = rows, cols
    out = torch.empty((x.shape[0], h2, w2), dtype=torch.float32,
                      device=x.device)
    launch("fdt_resize", x.device, x.data_ptr(), out.data_ptr(), x.shape[0],
           h, w, h2, w2, row_table.data_ptr(), rtaps, col_table.data_ptr(),
           ctaps)
    return out.reshape(tuple(img.shape[:-2]) + (h2, w2))

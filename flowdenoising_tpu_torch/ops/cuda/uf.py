"""K-uf wrapper: the box sum and 2x2 solve of one Farneback iteration
(port of the Pallas kernel ``flowdenoising_tpu/ops/pallas/update_flow.py:
_uf_kernel``; CUDA source ``flowdenoising_tpu_torch/csrc/uf.cu``)."""

from __future__ import annotations

import numpy as np
import torch

from flowdenoising_tpu_torch.ops.cuda import check_operands, entry, launch
from flowdenoising_tpu_torch.ops.cuda.umuf import SMEM_PER_BLOCK


def check_shapes(m: torch.Tensor) -> None:
    """Raise ValueError unless M is (B, 5, H, W)."""
    if m.ndim != 4 or m.shape[1] != 5:
        raise ValueError(f"update_flow: expected M (B, 5, H, W); got "
                         f"{tuple(m.shape)}")


def update_flow(m: torch.Tensor, winsize: int) -> torch.Tensor:
    """K-uf: box-aggregate M (B, 5, H, W) over ``winsize`` (scaled by
    1/winsize^2) and solve the per-pixel 2x2 systems, in one launch on the
    card; returns the flow (B, 2, H, W), channel 0 = x.  Raises for other
    operands, and for a winsize whose window halo does not fit the kernel's
    shared-memory tile.
    """
    check_shapes(m)
    b, _, h, w = m.shape
    check_operands("update_flow", [("M", m, (torch.float32,))], batch=b)
    if entry("fdt_update_flow_smem")(winsize) > SMEM_PER_BLOCK:
        raise ValueError(f"update_flow: winsize {winsize} needs a larger "
                         "window halo than the kernel's shared-memory tile "
                         "holds")
    flow = torch.empty((b, 2, h, w), dtype=m.dtype, device=m.device)
    inv_ws2 = float(np.float32(1.0 / float(winsize * winsize)))
    launch("fdt_update_flow", m.device, m.data_ptr(), flow.data_ptr(), b, h,
           w, winsize, inv_ws2)
    return flow

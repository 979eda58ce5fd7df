"""K-uf wrapper: the box sum and 2x2 solve of one Farneback iteration
(port of the Pallas kernel ``flowdenoising_tpu/ops/pallas/update_flow.py:
_uf_kernel``; CUDA source ``flowdenoising_tpu_torch/csrc/uf.cu``)."""

from __future__ import annotations

import numpy as np
import torch

from flowdenoising_tpu_torch.ops.cuda import LAUNCHES
from flowdenoising_tpu_torch.ops.cuda.build import check, load_library

# shared memory one block may take on the H100 (227 KB)
_MAX_SMEM_BYTES = 232448


def update_flow(m: torch.Tensor, winsize: int) -> torch.Tensor:
    """Box-aggregate M (B, 5, H, W) over ``winsize`` (scaled by
    1/winsize^2) and solve the per-pixel 2x2 systems; returns the flow
    (B, 2, H, W), channel 0 = x.

    A CPU tensor takes the plain version (``ops.farneback.
    update_flow_plain``), a CUDA tensor one kernel launch; any other device
    raises, and so does a winsize whose window halo does not fit the
    kernel's shared-memory tile.
    """
    if m.ndim != 4 or m.shape[1] != 5:
        raise ValueError(f"update_flow: expected M (B, 5, H, W); got "
                         f"{tuple(m.shape)}")
    if m.device.type == "cpu":
        # imported here: ops.farneback imports this module
        from flowdenoising_tpu_torch.ops.farneback import update_flow_plain
        return update_flow_plain(m, winsize)
    if m.device.type != "cuda":
        raise ValueError(f"update_flow: no kernel for device {m.device}")
    if m.dtype != torch.float32 or not m.is_contiguous():
        raise ValueError(f"update_flow: M must be contiguous float32; got "
                         f"{m.dtype}")
    b, _, h, w = m.shape
    if b > 65535:
        raise ValueError(f"update_flow: batch {b} exceeds the grid's 65535")
    lib = load_library()
    if lib.fdt_update_flow_smem(winsize) > _MAX_SMEM_BYTES:
        raise ValueError(f"update_flow: winsize {winsize} needs a larger "
                         "window halo than the kernel's shared-memory tile "
                         "holds")
    flow = torch.empty((b, 2, h, w), dtype=m.dtype, device=m.device)
    inv_ws2 = float(np.float32(1.0 / float(winsize * winsize)))
    rc = lib.fdt_update_flow(m.data_ptr(), flow.data_ptr(), b, h, w, winsize,
                             inv_ws2, torch.cuda.current_stream(m.device).cuda_stream)
    check(rc, "fdt_update_flow")
    LAUNCHES["uf"] += 1
    return flow

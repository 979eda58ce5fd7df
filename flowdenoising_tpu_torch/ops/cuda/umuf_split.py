"""K-umuf-split wrapper: the bf16 split Farneback iteration with no bound,
phase 1 and every iteration of a pyramid level in one launch (the port of
the Pallas kernel ``flowdenoising_tpu/ops/pallas/update_flow.py:
_uf_kernel`` on the split route, with the XLA phase 1 in front of it; CUDA
source ``flowdenoising_tpu_torch/csrc/umuf_split.cu``).

The kernel has K-umuf's tile loop and shared-memory layout, so
``plan_umuf`` plans it.
"""

from __future__ import annotations

import numpy as np
import torch

from flowdenoising_tpu_torch.ops.cuda import check_operands, launch
from flowdenoising_tpu_torch.ops.cuda.umuf import (
    SMEM_PER_BLOCK, UmufPlan, check_shapes, plan_umuf)


def plan_split(h: int, w: int, winsize: int, iters: int,
               per_launch: int | None = None) -> UmufPlan:
    """K-umuf-split's plan: ``plan_umuf``'s, and for a winsize whose window
    halo does not fit two blocks on an SM, its plan at one block an SM, so
    that the split route takes every winsize that K-uf, which ran it before,
    takes (``ops/cuda/uf.py``: up to 85).  Raises ValueError past that."""
    try:
        return plan_umuf(h, w, winsize, iters, per_launch)
    except ValueError:
        return plan_umuf(h, w, winsize, iters, per_launch,
                         smem_limit=SMEM_PER_BLOCK)


def umuf_split_iterate(r0: torch.Tensor, r1: torch.Tensor,
                       flow: torch.Tensor, iters: int, winsize: int,
                       per_launch: int | None = None) -> torch.Tensor:
    """K-umuf-split: ``iters`` split Farneback iterations with no bound,
    ``flow <- update_flow_plain(update_matrices_xla(r0, r1, flow).float(),
    winsize)``, on the card as ``plan_split`` plans them, ``per_launch``
    iterations a launch if given; returns the float32 flow (B, 2, H, W) of
    the last one.

    r0, r1: (B, 5, H, W) bfloat16 expansions of target and reference (the
    split route's pyramid levels); flow: (B, 2, H, W), channel 0 = x,
    bfloat16 (the coarsest level's first iteration runs wholly in bf16) or
    float32.  Raises for other operands.
    """
    b, h, w = check_shapes("umuf_split_iterate", r0, r1, flow)
    check_operands("umuf_split_iterate", [
        ("r0", r0, (torch.bfloat16,)),
        ("r1", r1, (torch.bfloat16,)),
        ("flow", flow, (torch.bfloat16, torch.float32))], batch=b)
    plan = plan_split(h, w, winsize, iters, per_launch)
    inv_ws2 = float(np.float32(1.0 / float(winsize * winsize)))
    bufs = [torch.empty(flow.shape, dtype=torch.float32, device=flow.device)
            for _ in range(min(len(plan.launches), 2))]
    cur = flow
    for i, k in enumerate(plan.launches):
        nxt = bufs[i % 2]
        launch("fdt_umuf_split", r0.device, r0.data_ptr(), r1.data_ptr(),
               cur.data_ptr(), int(cur.dtype == torch.bfloat16),
               nxt.data_ptr(), b, h, w, winsize, inv_ws2, k, plan.tile_y,
               plan.tile_x, plan.threads)
        cur = nxt
    return cur

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

from flowdenoising_tpu_torch.ops.cuda import LAUNCHES
from flowdenoising_tpu_torch.ops.cuda.build import check, load_library
from flowdenoising_tpu_torch.ops.cuda.umuf import (
    SMEM_PER_BLOCK, UmufPlan, plan_umuf)


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
    """``iters`` split Farneback iterations with no bound, ``flow <-
    update_flow_plain(update_matrices_xla(r0, r1, flow).float(),
    winsize)``; returns the float32 flow (B, 2, H, W) of the last one.

    r0, r1: (B, 5, H, W) bfloat16 expansions of target and reference (the
    split route's pyramid levels); flow: (B, 2, H, W), channel 0 = x,
    bfloat16 (the coarsest level's first iteration runs wholly in bf16) or
    float32.

    A CPU tensor takes the plain version (``ops.farneback.
    split_iterate_plain``); a CUDA tensor runs the kernel as ``plan_split``
    plans it, ``per_launch`` iterations a launch if given; any other device
    raises, and so do other dtypes or layouts on the card.
    """
    b, _, h, w = flow.shape
    if (r0.shape != (b, 5, h, w) or r1.shape != r0.shape
            or flow.shape != (b, 2, h, w)):
        raise ValueError(f"umuf_split_iterate: expected r0, r1 (B, 5, H, W) "
                         f"and flow (B, 2, H, W); got {tuple(r0.shape)}, "
                         f"{tuple(r1.shape)}, {tuple(flow.shape)}")
    if r0.device.type == "cpu":
        # imported here: ops.farneback imports this module
        from flowdenoising_tpu_torch.ops.farneback import split_iterate_plain
        return split_iterate_plain(r0, r1, flow, iters, winsize)
    if r0.device.type != "cuda":
        raise ValueError(f"umuf_split_iterate: no kernel for device {r0.device}")
    for name, t, dtypes in (("r0", r0, (torch.bfloat16,)),
                            ("r1", r1, (torch.bfloat16,)),
                            ("flow", flow, (torch.bfloat16, torch.float32))):
        if (t.dtype not in dtypes or t.device != r0.device
                or not t.is_contiguous()):
            raise ValueError(f"umuf_split_iterate: {name} must be contiguous "
                             f"{' or '.join(map(str, dtypes))} on {r0.device}")
    if b > 65535:
        raise ValueError(f"umuf_split_iterate: batch {b} exceeds the grid's "
                         "65535")
    plan = plan_split(h, w, winsize, iters, per_launch)
    launch = load_library().fdt_umuf_split
    stream = torch.cuda.current_stream(r0.device).cuda_stream
    inv_ws2 = float(np.float32(1.0 / float(winsize * winsize)))
    bufs = [torch.empty(flow.shape, dtype=torch.float32, device=flow.device)
            for _ in range(min(len(plan.launches), 2))]
    cur = flow
    for i, k in enumerate(plan.launches):
        nxt = bufs[i % 2]
        rc = launch(r0.data_ptr(), r1.data_ptr(), cur.data_ptr(),
                    int(cur.dtype == torch.bfloat16), nxt.data_ptr(), b, h, w,
                    winsize, inv_ws2, k, plan.tile_y, plan.tile_x,
                    plan.threads, stream)
        check(rc, "fdt_umuf_split")
        LAUNCHES["umuf_split"] += 1
        cur = nxt
    return cur

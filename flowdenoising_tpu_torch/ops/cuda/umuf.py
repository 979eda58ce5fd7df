"""K-umuf wrapper: chained fused Farneback iterations at one pyramid level
(port of the Pallas kernel ``flowdenoising_tpu/ops/pallas/umuf.py:
_umuf_kernel``; CUDA source ``flowdenoising_tpu_torch/csrc/umuf.cu``)."""

from __future__ import annotations

import numpy as np
import torch

from flowdenoising_tpu_torch.ops.cuda import LAUNCHES
from flowdenoising_tpu_torch.ops.cuda.build import check, load_library


def umuf_iterate(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor,
                 iters: int, d: int | None, winsize: int) -> torch.Tensor:
    """``iters`` Farneback iterations ``flow <- update_flow(update_matrices(
    r0, r1, flow, d), winsize)``.

    r0, r1: (B, 5, H, W) polynomial expansions of target and reference;
    flow: (B, 2, H, W), channel 0 = x.  ``d`` bounds the sampling
    displacement (None: no clamp).  Returns a new (B, 2, H, W) flow.

    A CPU tensor takes the plain version (``ops.farneback.
    umuf_iterate_plain``), a CUDA tensor one kernel launch per iteration;
    any other device raises.
    """
    b, _, h, w = flow.shape
    if (r0.shape != (b, 5, h, w) or r1.shape != r0.shape
            or flow.shape != (b, 2, h, w)):
        raise ValueError(f"umuf_iterate: expected r0, r1 (B, 5, H, W) and "
                         f"flow (B, 2, H, W); got {tuple(r0.shape)}, "
                         f"{tuple(r1.shape)}, {tuple(flow.shape)}")
    if r0.device.type == "cpu":
        # imported here: ops.farneback imports this module
        from flowdenoising_tpu_torch.ops.farneback import umuf_iterate_plain
        return umuf_iterate_plain(r0, r1, flow, iters, d, winsize)
    if r0.device.type != "cuda":
        raise ValueError(f"umuf_iterate: no kernel for device {r0.device}")
    for name, t in (("r0", r0), ("r1", r1), ("flow", flow)):
        if (t.dtype != torch.float32 or t.device != r0.device
                or not t.is_contiguous()):
            raise ValueError(f"umuf_iterate: {name} must be contiguous "
                             f"float32 on {r0.device}")
    if b > 65535:
        raise ValueError(f"umuf_iterate: batch {b} exceeds the grid's 65535")
    lib = load_library()
    stream = torch.cuda.current_stream(r0.device).cuda_stream
    clamp = int(d is not None)
    dval = 0.0 if d is None else float(d)
    inv_ws2 = float(np.float32(1.0 / float(winsize * winsize)))
    bufs = [torch.empty_like(flow), torch.empty_like(flow)]
    cur = flow
    for i in range(iters):
        nxt = bufs[i % 2]
        rc = lib.fdt_umuf_step(
            r0.data_ptr(), r1.data_ptr(), cur.data_ptr(), nxt.data_ptr(),
            b, h, w, dval, clamp, winsize, inv_ws2, stream)
        check(rc, "fdt_umuf_step")
        LAUNCHES["umuf"] += 1
        cur = nxt
    return cur

"""Per-axis filtering passes along axis 0 of a (N, H, W) stack.

Counterpart of ``flowdenoising_tpu/core/axis_filter.py``:

- ``gaussian_pass_padded``: plain Gaussian correlation along the axis (the
  ``-n`` path).
- ``of_pass_padded``: optical-flow-compensated accumulation, in one of two
  tap modes.  Solve (the default): for every output slice and tap,
  Farneback flow from the slice to the tap's neighbour is solved (seeded by
  the previous tap's flow), the neighbour is warped onto the slice by that
  flow (K-sample), and added in with the tap weight.  Compose: Farneback
  runs once per direction on every adjacent slice pair, and the flow to the
  tap at distance j is composed from the chain of adjacent flows, all taps
  of a pass in one K-compose-run launch.  In both, flow is chained outward
  from the center in two runs and reset to zero between them.

All output slices of a pass form one batch; the expansion pyramid of every
slice is built once per pass and shared by all taps.  With
``FlowConfig.presmooth`` the pyramid is built from an in-plane blurred copy
of the stack (``_estimation_stack``), while every tap warp samples the raw
stack.

The bf16 fast mode follows the JAX package's TPU path.  ``dtype``
bfloat16: the stack is rounded to bf16 first, the tap weights are bf16
constants, the pyramid is built in bf16 (``ops.farneback``), and the pass
rounds to bf16 where that path carries bf16 between kernels -- each tap's
solved flow, each weighted warp before it is added to the bf16
accumulator, the adjacent flows, and the compose carry after every tap;
the kernels compute in float32 from float32 copies, and the pass returns
float32.  ``precision`` bfloat16: the packed kernel forms sample the
pyramid's r1 and, in compose mode, the links and neighbours rounded to
bf16 (with a bound only).  The solve-mode tap warp has no packed form in
the JAX package: K-sample reads a float32 copy of the stack.

A bfloat16 pass with no bound (``ops.farneback.split_route``) runs what
the JAX package runs there, which has no fused kernel: each solve the
split iteration at every level (bf16 phase 1 in plain PyTorch, K-uf), the
tap flows carried in bf16, every warp the exact gather in bf16 arithmetic
(``ops.warp.displace_sample_xla``), and in compose mode the tap chain as
plain PyTorch operations in bf16 (``_compose_chain``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flowdenoising_tpu_torch.config import Boundary, FlowConfig
from flowdenoising_tpu_torch.ops.blur import gaussian_blur, rounded
from flowdenoising_tpu_torch.ops.cuda.compose import compose_run
from flowdenoising_tpu_torch.ops.farneback import (
    SOLVE_RANGE, flow_from_pyramids, polyexp_pyramid, split_route, tap_solver)
from flowdenoising_tpu_torch.ops.warp import (
    WARP_RANGE, displace_sample, displace_sample_xla)


def pad_stack(vol: torch.Tensor, pad: int, boundary: Boundary,
              mean_val: torch.Tensor | float | None = None) -> torch.Tensor:
    """Pad axis 0 of (N, H, W) by ``pad`` slices per side.

    WRAP is the reference main CLI's modular indexing (a pad longer than
    the axis wraps more than once); MEAN fills with ``mean_val`` (default:
    the stack's mean); REPLICATE repeats the edge slices.
    """
    if pad == 0:
        return vol
    n = vol.shape[0]
    if boundary is Boundary.WRAP:
        idx = np.arange(-pad, n + pad) % n
        return vol.index_select(0, torch.as_tensor(idx, device=vol.device))
    if boundary is Boundary.REPLICATE:
        idx = np.clip(np.arange(-pad, n + pad), 0, n - 1)
        return vol.index_select(0, torch.as_tensor(idx, device=vol.device))
    if boundary is Boundary.MEAN:
        if mean_val is None:
            mean_val = vol.mean()
        fill = torch.as_tensor(mean_val, dtype=vol.dtype, device=vol.device)
        fill = fill.expand((pad,) + tuple(vol.shape[1:]))
        return torch.cat([fill, vol, fill], dim=0)
    raise ValueError(f"unknown boundary {boundary}")


def gaussian_pass_padded(padded: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Gaussian correlation along axis 0 of a pre-padded stack
    (N + 2*ks2, H, W); returns the N interior output slices."""
    taps = np.asarray(taps, dtype=np.float64)
    n = padded.shape[0] - 2 * (len(taps) // 2)
    out = None
    for k in range(len(taps)):
        term = padded[k:k + n] * float(np.float32(taps[k]))
        out = term if out is None else out.add_(term)
    return out


def _estimation_stack(padded: torch.Tensor,
                      flow_cfg: FlowConfig) -> torch.Tensor:
    """The stack flows are estimated from: the raw padded stack, or, with
    ``flow_cfg.presmooth`` > 0, a copy blurred in-plane with that sigma
    (kernel size max(3, round(4 sigma) | 1), BORDER_REFLECT_101), as the
    JAX package's ``_estimation_stack``."""
    if not flow_cfg.presmooth or flow_cfg.presmooth <= 0:
        return padded
    ks = max(3, int(round(flow_cfg.presmooth * 4.0)) | 1)
    return gaussian_blur(padded, ks, flow_cfg.presmooth)


def of_pass_padded(padded: torch.Tensor, taps: np.ndarray,
                   flow_cfg: FlowConfig) -> torch.Tensor:
    """OF-compensated Gaussian pass along axis 0 of a pre-padded stack
    (N + 2*ks2, H, W); returns the N interior output slices.

    Accumulation order as the JAX package's: center tap first, then the
    backward run (offsets -1 .. -ks2), then the forward run (+1 .. +ks2).
    The accumulator is updated in place.  The result is float32.
    """
    taps = np.asarray(taps, dtype=np.float64)
    if len(taps) % 2 != 1:
        raise ValueError("kernel size must be odd")
    dtype = getattr(torch, flow_cfg.dtype)
    padded = padded.to(dtype)
    if flow_cfg.tap_mode == "compose":
        return _of_pass_composed(padded, taps, flow_cfg)
    ks2 = len(taps) // 2
    n = padded.shape[0] - 2 * ks2
    solve = tap_solver(_estimation_stack(padded, flow_cfg), ks2, n, flow_cfg)
    split = split_route(flow_cfg)
    # K-sample's source: the stack itself, or a float32 copy of the bf16
    # stack (exact), made once per pass; the split route's gather samples
    # the bf16 stack
    src = padded if split else padded.float()
    acc = padded[ks2:ks2 + n] * rounded(taps[ks2], dtype)
    for sign in (-1, +1):
        flow = None   # each run starts from zero flow
        for j in range(1, ks2 + 1):
            start = ks2 + sign * j
            flow = solve(start, flow if flow_cfg.use_initial_flow else None)
            if split:
                # the tap flow carried and sampled in bf16
                flow = flow.to(dtype)
                with torch.profiler.record_function(WARP_RANGE):
                    warped = displace_sample_xla(src[start:start + n],
                                                 flow[:, 0], flow[:, 1])
            else:
                if dtype != torch.float32:
                    flow = flow.to(dtype).float()
                warped = displace_sample(src[start:start + n], flow[:, 0],
                                         flow[:, 1], flow_cfg.max_displacement)
            acc.add_((warped * rounded(taps[ks2 + sign * j], dtype)).to(dtype))
    return acc.float()


def _of_pass_composed(padded: torch.Tensor, taps: np.ndarray,
                      flow_cfg: FlowConfig) -> torch.Tensor:
    """Composed-flow pass (``tap_mode="compose"``), the counterpart of the
    JAX package's ``_of_pass_composed``.

    Farneback runs once per direction on all adjacent slice pairs of the
    padded stack (``adj_fwd[k]``: slice k to k+1; ``adj_bwd[k]``: k+1 to
    k, or ``-adj_fwd`` with ``symmetric_adjacent``), with the bound
    tightened to ``min(D, adjacent_displacement)`` when both are set.  The
    flow to the tap at distance j is composed outward, F_j = F_{j-1} +
    warp(link, F_{j-1}), and each tap adds the neighbour warped by F_j; the
    whole pass is one K-compose-run launch, with the flow in registers.
    The adjacent solves take no seed, so
    ``use_initial_flow`` has no effect here.  padded is in the pass dtype;
    the result is float32.
    """
    ks2 = len(taps) // 2
    n = padded.shape[0] - 2 * ks2
    d = flow_cfg.max_displacement
    dtype = padded.dtype
    adj_cfg = flow_cfg
    if flow_cfg.adjacent_displacement is not None and d is not None:
        adj_cfg = dataclasses.replace(
            flow_cfg, max_displacement=min(d, flow_cfg.adjacent_displacement))
    r_levels = polyexp_pyramid(_estimation_stack(padded, flow_cfg), flow_cfg)
    lo = [r[:-1] for r in r_levels]
    hi = [r[1:] for r in r_levels]
    if split_route(flow_cfg):
        # no bound: adj_cfg is flow_cfg
        adj_fwd = flow_from_pyramids(lo, hi, flow_cfg, None).to(dtype)
        adj_bwd = (-adj_fwd if flow_cfg.symmetric_adjacent else
                   flow_from_pyramids(hi, lo, flow_cfg, None).to(dtype))
        del r_levels, lo, hi
        with torch.profiler.record_function(SOLVE_RANGE):
            return _compose_chain(padded, taps, adj_fwd, adj_bwd)
    # the adjacent flows in the pass dtype; the kernel's sources in bf16
    # for the packed form, else float32
    src = (torch.bfloat16 if flow_cfg.precision == "bfloat16" and d is not None
           else torch.float32)
    adj_fwd = flow_from_pyramids(lo, hi, adj_cfg, None).to(dtype).to(src)
    # symmetric: the backward links are -adj_fwd, which K-compose-run reads
    # with a sign (None), not as a negated copy
    adj_bwd = (None if flow_cfg.symmetric_adjacent else
               flow_from_pyramids(hi, lo, adj_cfg, None).to(dtype).to(src))
    del r_levels, lo, hi

    nb = padded.to(src)
    acc = (padded[ks2:ks2 + n] * rounded(taps[ks2], dtype)).float()
    # offsets -1 .. -ks2, then +1 .. +ks2
    weights = [rounded(taps[ks2 + sign * j], dtype)
               for sign in (-1, +1) for j in range(1, ks2 + 1)]
    return compose_run(adj_fwd, adj_bwd, nb, acc, weights, d,
                       round_carry=dtype != torch.float32)


def _compose_chain(padded: torch.Tensor, taps: np.ndarray,
                   adj_fwd: torch.Tensor, adj_bwd: torch.Tensor) -> torch.Tensor:
    """The compose pass with no bound, as the JAX package's tap scan runs it
    when it has no fused step (``flowdenoising_tpu/core/axis_filter.py:
    _of_pass_composed``, ``body_of``): per tap, F = (F + warp(link, F)) and
    acc += (warp(neighbour, F) * w), each warp the exact gather and each
    result rounded to the pass dtype, the carry F starting from zeros in
    the pass dtype in each run.  adj_*: (N + 2*ks2 - 1, 2, H, W) in the
    pass dtype.  Plain PyTorch on the stack's device; returns float32."""
    dtype = padded.dtype
    ks2 = len(taps) // 2
    n = padded.shape[0] - 2 * ks2
    acc = padded[ks2:ks2 + n] * rounded(taps[ks2], dtype)
    # backward run (offsets -1 .. -ks2): the link of distance j at padded
    # index start; forward run (+1 .. +ks2): at start - 1
    for sign, adj, shift in ((-1, adj_bwd, 0), (+1, adj_fwd, -1)):
        flow = torch.zeros((n, 2) + tuple(padded.shape[1:]), dtype=dtype,
                           device=padded.device)
        for j in range(1, ks2 + 1):
            start = ks2 + sign * j
            link = adj[start + shift:start + shift + n]
            flow = (flow + displace_sample_xla(link, flow[:, 0], flow[:, 1])
                    ).to(dtype)
            warped = displace_sample_xla(padded[start:start + n], flow[:, 0],
                                         flow[:, 1])
            acc.add_((warped * rounded(taps[ks2 + sign * j], dtype)).to(dtype))
    return acc.float()

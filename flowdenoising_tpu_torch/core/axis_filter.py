"""Per-axis filtering passes along axis 0 of a (N, H, W) stack.

Counterpart of ``flowdenoising_tpu/core/axis_filter.py``.  ``gaussian_pass``
and ``of_pass`` pad a (N, H, W) stack (``pad_stack``) and run the pass over
it, on the stack's device (an array goes to ``device``); the pipeline pads
and calls the ``*_padded`` passes itself:

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

A bfloat16 pass with no bound (``ops.farneback.split_route``) computes
what the JAX package runs there, which has no fused kernel: each solve the
split iteration at every level (K-umuf-split), the tap flows carried in
bf16, every warp the exact gather in bf16 arithmetic
(``ops.warp.displace_sample_xla``; K-sample-split, which also adds the
weighted warp into the accumulator), and in compose mode the tap chain in
bf16 (``ops.compose.compose_chain_plain``; one K-compose-run-split
launch a pass).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flowdenoising_tpu_torch.config import Boundary, FlowConfig
from flowdenoising_tpu_torch.ops.blur import gaussian_blur, rounded
from flowdenoising_tpu_torch.ops.compose import compose_run, compose_run_split
from flowdenoising_tpu_torch.ops.device import as_tensors
from flowdenoising_tpu_torch.ops.farneback import (
    flow_from_pyramids, polyexp_pyramid, split_route, tap_solver)
from flowdenoising_tpu_torch.ops.warp import displace_sample, sample_split
from flowdenoising_tpu_torch.utils.tracing import (
    COMPOSE_RANGE, WARP_RANGE, span)


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
    if boundary in (Boundary.WRAP, Boundary.REPLICATE):
        idx = np.arange(-pad, n + pad)
        idx = idx % n if boundary is Boundary.WRAP else np.clip(idx, 0, n - 1)
        with span("fdt.drain.pad_index"):
            idx = torch.as_tensor(idx, device=vol.device)
        return vol.index_select(0, idx)
    if boundary is Boundary.MEAN:
        if mean_val is None:
            mean_val = vol.mean()
        if (isinstance(mean_val, torch.Tensor)
                and mean_val.device == vol.device):
            fill = mean_val.to(vol.dtype)
        else:
            # a value from the host: its copy drains the stream
            with span("fdt.drain.pad_fill"):
                fill = torch.as_tensor(mean_val, dtype=vol.dtype,
                                       device=vol.device)
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


def gaussian_pass(vol, taps: np.ndarray, boundary: Boundary = Boundary.WRAP,
                  mean_val=None, device="cuda") -> torch.Tensor:
    """Gaussian correlation along axis 0 of (N, H, W), in float32: the
    stack padded by ``boundary`` (MEAN: with ``mean_val``, default the
    stack's mean), then ``gaussian_pass_padded``."""
    vol, = as_tensors(vol, device=device)
    padded = pad_stack(vol.float(), len(taps) // 2, boundary, mean_val)
    return gaussian_pass_padded(padded, taps)


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
    # stack (exact), made once per pass; K-sample-split samples the bf16
    # stack
    src = padded if split else padded.float()
    acc = padded[ks2:ks2 + n] * rounded(taps[ks2], dtype)
    for sign in (-1, +1):
        flow = None   # each run starts from zero flow
        for j in range(1, ks2 + 1):
            start = ks2 + sign * j
            flow = solve(start, flow if flow_cfg.use_initial_flow else None)
            weight = rounded(taps[ks2 + sign * j], dtype)
            if split:
                # the tap flow carried and sampled in bf16, the weighted
                # warp added into the accumulator by the kernel
                flow = flow.to(dtype)
                with span(WARP_RANGE):
                    sample_split(src[start:start + n], flow[:, 0],
                                 flow[:, 1], acc, weight)
            else:
                if dtype != torch.float32:
                    flow = flow.to(dtype).float()
                with span(WARP_RANGE):
                    warped = displace_sample(src[start:start + n], flow[:, 0],
                                             flow[:, 1],
                                             flow_cfg.max_displacement)
                acc.add_((warped * weight).to(dtype))
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
    whole pass is one K-compose-run launch (K-compose-run-split on the
    split route), with the flow in registers.
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
    # offsets -1 .. -ks2, then +1 .. +ks2
    weights = [rounded(taps[ks2 + sign * j], dtype)
               for sign in (-1, +1) for j in range(1, ks2 + 1)]
    if split_route(flow_cfg):
        # no bound: adj_cfg is flow_cfg; symmetric: the backward links are
        # -adj_fwd, which K-compose-run-split reads with a sign (None)
        adj_fwd = flow_from_pyramids(lo, hi, flow_cfg, None).to(dtype)
        adj_bwd = (None if flow_cfg.symmetric_adjacent else
                   flow_from_pyramids(hi, lo, flow_cfg, None).to(dtype))
        del r_levels, lo, hi
        acc = padded[ks2:ks2 + n] * rounded(taps[ks2], dtype)
        with span(COMPOSE_RANGE):
            compose_run_split(adj_fwd, adj_bwd, padded, acc, weights)
        return acc.float()
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
    with span(COMPOSE_RANGE):
        return compose_run(adj_fwd, adj_bwd, nb, acc, weights, d,
                           round_carry=dtype != torch.float32)


def of_pass(vol, taps: np.ndarray, flow_cfg: FlowConfig,
            boundary: Boundary = Boundary.WRAP, mean_val=None,
            device="cuda") -> torch.Tensor:
    """OF-compensated Gaussian pass along axis 0 of (N, H, W): the stack
    taken to ``flow_cfg.dtype``, padded by ``boundary`` (MEAN: with
    ``mean_val``, default the mean of the cast stack), then
    ``of_pass_padded``.  The cast comes before the pad, as in the JAX
    package; the pipeline pads its float32 volume first, which gives the
    same stack for WRAP and REPLICATE.  Returns float32."""
    vol, = as_tensors(vol, device=device)
    padded = pad_stack(vol.to(getattr(torch, flow_cfg.dtype)), len(taps) // 2,
                       boundary, mean_val)
    return of_pass_padded(padded, taps, flow_cfg)

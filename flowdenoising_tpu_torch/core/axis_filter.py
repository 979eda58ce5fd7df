"""Per-axis filtering passes along axis 0 of a (N, H, W) stack.

Counterpart of ``flowdenoising_tpu/core/axis_filter.py`` (solve mode):

- ``gaussian_pass_padded``: plain Gaussian correlation along the axis (the
  ``-n`` path).
- ``of_pass_padded``: optical-flow-compensated accumulation.  For every
  output slice and tap, Farneback flow from the slice to the tap's
  neighbour is solved (seeded by the previous tap's flow), the neighbour is
  warped onto the slice by that flow (K-sample), and added in with the tap
  weight.  Flow is chained outward from the center in two runs and reset
  to zero between them.

All output slices of a pass form one batch; the expansion pyramid of every
slice is built once per pass and shared by all taps.
"""

from __future__ import annotations

import numpy as np
import torch

from flowdenoising_tpu_torch.config import Boundary, FlowConfig
from flowdenoising_tpu_torch.ops.farneback import tap_solver
from flowdenoising_tpu_torch.ops.warp import displace_sample


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


def of_pass_padded(padded: torch.Tensor, taps: np.ndarray,
                   flow_cfg: FlowConfig) -> torch.Tensor:
    """OF-compensated Gaussian pass along axis 0 of a pre-padded stack
    (N + 2*ks2, H, W); returns the N interior output slices.

    Accumulation order as the JAX package's: center tap first, then the
    backward run (offsets -1 .. -ks2), then the forward run (+1 .. +ks2).
    The accumulator is updated in place.
    """
    flow_cfg.check_ported()
    taps = np.asarray(taps, dtype=np.float64)
    if len(taps) % 2 != 1:
        raise ValueError("kernel size must be odd")
    ks2 = len(taps) // 2
    n = padded.shape[0] - 2 * ks2
    solve = tap_solver(padded, ks2, n, flow_cfg)
    acc = padded[ks2:ks2 + n] * float(np.float32(taps[ks2]))
    for sign in (-1, +1):
        flow = None   # each run starts from zero flow
        for j in range(1, ks2 + 1):
            start = ks2 + sign * j
            flow = solve(start, flow if flow_cfg.use_initial_flow else None)
            warped = displace_sample(padded[start:start + n], flow[:, 0],
                                     flow[:, 1], flow_cfg.max_displacement)
            acc.add_(warped * float(np.float32(taps[ks2 + sign * j])))
    return acc

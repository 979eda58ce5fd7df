"""The comparison that decides ``correct``.

Each output of the sampled pool volume that the window produced is held
against the plain reference's denoise of that volume, over every voxel:

- ``max_err``: the largest |output - reference|, over the reference's
  range (max - min);
- ``rms_err``: the root mean square of output - reference, over the
  reference's standard deviation.

A non-finite difference reads infinite.  Each number has its limit in
``benchmarks/limits/<cell>.json`` (set from the program's readings over a
dozen seeds and the lower-precision control's; see ``PERF.md``), and an
output fails when either number passes its limit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NUMBERS = ("max_err", "rms_err")


def readings(out: np.ndarray, ref: torch.Tensor) -> dict:
    """The compared numbers of one output against the reference (on the
    reference's device)."""
    d = torch.as_tensor(out, device=ref.device).sub_(ref)
    if not bool(torch.isfinite(d).all()):
        return dict.fromkeys(NUMBERS, math.inf)
    span = float(ref.max() - ref.min())
    return {"max_err": float(d.abs().max()) / span,
            "rms_err": float(d.square().mean().sqrt()) / float(ref.std())}


def failures(outputs: list, ref: torch.Tensor, limits: dict):
    """(worst reading of each number over ``outputs``, whether each output
    failed)."""
    worst = dict.fromkeys(NUMBERS, 0.0)
    bad = []
    for out in outputs:
        r = readings(out, ref)
        bad.append(any(r[k] > limits[k] for k in NUMBERS))
        worst = {k: max(worst[k], r[k]) for k in NUMBERS}
    return worst, bad


def judge(outputs: list, ref: torch.Tensor, limits: dict):
    """(worst reading of each number over ``outputs``, outputs failed)."""
    worst, bad = failures(outputs, ref, limits)
    return worst, sum(bad)

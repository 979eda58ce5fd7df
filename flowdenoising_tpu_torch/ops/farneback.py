"""Farneback dense optical flow.

Counterpart of ``flowdenoising_tpu/ops/farneback.py``; the algorithm of
``cv2.calcOpticalFlowFarneback``, staged as OpenCV stages it:

1. ``poly_expand``: quadratic polynomial expansion of each image, five
   channels ``[b_y, b_x, a_yy, a_xx, a_xy]`` in OpenCV's scaling.
2. ``update_matrices``: sample the reference's expansion at the displaced
   positions, form the per-pixel normal equations M = [G11, G12, G22, h1, h2].
3. ``update_flow``: box-aggregate M over ``winsize`` and solve the 2x2
   systems.
4. ``flow_from_pyramids``: coarse to fine over the pyramid levels, 2+3
   iterated ``cfg.iterations`` times per level.

Steps 2 and 3 are the plain version of the K-umuf kernel; on a CUDA tensor
each level's iterations run in the kernel (``ops.cuda.umuf.umuf_iterate``)
on every level, the smallest included.

Layout: channel-first with the batch leading -- expansions (B, 5, H, W),
flows (B, 2, H, W) with channel 0 = x -- so one slice range of a stack's
pyramid is a contiguous view.  ``farneback_flow`` keeps the JAX package's
channels-last (..., H, W, 2) flow at its interface.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from flowdenoising_tpu_torch.config import FlowConfig
from flowdenoising_tpu_torch.ops.blur import (
    _sep_correlate, box_blur_sum, corr1d, smooth_kernel_for_level)
from flowdenoising_tpu_torch.ops.cuda.umuf import umuf_iterate
from flowdenoising_tpu_torch.ops.resize import (
    pyramid_sizes, resize_area, resize_linear)
from flowdenoising_tpu_torch.ops.warp import displace_sample_plain

# Border down-weighting ramp (OpenCV farneback.cpp FarnebackUpdateMatrices).
_BORDER_RAMP = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], dtype=np.float64)
_BORDER = 5


@functools.lru_cache(maxsize=None)
def poly_exp_constants(n: int, sigma: float):
    """Gaussian applicability taps and inverse-Gram coefficients.

    Returns (g, xg, xxg, ig11, ig03, ig33, ig55); g/xg/xxg are length 2n+1
    float64 taps over offsets [-n, n].
    """
    if sigma < 1e-7:
        sigma = n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g

    G = np.zeros((6, 6), dtype=np.float64)
    s2 = float((g * x * x).sum())
    s4 = float((g * x * x * x * x).sum())
    G[0, 0] = 1.0
    G[1, 1] = G[2, 2] = s2
    G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = s2
    G[3, 3] = G[4, 4] = s4
    G[5, 5] = G[3, 4] = G[4, 3] = s2 * s2
    invG = np.linalg.inv(G)
    return g, xg, xxg, float(invG[1, 1]), float(invG[0, 3]), float(invG[3, 3]), float(invG[5, 5])


def poly_expand(img: torch.Tensor, n: int = 5, sigma: float = 1.2) -> torch.Tensor:
    """Quadratic polynomial expansion of (..., H, W) -> (..., 5, H, W).

    Channels: [b_y, b_x, a_yy, a_xx, a_xy] in OpenCV's internal scaling.
    Border handling: replicate, both axes.
    """
    g, xg, xxg, ig11, ig03, ig33, ig55 = poly_exp_constants(n, float(sigma))

    row0 = corr1d(img, g, -2, "edge")
    row1 = corr1d(img, xg, -2, "edge")
    row2 = corr1d(img, xxg, -2, "edge")

    b1 = corr1d(row0, g, -1, "edge")
    b2 = corr1d(row0, xg, -1, "edge")
    b4 = corr1d(row0, xxg, -1, "edge")
    b3 = corr1d(row1, g, -1, "edge")
    b6 = corr1d(row1, xg, -1, "edge")
    b5 = corr1d(row2, g, -1, "edge")

    return torch.stack([
        b3 * ig11,
        b2 * ig11,
        b1 * ig03 + b5 * ig33,
        b1 * ig03 + b4 * ig33,
        b6 * ig55,
    ], dim=-3)


@functools.lru_cache(maxsize=None)
def _border_scale_map(h: int, w: int) -> np.ndarray:
    """Per-pixel down-weighting of the outer 5-pixel band (float64, (H, W));
    where the two bands overlap (planes narrower than 10 px) both apply."""
    sy = np.ones(h, dtype=np.float64)
    sx = np.ones(w, dtype=np.float64)
    for i in range(min(_BORDER, h)):
        sy[i] *= _BORDER_RAMP[i]
    for i in range(min(_BORDER, h)):
        sy[h - 1 - i] *= _BORDER_RAMP[i]
    for i in range(min(_BORDER, w)):
        sx[i] *= _BORDER_RAMP[i]
    for i in range(min(_BORDER, w)):
        sx[w - 1 - i] *= _BORDER_RAMP[i]
    return np.outer(sy, sx)


def update_matrices(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor,
                    max_displacement: int | None = None) -> torch.Tensor:
    """Per-pixel normal-equation entries M = [G11, G12, G22, h1, h2]
    (phase 1 of K-umuf, plain).

    r0, r1: (..., 5, H, W) expansions of target and reference; flow:
    (..., 2, H, W).  r1 is sampled at the flow clamped to
    +-max_displacement (None: unclamped); the in-plane mask and the flow
    terms use the unclamped flow.  Returns (..., 5, H, W).
    """
    h, w = r0.shape[-2], r0.shape[-1]
    dx = flow[..., 0, :, :]
    dy = flow[..., 1, :, :]
    gx = torch.arange(w, dtype=r0.dtype, device=r0.device)
    gy = torch.arange(h, dtype=r0.dtype, device=r0.device).reshape(h, 1)
    x1 = torch.floor(gx + dx)
    y1 = torch.floor(gy + dy)
    inb = (x1 >= 0) & (x1 <= w - 2) & (y1 >= 0) & (y1 <= h - 2)

    s = displace_sample_plain(r1, dx, dy, max_displacement).unbind(-3)
    a = r0.unbind(-3)
    r4 = torch.where(inb, (a[2] + s[2]) * 0.5, a[2])
    r5 = torch.where(inb, (a[3] + s[3]) * 0.5, a[3])
    r6 = torch.where(inb, (a[4] + s[4]) * 0.25, a[4] * 0.5)
    r2 = (a[0] - torch.where(inb, s[0], 0.0)) * 0.5
    r3 = (a[1] - torch.where(inb, s[1], 0.0)) * 0.5

    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx

    scale = torch.as_tensor(_border_scale_map(h, w), dtype=r0.dtype,
                            device=r0.device)
    r2 = r2 * scale
    r3 = r3 * scale
    r4 = r4 * scale
    r5 = r5 * scale
    r6 = r6 * scale

    return torch.stack([
        r4 * r4 + r6 * r6,
        (r4 + r5) * r6,
        r5 * r5 + r6 * r6,
        r4 * r2 + r6 * r3,
        r6 * r2 + r5 * r3,
    ], dim=-3)


def update_flow(m: torch.Tensor, winsize: int) -> torch.Tensor:
    """Box-aggregate M (..., 5, H, W) over winsize (scaled by 1/winsize^2)
    and solve the per-pixel 2x2 system (phase 2 of K-umuf, plain).

    Returns flow (..., 2, H, W) with channel 0 = x displacement.
    """
    ms = box_blur_sum(m, winsize) * (1.0 / float(winsize * winsize))
    g11, g12, g22, h1, h2 = ms.unbind(-3)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    u = (g11 * h2 - g12 * h1) * idet
    v = (g22 * h1 - g12 * h2) * idet
    return torch.stack([u, v], dim=-3)


def umuf_iterate_plain(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor,
                       iters: int, d: int | None, winsize: int) -> torch.Tensor:
    """Plain version of K-umuf: ``iters`` chained Farneback iterations."""
    for _ in range(iters):
        flow = update_flow(update_matrices(r0, r1, flow, d), winsize)
    return flow


def _level_displacement(cfg: FlowConfig, level: int) -> int | None:
    """Sampling bound at a pyramid level: flows at level k are the full-
    resolution flow scaled by pyr_scale**k, so d_k = max(2, ceil(D *
    pyr_scale**k) + 1)."""
    if cfg.max_displacement is None:
        return None
    d = int(np.ceil(cfg.max_displacement * (cfg.pyr_scale ** level))) + 1
    return max(2, d)


def smoothed_level_image(img: torch.Tensor, level: int, out_hw: tuple[int, int],
                         pyr_scale: float = 0.5) -> torch.Tensor:
    """Pre-smoothed, resized image for one pyramid level (OpenCV: GaussianBlur
    of the full-resolution image with the level's sigma, then INTER_LINEAR
    resize to the level size)."""
    taps = smooth_kernel_for_level(level, pyr_scale)
    sm = _sep_correlate(img, taps, taps, "reflect")
    return resize_linear(sm, out_hw)


def image_pyramid(img: torch.Tensor, cfg: FlowConfig) -> list[torch.Tensor]:
    """Per-level smoothed/resized images, index 0 = full resolution."""
    h, w = img.shape[-2], img.shape[-1]
    levels = cfg.clamped_levels(h, w)
    sizes = pyramid_sizes(h, w, levels, cfg.pyr_scale)
    return [smoothed_level_image(img, k, sizes[k], cfg.pyr_scale)
            for k in range(levels + 1)]


def polyexp_pyramid(img: torch.Tensor, cfg: FlowConfig) -> list[torch.Tensor]:
    """Per-level expansions (..., 5, h_k, w_k) of (..., H, W) images."""
    return [poly_expand(i, cfg.poly_n, cfg.poly_sigma).contiguous()
            for i in image_pyramid(img, cfg)]


def flow_from_pyramids(r0_levels: list[torch.Tensor],
                       r1_levels: list[torch.Tensor], cfg: FlowConfig,
                       initial_flow: torch.Tensor | None = None) -> torch.Tensor:
    """Coarse-to-fine flow from precomputed expansion pyramids.

    r*_levels[k]: (B, 5, h_k, w_k); initial_flow: (B, 2, H, W) full
    resolution, INTER_AREA-resized to the coarsest level and scaled by
    pyr_scale**k.  Returns (B, 2, H, W).
    """
    levels = len(r0_levels) - 1
    flow = None
    for k in range(levels, -1, -1):
        r0 = r0_levels[k]
        hk, wk = r0.shape[-2], r0.shape[-1]
        if flow is None:
            if cfg.use_initial_flow and initial_flow is not None:
                flow = resize_area(initial_flow, (hk, wk)) * (cfg.pyr_scale ** k)
            else:
                flow = torch.zeros(r0.shape[:-3] + (2, hk, wk),
                                   dtype=r0.dtype, device=r0.device)
        else:
            flow = resize_linear(flow, (hk, wk)) * (1.0 / cfg.pyr_scale)
        flow = umuf_iterate(r0, r1_levels[k], flow.contiguous(),
                            cfg.iterations, _level_displacement(cfg, k),
                            cfg.winsize)
    return flow


def tap_solver(padded: torch.Tensor, interior_start: int, n: int,
               cfg: FlowConfig):
    """Per-pass tap-pair solver (counterpart of ``prepped_tap_solver``).

    Builds the expansion pyramid of the whole padded stack (N + 2*ks2, H, W)
    once.  The returned ``solve(start, init_flow)`` solves the flows from
    the targets ``padded[interior_start:interior_start+n]`` to the
    references ``padded[start:start+n]``; both are views into the one
    pyramid, so no tap copies an operand.  Returns (n, 2, H, W).
    """
    r_levels = polyexp_pyramid(padded, cfg)
    r0_levels = [r[interior_start:interior_start + n] for r in r_levels]

    def solve(start: int, init_flow: torch.Tensor | None = None):
        r1_levels = [r[start:start + n] for r in r_levels]
        return flow_from_pyramids(r0_levels, r1_levels, cfg, init_flow)

    return solve


def farneback_flow(reference: torch.Tensor, target: torch.Tensor,
                   cfg: FlowConfig = FlowConfig(),
                   initial_flow: torch.Tensor | None = None) -> torch.Tensor:
    """Dense optical flow from ``target`` to ``reference`` (cv2 order of the
    reference wrapper: prev=target, next=reference).

    reference, target: (..., H, W) float32 images.  initial_flow and the
    result: (..., H, W, 2), channel 0 = x displacement, such that
    ``warp_slices(reference, flow) ~ target``.
    """
    cfg.check_ported()
    lead = target.shape[:-2]
    h, w = target.shape[-2], target.shape[-1]
    t = target.reshape(-1, h, w).to(torch.float32)
    r = reference.reshape(-1, h, w).to(torch.float32)
    f0 = None
    if initial_flow is not None:
        f0 = initial_flow.reshape(-1, h, w, 2).permute(0, 3, 1, 2)
    flow = flow_from_pyramids(polyexp_pyramid(t, cfg), polyexp_pyramid(r, cfg),
                              cfg, f0)
    return flow.permute(0, 2, 3, 1).reshape(lead + (h, w, 2))

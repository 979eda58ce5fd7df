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

``update_matrices_plain`` and ``update_flow_plain`` are the plain versions
of the kernels K-um and K-uf (wrappers ``update_matrices`` and
``update_flow`` in ``ops.cuda.um``, ``ops.cuda.uf``).  With a bound, or in
float32, the solver fuses 2+3: on a CUDA tensor each level's iterations
run in K-umuf (``ops.cuda.umuf.umuf_iterate``) on every level, the smallest
included; ``umuf_iterate_plain`` is its plain version.  K-um and K-uf run
only in the ``-v 2`` stage report.

Layout: channel-first with the batch leading -- expansions (B, 5, H, W),
flows (B, 2, H, W) with channel 0 = x -- so one slice range of a stack's
pyramid is a contiguous view.  ``farneback_flow`` keeps the JAX package's
channels-last (..., H, W, 2) flow at its interface.

The bf16 fast mode, as the JAX package runs it on the TPU:

- ``--dtype bfloat16``: the pyramid is built in bfloat16 arithmetic (taps,
  resize weights and the expansion's constants rounded to bfloat16); the
  kernels read float32 copies of its values, and the flows stay float32.
- ``--precision bfloat16``: the levels where the JAX package runs its
  Pallas kernel (a finite bound, not the tiny route of ``_tiny_level``)
  sample r1 rounded to bfloat16, through the packed form K-umuf-bf16
  (``_packed_at_level``).
- ``--dtype bfloat16`` with no bound (``split_route``): the JAX package's
  fused kernel needs a bound, so every level runs its split iteration:
  phase 1 in XLA in bf16 arithmetic (``update_matrices_xla``) and phase 2
  in its Pallas kernel B5 on a float32 copy of M, which returns a float32
  flow.  The port runs both phases of all a level's iterations in one
  kernel, K-umuf-split (``split_iterate`` ->
  ``ops.cuda.umuf_split.umuf_split_iterate``, planned as K-umuf), which
  rounds where that chain rounds; ``split_iterate_plain`` is its plain
  version, the chain itself: ``update_matrices_xla`` then
  ``update_flow_plain``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from flowdenoising_tpu_torch.config import FlowConfig
from flowdenoising_tpu_torch.ops.blur import (
    _sep_correlate, box_blur_sum, corr1d, rounded, smooth_kernel_for_level)
from flowdenoising_tpu_torch.ops.cuda.uf import update_flow
from flowdenoising_tpu_torch.ops.cuda.um import update_matrices
from flowdenoising_tpu_torch.ops.cuda.umuf import umuf_iterate
from flowdenoising_tpu_torch.ops.cuda.umuf_split import umuf_split_iterate
from flowdenoising_tpu_torch.ops.resize import (
    pyramid_sizes, resize_area, resize_linear)
from flowdenoising_tpu_torch.ops.warp import (
    displace_sample_plain, displace_sample_xla)

__all__ = ["EXPANSION_RANGE", "SOLVE_RANGE", "farneback_flow",
           "flow_from_pyramids", "image_pyramid", "poly_exp_constants",
           "poly_expand",
           "polyexp_pyramid", "smoothed_level_image", "split_iterate",
           "split_iterate_plain", "split_route", "tap_solver", "umuf_iterate",
           "umuf_iterate_plain", "update_flow", "update_flow_plain",
           "update_matrices", "update_matrices_plain", "update_matrices_xla"]

# The torch.profiler ranges by which the -v 2 measured report
# (utils.trace_report) finds the kernels of the expansion pyramid and of the
# split route's solves.
EXPANSION_RANGE = "OFE_expansion"
SOLVE_RANGE = "OFE_solve"

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
    Border handling: replicate, both axes.  Computed in img's dtype, the
    inverse-Gram constants rounded to it (as JAX's weak typing rounds
    them).
    """
    g, xg, xxg, *igs = poly_exp_constants(n, float(sigma))
    ig11, ig03, ig33, ig55 = (rounded(c, img.dtype) for c in igs)

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


def _normal_equations(r0: torch.Tensor, s, inb: torch.Tensor,
                      dx: torch.Tensor, dy: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """M = [G11, G12, G22, h1, h2] (..., 5, H, W) from r0's channels, r1's
    sampled channels ``s``, the in-plane mask, the flow and the border
    scale, each operation in its operands' dtype as the JAX package writes
    it (its 0.5 and 0.25 are constants of r0's dtype, exact in any)."""
    a = r0.unbind(-3)
    r4 = torch.where(inb, (a[2] + s[2]) * 0.5, a[2])
    r5 = torch.where(inb, (a[3] + s[3]) * 0.5, a[3])
    r6 = torch.where(inb, (a[4] + s[4]) * 0.25, a[4] * 0.5)
    r2 = (a[0] - torch.where(inb, s[0], 0.0)) * 0.5
    r3 = (a[1] - torch.where(inb, s[1], 0.0)) * 0.5

    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx

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


def _in_plane(fx: torch.Tensor, fy: torch.Tensor, h: int, w: int):
    """Where the displaced pixel's bilinear footprint lies in the plane."""
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    return (x1 >= 0) & (x1 <= w - 2) & (y1 >= 0) & (y1 <= h - 2)


def _border_scale(h: int, w: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(_border_scale_map(h, w), dtype=like.dtype,
                           device=like.device)


def update_matrices_plain(r0: torch.Tensor, r1: torch.Tensor,
                          flow: torch.Tensor,
                          max_displacement: int | None = None,
                          ramp_bf16: bool = False) -> torch.Tensor:
    """Per-pixel normal-equation entries M = [G11, G12, G22, h1, h2]
    (plain version of K-um, phase 1 of K-umuf).

    r0, r1: (..., 5, H, W) expansions of target and reference; flow:
    (..., 2, H, W).  r1 is sampled at the flow clamped to
    +-max_displacement (None: unclamped); the in-plane mask and the flow
    terms use the unclamped flow.  A bfloat16 r1 (the packed forms) is
    sampled in float32.  ``ramp_bf16`` rounds the border ramp to bfloat16.
    Returns (..., 5, H, W).
    """
    h, w = r0.shape[-2], r0.shape[-1]
    dx = flow[..., 0, :, :]
    dy = flow[..., 1, :, :]
    gx = torch.arange(w, dtype=r0.dtype, device=r0.device)
    gy = torch.arange(h, dtype=r0.dtype, device=r0.device).reshape(h, 1)
    inb = _in_plane(gx + dx, gy + dy, h, w)
    s = displace_sample_plain(r1, dx, dy, max_displacement).unbind(-3)
    scale = _border_scale(h, w, r0)
    if ramp_bf16:
        scale = scale.to(torch.bfloat16).to(r0.dtype)
    return _normal_equations(r0, s, inb, dx, dy, scale)


def update_matrices_xla(r0: torch.Tensor, r1: torch.Tensor,
                        flow: torch.Tensor) -> torch.Tensor:
    """Phase 1 with no bound as the JAX package's ``update_matrices(r0, r1,
    flow, None)`` computes it in XLA, op by op in the operands' dtypes: on
    a bfloat16 pyramid the pixel coordinates, the exact gather of r1
    (``displace_sample_xla``) and the border scale are bf16, and each
    operation takes the wider of its operands' dtypes (a float32 flow makes
    the sampled values and M float32, a bfloat16 one leaves them bf16).
    r0, r1: (..., 5, H, W) of one dtype; flow: (..., 2, H, W).  Returns M
    (..., 5, H, W) in the promoted dtype.  Phase 1 of
    ``split_iterate_plain``; K-umuf-split computes it on the card.
    """
    h, w = r0.shape[-2], r0.shape[-1]
    dx = flow[..., 0, :, :]
    dy = flow[..., 1, :, :]
    gx = torch.arange(w, dtype=r0.dtype, device=r0.device)
    gy = torch.arange(h, dtype=r0.dtype, device=r0.device).reshape(h, 1)
    inb = _in_plane(gx + dx, gy + dy, h, w)
    s = displace_sample_xla(r1, dx, dy).unbind(-3)
    return _normal_equations(r0, s, inb, dx, dy, _border_scale(h, w, r0))


def update_flow_plain(m: torch.Tensor, winsize: int) -> torch.Tensor:
    """Box-aggregate M (..., 5, H, W) over winsize (scaled by 1/winsize^2)
    and solve the per-pixel 2x2 system (plain version of K-uf, phase 2 of
    K-umuf).

    Returns flow (..., 2, H, W) with channel 0 = x displacement.
    """
    ms = box_blur_sum(m, winsize) * (1.0 / float(winsize * winsize))
    g11, g12, g22, h1, h2 = ms.unbind(-3)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    u = (g11 * h2 - g12 * h1) * idet
    v = (g22 * h1 - g12 * h2) * idet
    return torch.stack([u, v], dim=-3)


def split_iterate_plain(r0: torch.Tensor, r1: torch.Tensor,
                        flow: torch.Tensor, iters: int,
                        winsize: int) -> torch.Tensor:
    """Plain version of K-umuf-split: ``iters`` Farneback iterations with
    no bound as the JAX package's split iteration runs them on the TPU,
    phase 1 ``update_matrices_xla``, then phase 2 on a float32 copy of M.
    Returns the float32 flow of the last iteration."""
    for _ in range(iters):
        flow = update_flow_plain(update_matrices_xla(r0, r1, flow).float(),
                                 winsize)
    return flow


def split_iterate(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor,
                  iters: int, winsize: int) -> torch.Tensor:
    """The split route's ``iters`` iterations at one level (r0, r1 bf16
    (B, 5, H, W), flow bf16 or float32 (B, 2, H, W)) in the profiler range
    ``SOLVE_RANGE``: K-umuf-split on the card, ``split_iterate_plain`` on
    the CPU (``umuf_split_iterate``).  Returns the float32 flow."""
    with torch.profiler.record_function(SOLVE_RANGE):
        return umuf_split_iterate(r0, r1, flow, iters, winsize)


def umuf_iterate_plain(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor,
                       iters: int, d: int | None, winsize: int,
                       ramp_bf16: bool = False) -> torch.Tensor:
    """Plain version of K-umuf and its packed form (a bfloat16 r1):
    ``iters`` chained Farneback iterations."""
    for _ in range(iters):
        flow = update_flow_plain(
            update_matrices_plain(r0, r1, flow, d, ramp_bf16), winsize)
    return flow


def _level_displacement(cfg: FlowConfig, level: int) -> int | None:
    """Sampling bound at a pyramid level: flows at level k are the full-
    resolution flow scaled by pyr_scale**k, so d_k = max(2, ceil(D *
    pyr_scale**k) + 1)."""
    if cfg.max_displacement is None:
        return None
    d = int(np.ceil(cfg.max_displacement * (cfg.pyr_scale ** level))) + 1
    return max(2, d)


# The JAX package's tiny route (farneback.py: _XLA_LEVEL_AREA,
# _XLA_LEVEL_MAX_D): a level of at most this area whose bound is at most
# this runs the split XLA iteration, not a Pallas kernel.
_TINY_AREA = 2048
_TINY_MAX_D = 4


def _tiny_level(d: int | None, hk: int, wk: int) -> bool:
    """Whether an hk x wk level at bound d takes the JAX package's tiny
    route.  The port runs K-umuf there too (the same function); the route
    decides only where r1 is packed and, in a bf16 pass, the rounding of
    the border ramp (the split iteration holds it in the pass dtype)."""
    return d is not None and d <= _TINY_MAX_D and hk * wk <= _TINY_AREA


def _packed_at_level(cfg: FlowConfig, k: int, hk: int, wk: int) -> bool:
    """Whether level k (hk x wk) samples r1 in bfloat16: with ``precision``
    bfloat16, wherever the JAX package runs its Pallas kernel packed -- a
    finite bound and not the tiny route (so never with no bound, and never
    in the auto-bound probe, which solves unbounded in float32)."""
    d = _level_displacement(cfg, k)
    return (cfg.precision == "bfloat16" and d is not None
            and not _tiny_level(d, hk, wk))


def split_route(cfg: FlowConfig) -> bool:
    """Whether the solves of a pass under ``cfg`` run the JAX package's
    split iteration (``split_iterate``) at every level: a bfloat16 pass
    with no bound, where the JAX package's fused kernels, which need a
    bound, do not run and its phase 1 runs in bf16 arithmetic.  (A float32
    pass with no bound runs the same function as its split iteration in
    K-umuf with the clamp off.)"""
    return cfg.dtype == "bfloat16" and cfg.max_displacement is None


def _level_operands(cfg: FlowConfig, k: int, r0: torch.Tensor,
                    r1: torch.Tensor):
    """K-umuf's operands at level k from pyramid levels of either dtype:
    (r0 in float32, r1 in bfloat16 where packed else float32, whether the
    border ramp is rounded to bfloat16).  A float32 operand of a float32
    level is the level itself, not a copy.  On the split route the levels
    themselves, in the pyramid's dtype."""
    if split_route(cfg):
        return r0, r1, False
    hk, wk = r0.shape[-2], r0.shape[-1]
    d = _level_displacement(cfg, k)
    packed = _packed_at_level(cfg, k, hk, wk)
    ramp_bf16 = r0.dtype == torch.bfloat16 and _tiny_level(d, hk, wk)
    return (r0.float(), r1.to(torch.bfloat16) if packed else r1.float(),
            ramp_bf16)


def _solve_levels(levels, cfg: FlowConfig, initial_flow: torch.Tensor | None,
                  round_level_flow: bool) -> torch.Tensor:
    """Coarse to fine over ``levels`` [(r0, r1, ramp_bf16) of
    ``_level_operands``]; the flow is float32 between levels.  With
    ``round_level_flow`` each Pallas level's input flow is rounded to
    bfloat16 (the JAX package's ``flow.astype(r0.dtype)`` in
    ``_iterate_level`` on a bf16 pyramid).

    The coarsest level starts from the seed resized in float32, or from a
    float32 zero flow; on the split route, as in the JAX package, from the
    seed resized in its own dtype (a bf16 pass carries its tap flows in
    bf16), or from zeros in the pyramid's dtype, so that level's first
    phase 1 runs wholly in bf16."""
    split = split_route(cfg)
    flow = None
    for k in range(len(levels) - 1, -1, -1):
        r0, r1, ramp_bf16 = levels[k]
        hk, wk = r0.shape[-2], r0.shape[-1]
        d = _level_displacement(cfg, k)
        if flow is None:
            if cfg.use_initial_flow and initial_flow is not None:
                seed = initial_flow if split else initial_flow.float()
                flow = resize_area(seed, (hk, wk)) * (cfg.pyr_scale ** k)
            else:
                flow = torch.zeros(r0.shape[:-3] + (2, hk, wk),
                                   dtype=r0.dtype if split else torch.float32,
                                   device=r0.device)
        else:
            flow = resize_linear(flow, (hk, wk)) * (1.0 / cfg.pyr_scale)
        if split:
            flow = split_iterate(r0, r1, flow.contiguous(), cfg.iterations,
                                 cfg.winsize)
            continue
        if round_level_flow and not _tiny_level(d, hk, wk):
            flow = flow.to(torch.bfloat16).float()
        flow = umuf_iterate(r0, r1, flow.contiguous(), cfg.iterations, d,
                            cfg.winsize, ramp_bf16=ramp_bf16)
    return flow


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
    """Per-level expansions (..., 5, h_k, w_k) of (..., H, W) images, in
    the profiler range ``EXPANSION_RANGE``."""
    with torch.profiler.record_function(EXPANSION_RANGE):
        return [poly_expand(i, cfg.poly_n, cfg.poly_sigma).contiguous()
                for i in image_pyramid(img, cfg)]


def flow_from_pyramids(r0_levels: list[torch.Tensor],
                       r1_levels: list[torch.Tensor], cfg: FlowConfig,
                       initial_flow: torch.Tensor | None = None) -> torch.Tensor:
    """Coarse-to-fine flow from precomputed expansion pyramids (counterpart
    of the JAX package's ``flow_from_pyramids``).

    r*_levels[k]: (B, 5, h_k, w_k), float32 or bfloat16; initial_flow:
    (B, 2, H, W) full resolution, INTER_AREA-resized to the coarsest level
    and scaled by pyr_scale**k.  On a bfloat16 pyramid each Pallas level's
    input flow is rounded to bfloat16, as the JAX package's does.  With a
    bound the coarsest level starts from a float32 zero flow (the JAX
    package's is in the pyramid dtype, which runs a bf16 pyramid's tiny
    coarsest level in bf16 arithmetic; the port runs every tiny level as
    the prepped solver does, in float32); on the split route from zeros in
    the pyramid dtype, as the JAX package's.  Returns (B, 2, H, W) float32.
    """
    levels = [_level_operands(cfg, k, r0, r1)
              for k, (r0, r1) in enumerate(zip(r0_levels, r1_levels))]
    return _solve_levels(levels, cfg, initial_flow,
                         round_level_flow=r0_levels[0].dtype == torch.bfloat16)


def tap_solver(padded: torch.Tensor, interior_start: int, n: int,
               cfg: FlowConfig):
    """Per-pass tap-pair solver (counterpart of ``prepped_tap_solver``).

    Builds the expansion pyramid of the whole padded stack (N + 2*ks2, H, W)
    once, in padded's dtype, and its kernel operands once per level: r0 the
    targets ``padded[interior_start:interior_start+n]`` in float32, r1 the
    whole stack in bfloat16 on the packed levels, else in float32 (a view
    of a float32 pyramid).  The returned ``solve(start, init_flow)`` solves
    the flows from the targets to the references ``padded[start:start+n]``,
    a view into r1, so no tap copies an operand.  As the prepped solver,
    it keeps the flow in float32 between levels.  On the split route (a
    bf16 pass with no bound) the operands are the bf16 pyramid itself, and
    a bf16 ``init_flow`` is resized in bf16, as the JAX package's
    ``flow_from_pyramids`` does.  Returns (n, 2, H, W) float32.
    """
    levels = [_level_operands(cfg, k, r[interior_start:interior_start + n], r)
              for k, r in enumerate(polyexp_pyramid(padded, cfg))]

    def solve(start: int, init_flow: torch.Tensor | None = None):
        return _solve_levels([(r0, r1[start:start + n], ramp)
                              for r0, r1, ramp in levels],
                             cfg, init_flow, round_level_flow=False)

    return solve


def farneback_flow(reference: torch.Tensor, target: torch.Tensor,
                   cfg: FlowConfig = FlowConfig(),
                   initial_flow: torch.Tensor | None = None) -> torch.Tensor:
    """Dense optical flow from ``target`` to ``reference`` (cv2 order of the
    reference wrapper: prev=target, next=reference).

    reference, target: (..., H, W) images, taken to ``cfg.dtype``.
    initial_flow and the result: (..., H, W, 2) float32, channel 0 = x
    displacement, such that ``warp_slices(reference, flow) ~ target``.
    """
    lead = target.shape[:-2]
    h, w = target.shape[-2], target.shape[-1]
    dtype = getattr(torch, cfg.dtype)
    t = target.reshape(-1, h, w).to(dtype)
    r = reference.reshape(-1, h, w).to(dtype)
    f0 = None
    if initial_flow is not None:
        f0 = initial_flow.reshape(-1, h, w, 2).permute(0, 3, 1, 2)
    flow = flow_from_pyramids(polyexp_pyramid(t, cfg), polyexp_pyramid(r, cfg),
                              cfg, f0)
    return flow.permute(0, 2, 3, 1).reshape(lead + (h, w, 2))

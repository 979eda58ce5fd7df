"""Automatic ``max_displacement`` selection from the volume's real motion.

Counterpart of ``flowdenoising_tpu/core/autodisp.py``, with the same
ladders, tolerances and picks.  The sampling kernels clamp per-tap
displacements to ``FlowConfig.max_displacement`` (D); ``--max_displacement
auto`` picks the bound by measuring what clamping costs, not by raw flow
magnitude (flow between distant cross-sections reports large displacements
where structure appears or deforms, and clamping those is harmless).  The
probe

- takes ``_N_PAIRS`` evenly spaced slice pairs per pass axis at the largest
  tap distance the filter uses (ks2 = kernel_len // 2, which bounds every
  tap) and at distance 1 (which bounds the compose mode's
  ``adjacent_displacement``),
- resizes the planes on the host (INTER_AREA) to a fixed aspect-bucket
  shape (square, 1:4 or 4:1 at ``probe_extent`` area; per-axis scale
  factors map ladder bounds in full-resolution pixels onto probe-pixel
  flow components),
- solves unbounded Farneback at probe scale (K-umuf with the clamp off),
  groups that share a bucket shape in one batched call, and
- picks the smallest ladder D whose component-clamped flow keeps the warp
  error (K-sample) within ``_BENEFIT_TOL`` of the unbounded flow's tracking
  benefit (identity-warp error minus unbounded-warp error).

The JAX package moves its probe to the host CPU, only to spare a remote
TPU a compile of a throwaway program, and ships compiled probe programs to
hide XLA compile time.  The port compiles nothing per shape, so the probe
runs where the denoise runs: on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch

from flowdenoising_tpu_torch.config import FilterConfig, FlowConfig
from flowdenoising_tpu_torch.kernels import get_gaussian_kernels
from flowdenoising_tpu_torch.ops.farneback import farneback_flow
from flowdenoising_tpu_torch.ops.resize import area_resize_matrix
from flowdenoising_tpu_torch.ops.warp import warp_slices

# Displacement ladders: small enough steps that the chosen bound stays
# close to the need.
_D_LADDER = (4, 6, 8, 12, 16, 24, 32, 48)
_ADJ_LADDER = (2, 3, 4, 6, 8, 12, 16, 24)
# Accepted clamp cost as a fraction of the flow's TRACKING BENEFIT
# (identity-warp error minus unbounded-warp error).  The base error is
# dominated by the noise and resampling floor, so a base-relative
# tolerance hides localized clamping loss; the benefit does not.
_BENEFIT_TOL = 0.02
_N_PAIRS = 4   # probed slice pairs per axis per distance
# The probe's flow is "tracking" only when its warp error clearly beats the
# identity warp; above this fraction the clamp-cost curve is uninformative.
_UNTRACKED_FRAC = 0.9


def _probe_pairs(vol: np.ndarray, distance: int, n_pairs: int):
    """(targets, references) stacks of EXACTLY ``n_pairs`` plane pairs at
    the given slice distance along axis 0, evenly spaced (duplicates kept on
    tiny axes so every probe group has the same leading dim)."""
    n = vol.shape[0]
    distance = min(distance, n - 1)
    starts = np.linspace(0, n - 1 - distance, n_pairs).astype(int)
    tgt = np.stack([np.asarray(vol[z], dtype=np.float32) for z in starts])
    ref = np.stack([np.asarray(vol[z + distance], dtype=np.float32)
                    for z in starts])
    return tgt, ref


def _probe_cfg(flow_cfg: FlowConfig) -> FlowConfig:
    """The probe's solver: unbounded, float32, no seed flow."""
    return dataclasses.replace(
        flow_cfg, max_displacement=None, precision="float32",
        dtype="float32", tap_mode="solve", use_initial_flow=False)


def _bucket_shape(h: int, w: int, e: int) -> tuple[int, int]:
    """Fixed probe shape for a plane geometry.

    Planes that fit the ``e x e`` square keep the square (the geometry the
    benefit tolerance was calibrated on).  Planes that need downscaling
    pick the closest-aspect of three equal-area buckets (square, 1:4 wide,
    4:1 tall), which bounds the anisotropic squash to 2x."""
    if h <= e and w <= e:
        return (e, e)
    cands = ((e, e), (e // 2, 2 * e), (2 * e, e // 2))
    want = math.log(h / w)
    return min(cands, key=lambda s: abs(want - math.log(s[0] / s[1])))


def _resize_group(tgt: np.ndarray, ref: np.ndarray, probe_extent: int):
    """Resize one probe group's plane stacks to its bucket shape on the
    host (two small products with the OpenCV-convention area weights).
    Returns (t, r, su, sv) with the per-axis full-res-px / probe-px scale
    factors.  Small axes are upscaled (area weights degenerate to
    bilinear)."""
    h, w = tgt.shape[-2:]
    eh, ew = _bucket_shape(h, w, probe_extent)
    wr = area_resize_matrix(h, eh)
    wc = area_resize_matrix(w, ew)

    def rs(x):
        return np.einsum("eh,nhw,fw->nef", wr,
                         np.asarray(x, np.float64), wc,
                         optimize=True).astype(np.float32)

    return rs(tgt), rs(ref), w / ew, h / eh


def _probe_errors(t: torch.Tensor, r: torch.Tensor, bounds: torch.Tensor,
                  n_pairs: int, pcfg: FlowConfig):
    """The whole probe of one batch of groups: the unbounded Farneback
    solve over all plane pairs, then per group the mean-abs warp error at
    every ladder bound, the unbounded flow's error and the identity warp's.

    t, r: (n_groups * n_pairs, h, w) float32; bounds: (n_groups, n_ladder,
    2) clamp bounds in probe pixels.  Returns (errs (n_groups, n_ladder),
    base (n_groups,), ident (n_groups,)).
    """
    n_groups = bounds.shape[0]

    def group_mean(x):
        return x.abs().reshape(n_groups, -1).mean(dim=1)

    flow = farneback_flow(r, t, pcfg)            # (N, h, w, 2)
    errs = []
    for bl in bounds.unbind(1):                  # (n_groups, 2) per ladder D
        b = bl.repeat_interleave(n_pairs, dim=0)[:, None, None, :]
        errs.append(group_mean(
            warp_slices(r, torch.minimum(torch.maximum(flow, -b), b)) - t))
    base = group_mean(warp_slices(r, flow) - t)
    ident = group_mean(r - t)
    return torch.stack(errs, dim=1), base, ident


def _run_probe(groups_resized, ladders, flow_cfg: FlowConfig, device):
    """Run the probe over the resized groups on ``device``.

    groups_resized: list of (t, r, su, sv); ladders: per-group D tuples
    (full-res pixels).  Groups sharing a bucket shape run as ONE batched
    call; results come back in input order.  Returns per-group (curve,
    base, ident) floats."""
    n_pairs = groups_resized[0][0].shape[0]
    pcfg = _probe_cfg(flow_cfg)
    out = [None] * len(groups_resized)
    by_shape: dict = {}
    for i, (t, _, _, _) in enumerate(groups_resized):
        by_shape.setdefault(tuple(t.shape[-2:]), []).append(i)
    for idxs in by_shape.values():
        t_all = np.concatenate([groups_resized[i][0] for i in idxs])
        r_all = np.concatenate([groups_resized[i][1] for i in idxs])
        # D is in full-res pixels; flow components are in probe-res pixels.
        bounds = np.asarray(
            [[[d / groups_resized[i][2], d / groups_resized[i][3]]
              for d in ladders[i]] for i in idxs], np.float32)
        errs, base, ident = (x.cpu().numpy() for x in _probe_errors(
            torch.from_numpy(t_all).to(device),
            torch.from_numpy(r_all).to(device),
            torch.from_numpy(bounds).to(device), n_pairs, pcfg))
        for j, i in enumerate(idxs):
            out[i] = (errs[j].tolist(), float(base[j]), float(ident[j]))
    return out


def _pick_bound(costs_by_axis, stats_by_axis, ladder, label) -> int:
    """Smallest ladder D acceptable on EVERY probed axis: clamp cost
    (curve - base) within ``_BENEFIT_TOL`` of that axis's tracking benefit
    (ident - base).  Axes whose flow does not beat the identity warp have
    ~zero benefit; they accept any D whose clamp does not add error (and
    are floored separately via the untrackable list)."""
    for i, d in enumerate(ladder):
        if all(c[i] - b <= _BENEFIT_TOL * max(ident - b, 0.0) + 1e-6
               for c, (b, ident) in zip(costs_by_axis, stats_by_axis)):
            return d
    logging.warning(
        f"auto {label}: even D={ladder[-1]} clamps motion the flow tracks "
        f"(the sampling kernels bound displacements; residual clamping "
        f"matches the fixed-D behavior)")
    return ladder[-1]


def probe_displacement(vol: np.ndarray, cfg: FilterConfig,
                       probe_extent: int = 128,
                       device=None) -> tuple[int, int]:
    """Measure the volume's motion scale and return
    ``(max_displacement, adjacent_displacement)`` from the ladders.

    ``vol`` may be any array-like with numpy slicing; only ~``3 axes * 2 *
    _N_PAIRS`` planes are read.  The solves and warps run on ``device``
    (default CUDA; the plain versions for ``"cpu"``).  A group whose flow
    barely beats the identity warp is probed again at 2x extent, and if it
    still does, its pick is floored at the fixed defaults.
    """
    device = torch.device("cuda" if device is None else device)
    kernels = get_gaussian_kernels(cfg.sigma)
    far_costs, far_stats, adj_costs, adj_stats = [], [], [], []
    untrackable = []

    # Collect every probe group first (host-side slicing only).
    groups = []  # (label, ladder, tgt_planes, ref_planes)
    for axis in range(3):
        ks2 = len(kernels[axis]) // 2
        if ks2 == 0 or vol.shape[axis] < 2:
            continue
        v = np.moveaxis(np.asarray(vol), axis, 0) if axis else vol
        dist_far = min(ks2, vol.shape[axis] - 1)
        tgt, ref = _probe_pairs(v, dist_far, _N_PAIRS)
        groups.append((f"axis{axis}/far", _D_LADDER, tgt, ref))
        if dist_far > 1:
            tgt, ref = _probe_pairs(v, 1, _N_PAIRS)
        groups.append((f"axis{axis}/adj", _ADJ_LADDER, tgt, ref))

    if groups:
        resized = [_resize_group(tgt, ref, probe_extent)
                   for _, _, tgt, ref in groups]
        results = _run_probe(resized, [lad for _, lad, _, _ in groups],
                             cfg.flow, device)
        for (label, ladder, tgt, ref), (curve, base, ident) in zip(groups,
                                                                   results):
            if base > _UNTRACKED_FRAC * ident:
                # The downsampled probe's pyramid is clamped to ~2 levels,
                # so motion it cannot track leaves the unbounded warp error
                # ~at the identity-warp error: re-probe at 2x extent, and
                # flag the axis if the flow still barely beats the identity.
                (curve, base, ident), = _run_probe(
                    [_resize_group(tgt, ref, 2 * probe_extent)], [ladder],
                    cfg.flow, device)
                if base > _UNTRACKED_FRAC * ident:
                    untrackable.append(label)
            if label.endswith("/far"):
                far_costs.append(curve)
                far_stats.append((base, ident))
            else:
                adj_costs.append(curve)
                adj_stats.append((base, ident))

    if not far_costs:
        return (cfg.flow.max_displacement or _D_LADDER[1],
                cfg.flow.adjacent_displacement or _ADJ_LADDER[2])
    max_d = _pick_bound(far_costs, far_stats, _D_LADDER, "max_displacement")
    adj_d = min(max_d, _pick_bound(adj_costs, adj_stats, _ADJ_LADDER,
                                   "adjacent_displacement"))
    if untrackable:
        # Never pick a bound tighter than the fixed defaults from an
        # uninformative curve.  Far and adjacent curves floor independently.
        far_unt = [u for u in untrackable if u.endswith("/far")]
        adj_unt = [u for u in untrackable if u.endswith("/adj")]
        floor_d = cfg.flow.max_displacement or 8
        floor_adj = cfg.flow.adjacent_displacement or _ADJ_LADDER[2]
        if far_unt and max_d < floor_d:
            logging.warning(
                f"auto max_displacement: probe flow barely beats the "
                f"identity warp on {far_unt} (motion the probe scale "
                f"cannot track?); flooring pick {max_d} at the fixed "
                f"default {floor_d}")
            max_d = floor_d
        if adj_unt and adj_d < min(max_d, floor_adj):
            logging.warning(
                f"auto adjacent_displacement: uninformative adjacent probe "
                f"on {adj_unt}; flooring pick {adj_d} at the fixed "
                f"default {min(max_d, floor_adj)}")
            adj_d = min(max_d, floor_adj)
    logging.info(f"auto max_displacement: probed clamp-cost curves -> "
                 f"max_displacement={max_d}, adjacent_displacement={adj_d}")
    return max_d, adj_d


def resolve_auto_displacement(vol: np.ndarray, cfg: FilterConfig,
                              device=None) -> FilterConfig:
    """Return ``cfg`` with probed displacement bounds filled in."""
    max_d, adj_d = probe_displacement(vol, cfg, device=device)
    return dataclasses.replace(
        cfg, flow=dataclasses.replace(cfg.flow, max_displacement=max_d,
                                      adjacent_displacement=adj_d))

"""Plain copy of the CLI's ``--max_displacement auto`` probe.

A frozen copy of the probe's arithmetic (``core/autodisp.py`` of the
port), kept apart from the program so that a change to the program cannot
change the bound its output is judged at.  For each pass axis it takes
``N_PAIRS`` evenly spaced plane pairs at the far tap distance ks2 and at
distance 1, resizes each group on the host to a bucket shape of
``EXTENT``-pixel area with area weights in float64, solves the unbounded
Farneback flow of every group that shares a shape in one batch
(``plain.solve``, no bound, no seed flow), and reads the mean |warp - target|
at each ladder bound after a per-component clamp, beside the unbounded
flow's error and the identity warp's.  The bound is the smallest ladder D
whose clamp costs at most ``BENEFIT_TOL`` of the tracking benefit on every
axis; a group whose flow barely beats the identity warp is probed again at
twice the extent, and one that still does floors the pick at 8 (far) and 4
(adjacent).

The probe runs in IEEE float32 whatever the caller's setting, so that a
lower-precision control of the denoise is judged at the bound this probe
picks.
"""

from __future__ import annotations

import numpy as np
import torch

from . import plain

D_LADDER = (4, 6, 8, 12, 16, 24, 32, 48)
ADJ_LADDER = (2, 3, 4, 6, 8, 12, 16, 24)
BENEFIT_TOL = 0.02
N_PAIRS = 4
UNTRACKED_FRAC = 0.9
EXTENT = 128
# the picks' floors where a probed group stays untracked: the CLI's fixed
# max_displacement and FlowConfig's adjacent_displacement
FLOOR_D = 8
FLOOR_ADJ = 4


def pairs(vol: np.ndarray, distance: int, n_pairs: int = N_PAIRS):
    """(targets, references): ``n_pairs`` plane pairs ``distance`` apart
    along axis 0, evenly spaced, float32 (repeats kept on short axes)."""
    n = vol.shape[0]
    distance = min(distance, n - 1)
    starts = np.linspace(0, n - 1 - distance, n_pairs).astype(int)
    tgt = np.stack([np.asarray(vol[z], dtype=np.float32) for z in starts])
    ref = np.stack([np.asarray(vol[z + distance], dtype=np.float32)
                    for z in starts])
    return tgt, ref


def bucket(h: int, w: int, e: int) -> tuple[int, int]:
    """The probe shape of an h x w plane: e x e where it fits, else the
    nearest in aspect of e x e, e/2 x 2e and 2e x e/2."""
    if h <= e and w <= e:
        return (e, e)
    cands = ((e, e), (e // 2, 2 * e), (2 * e, e // 2))
    want = np.log(h / w)
    return min(cands, key=lambda s: abs(want - np.log(s[0] / s[1])))


def resize_group(tgt: np.ndarray, ref: np.ndarray, extent: int):
    """The group's stacks at its bucket shape, area weights in float64 on
    the host, and the full-resolution pixels a probe pixel spans along x
    and y: (t, r, su, sv)."""
    h, w = tgt.shape[-2:]
    eh, ew = bucket(h, w, extent)
    wr = plain.area_matrix(h, eh)
    wc = plain.area_matrix(w, ew)

    def rs(x):
        return np.einsum("eh,nhw,fw->nef", wr, np.asarray(x, np.float64), wc,
                         optimize=True).astype(np.float32)

    return rs(tgt), rs(ref), w / ew, h / eh


def errors(t: torch.Tensor, r: torch.Tensor, bounds: torch.Tensor,
           n_pairs: int, flow: dict):
    """Per group of ``n_pairs`` planes: the mean |warp - target| at each
    ladder bound (per-component clamp), the unbounded flow's, the identity
    warp's.  bounds: (groups, ladder, 2) in probe pixels, x then y."""
    n_groups = bounds.shape[0]
    rs = plain.Resizer(tf32=False)
    pyr = [plain.expansion_pyramid(x, flow, rs) for x in (t, r)]
    f = plain.solve(pyr[0], pyr[1], flow, None, rs, None, len(t))
    u, v = f[:, 0], f[:, 1]

    def mean_abs(x):
        return x.abs().reshape(n_groups, -1).mean(dim=1)

    errs = []
    for b in bounds.unbind(1):
        b = b.repeat_interleave(n_pairs, dim=0)[:, None, None, :]
        uc = torch.minimum(torch.maximum(u, -b[..., 0]), b[..., 0])
        vc = torch.minimum(torch.maximum(v, -b[..., 1]), b[..., 1])
        errs.append(mean_abs(plain.displace(r, uc, vc, None) - t))
    base = mean_abs(plain.displace(r, u, v, None) - t)
    ident = mean_abs(r - t)
    return torch.stack(errs, dim=1), base, ident


def run_probe(groups, ladders, flow: dict, device):
    """(curve, base, ident) of each resized group (t, r, su, sv), the
    groups of one shape solved in one batch."""
    n_pairs = groups[0][0].shape[0]
    out = [None] * len(groups)
    by_shape: dict = {}
    for i, (t, _, _, _) in enumerate(groups):
        by_shape.setdefault(tuple(t.shape[-2:]), []).append(i)
    for idxs in by_shape.values():
        t_all = np.concatenate([groups[i][0] for i in idxs])
        r_all = np.concatenate([groups[i][1] for i in idxs])
        bounds = np.asarray([[[d / groups[i][2], d / groups[i][3]]
                              for d in ladders[i]] for i in idxs], np.float32)
        errs, base, ident = (x.cpu().numpy() for x in errors(
            torch.from_numpy(t_all).to(device),
            torch.from_numpy(r_all).to(device),
            torch.from_numpy(bounds).to(device), n_pairs, flow))
        for j, i in enumerate(idxs):
            out[i] = (errs[j].tolist(), float(base[j]), float(ident[j]))
    return out


def pick(curves, stats, ladder) -> int:
    """The smallest ladder D whose clamp cost (curve - base) is within
    ``BENEFIT_TOL`` of the tracking benefit (ident - base) on every
    curve; the ladder's last where none is."""
    for i, d in enumerate(ladder):
        if all(c[i] - b <= BENEFIT_TOL * max(ident - b, 0.0) + 1e-6
               for c, (b, ident) in zip(curves, stats)):
            return d
    return ladder[-1]


def probe(vol: np.ndarray, sigma, flow: dict, device="cpu",
          extent: int = EXTENT) -> tuple[int, int]:
    """(max_displacement, adjacent_displacement) that the probe picks for
    the (Z, Y, X) volume ``vol`` under the Gaussian ``sigma`` a pass and
    the flow settings ``flow``."""
    groups = []   # (far, ladder, targets, references)
    for axis in range(3):
        ks2 = len(plain.gaussian_taps(sigma[axis])) // 2
        if ks2 == 0 or vol.shape[axis] < 2:
            continue
        v = np.moveaxis(np.asarray(vol), axis, 0) if axis else vol
        far = min(ks2, vol.shape[axis] - 1)
        tgt, ref = pairs(v, far)
        groups.append((True, D_LADDER, tgt, ref))
        if far > 1:
            tgt, ref = pairs(v, 1)
        groups.append((False, ADJ_LADDER, tgt, ref))
    if not groups:
        return FLOOR_D, FLOOR_ADJ

    curves = {True: [], False: []}
    stats = {True: [], False: []}
    untracked = {True: False, False: False}
    results = run_probe([resize_group(t, r, extent) for _, _, t, r in groups],
                        [ladder for _, ladder, _, _ in groups], flow, device)
    for (far, ladder, t, r), (curve, base, ident) in zip(groups, results):
        if base > UNTRACKED_FRAC * ident:
            (curve, base, ident), = run_probe(
                [resize_group(t, r, 2 * extent)], [ladder], flow, device)
            if base > UNTRACKED_FRAC * ident:
                untracked[far] = True
        curves[far].append(curve)
        stats[far].append((base, ident))

    max_d = pick(curves[True], stats[True], D_LADDER)
    adj_d = min(max_d, pick(curves[False], stats[False], ADJ_LADDER))
    if untracked[True] and max_d < FLOOR_D:
        max_d = FLOOR_D
    if untracked[False] and adj_d < min(max_d, FLOOR_ADJ):
        adj_d = min(max_d, FLOOR_ADJ)
    return max_d, adj_d

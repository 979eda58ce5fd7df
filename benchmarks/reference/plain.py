"""Plain float32 reference of the benchmark's flow denoise.

A frozen copy of the plain PyTorch arithmetic of the float32 path that the
benchmark's cells run (three Z, Y, X passes; the solve and the compose tap
modes; a displacement bound; the WRAP boundary), kept apart from the
program so that a change to the program cannot change what it is judged
against.  It imports nothing of the program and of the JAX package, and
works out everything itself from the volume and the configuration: the
Gaussian taps from sigma, the expansion pyramids, every flow, every warp.

Matrix products run in IEEE float32 unless ``tf32`` is set: that is the
lower-precision control (TF32 products, as a CUDA card gives them with
TF32 allowed; on the CPU, which has no TF32, the operands are rounded to
TF32's 10-bit mantissa before an IEEE product).

Each pass runs over windows of output planes, each window built from the
unpadded pass volume with its 2 ks2 halo planes taken modulo N and its own
expansion pyramid, within ``WINDOW_PIXELS`` pixels a window; the tap
solves run over blocks of at most ``BLOCK`` planes, within ``PIXELS``
pixels a block.  So a full-frame volume fits one card beside its pass
input and output (1065 x 1536 x 2048 peaked at 58.7 GB on an H100 80GB
HBM3), and the results are those of whole passes: a plane's pyramid,
flows and warps depend only on the planes it is paired with, never on the
planes computed beside it.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

# OpenCV getGaussianKernel's fixed taps for sigma <= 0 and ksize <= 7.
_SMALL_GAUSSIAN = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}
# OpenCV Farneback's border down-weighting ramp (FarnebackUpdateMatrices).
_BORDER_RAMP = (0.14, 0.14, 0.4472, 0.4472, 0.4472)
# Planes a tap solve holds at once, at most.
BLOCK = 128
# Pixels of the planes a tap solve holds at once: BLOCK planes of 768 x 1024.
PIXELS = 96 << 20
# Pixels of a pass window's planes, its halo included: every pass of the
# benchmark's cells in one window (181 planes of 768 x 1024 the largest).
WINDOW_PIXELS = 136 << 20


def gaussian_taps(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """The reference CLI's 1-D taps: scipy's sampled and normalised
    Gaussian, radius int(truncate * sigma + 0.5), in float64."""
    sigma = float(sigma)
    r = int(truncate * sigma + 0.5)
    x = np.arange(-r, r + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x * x) / (sigma * sigma))
    return phi / phi.sum()


def cv_gaussian_taps(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma) in float64."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return np.array(_SMALL_GAUSSIAN[ksize], dtype=np.float64)
    s = sigma if sigma > 0 else 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * s * s))
    return k / k.sum()


def level_smoothing_taps(level: int, pyr_scale: float) -> np.ndarray:
    """OpenCV Farneback's pre-pyramid blur at a level: sigma (1/scale - 1)
    / 2, ksize cvRound(5 sigma) | 1, at least 3."""
    sigma = (1.0 / pyr_scale ** level - 1.0) * 0.5
    return cv_gaussian_taps(max(int(np.rint(sigma * 5)) | 1, 3), sigma)


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(torch.tensor(float(x), dtype=torch.float64).to(torch.float32))


def corr1d(img: torch.Tensor, taps, axis: int, pad_mode: str) -> torch.Tensor:
    """1-D correlation along ``axis`` as a shift-and-add over a padded copy
    (numpy's ``pad_mode``: "edge" is BORDER_REPLICATE, "reflect"
    BORDER_REFLECT_101)."""
    taps = np.asarray(taps, dtype=np.float64)
    r = len(taps) // 2
    axis = axis % img.ndim
    n = img.shape[axis]
    idx = np.pad(np.arange(n), (r, r), mode=pad_mode)
    p = img.index_select(axis, torch.as_tensor(idx, device=img.device))
    out = None
    for k in range(len(taps)):
        term = p.narrow(axis, k, n) * f32(taps[k])
        out = term if out is None else out.add_(term)
    return out


def sep_correlate(img: torch.Tensor, taps, pad_mode: str) -> torch.Tensor:
    return corr1d(corr1d(img, taps, -2, pad_mode), taps, -1, pad_mode)


# ---- resizes: out = W_rows @ img @ W_cols^T, a product per plane


@functools.lru_cache(maxsize=None)
def linear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) INTER_LINEAR weights, border replicate."""
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float64)
    w = np.zeros((n_out, n_in), dtype=np.float64)
    scale = n_in / n_out
    for d in range(n_out):
        s = (d + 0.5) * scale - 0.5
        i0 = int(np.floor(s))
        f = s - i0
        w[d, np.clip(i0, 0, n_in - 1)] += 1.0 - f
        w[d, np.clip(i0 + 1, 0, n_in - 1)] += f
    return w


@functools.lru_cache(maxsize=None)
def area_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) INTER_AREA weights (bilinear when upscaling)."""
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float64)
    if n_out > n_in:
        return linear_matrix(n_in, n_out)
    w = np.zeros((n_out, n_in), dtype=np.float64)
    scale = n_in / n_out
    for d in range(n_out):
        lo, hi = d * scale, (d + 1) * scale
        for i in range(int(np.floor(lo)), min(int(np.ceil(hi)), n_in)):
            overlap = min(hi, i + 1) - max(lo, i)
            if overlap > 0:
                w[d, i] = overlap
        w[d] /= w[d].sum()
    return w


_MATMULS = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)


@contextlib.contextmanager
def _products(tf32: bool, device: torch.device):
    """IEEE float32 matrix products inside (TF32 on a CUDA card with
    ``tf32``), the caller's settings after."""
    saved = [b.fp32_precision for b in _MATMULS]
    try:
        for b in _MATMULS:
            b.fp32_precision = "ieee"
        if tf32 and device.type == "cuda":
            torch.backends.cuda.matmul.fp32_precision = "tf32"
        yield
    finally:
        for b, p in zip(_MATMULS, saved):
            b.fp32_precision = p


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa (to nearest, ties
    away from zero)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Resizer:
    """The pyramid's resizes, in IEEE float32 or (``tf32``) TF32 products."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def _separable(self, img: torch.Tensor, wr, wc) -> torch.Tensor:
        lead = tuple(img.shape[:-2])
        x = img.reshape((-1,) + tuple(img.shape[-2:])).float()
        b = x.shape[0]
        wr_t = torch.as_tensor(wr, dtype=torch.float32, device=img.device)
        wc_t = torch.as_tensor(wc, dtype=torch.float32, device=img.device)
        emulate = self.tf32 and img.device.type != "cuda"
        r = to_tf32 if emulate else (lambda t: t)
        with _products(self.tf32, img.device):
            out = torch.bmm(r(wr_t).expand(b, -1, -1), r(x))
            out = torch.bmm(r(out), r(wc_t).t().expand(b, -1, -1))
        return out.reshape(lead + tuple(out.shape[-2:]))

    def linear(self, img: torch.Tensor, hw) -> torch.Tensor:
        if tuple(img.shape[-2:]) == tuple(hw):
            return img
        return self._separable(img, linear_matrix(img.shape[-2], hw[0]),
                               linear_matrix(img.shape[-1], hw[1]))

    def area(self, img: torch.Tensor, hw) -> torch.Tensor:
        if tuple(img.shape[-2:]) == tuple(hw):
            return img
        return self._separable(img, area_matrix(img.shape[-2], hw[0]),
                               area_matrix(img.shape[-1], hw[1]))


def clamped_levels(flow: dict, h: int, w: int) -> int:
    """Pyramid levels used for an h x w plane (OpenCV stops before a level
    narrower than min_size)."""
    k, scale = 0, 1.0
    while k < flow["levels"]:
        scale *= flow["pyr_scale"]
        if w * scale < flow["min_size"] or h * scale < flow["min_size"]:
            break
        k += 1
    return k


def pyramid_sizes(h: int, w: int, levels: int, pyr_scale: float):
    return [(int(np.rint(h * pyr_scale ** k)), int(np.rint(w * pyr_scale ** k)))
            for k in range(levels + 1)]


# ---- polynomial expansion and the Farneback iteration


@functools.lru_cache(maxsize=None)
def poly_exp_constants(n: int, sigma: float):
    """Applicability taps g, x g, x^2 g over [-n, n] and the inverse-Gram
    coefficients (ig11, ig03, ig33, ig55)."""
    if sigma < 1e-7:
        sigma = n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    G = np.zeros((6, 6), dtype=np.float64)
    s2 = float((g * x * x).sum())
    s4 = float((g * x ** 4).sum())
    G[0, 0] = 1.0
    G[1, 1] = G[2, 2] = s2
    G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = s2
    G[3, 3] = G[4, 4] = s4
    G[5, 5] = G[3, 4] = G[4, 3] = s2 * s2
    ig = np.linalg.inv(G)
    return g, x * g, x * x * g, (ig[1, 1], ig[0, 3], ig[3, 3], ig[5, 5])


def poly_expand(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """(B, H, W) -> (B, 5, H, W): [b_y, b_x, a_yy, a_xx, a_xy] in OpenCV's
    scaling, replicate borders."""
    g, xg, xxg, igs = poly_exp_constants(n, float(sigma))
    ig11, ig03, ig33, ig55 = (f32(c) for c in igs)
    row0 = corr1d(img, g, -2, "edge")
    row1 = corr1d(img, xg, -2, "edge")
    row2 = corr1d(img, xxg, -2, "edge")
    b1 = corr1d(row0, g, -1, "edge")
    b2 = corr1d(row0, xg, -1, "edge")
    b4 = corr1d(row0, xxg, -1, "edge")
    b3 = corr1d(row1, g, -1, "edge")
    b6 = corr1d(row1, xg, -1, "edge")
    b5 = corr1d(row2, g, -1, "edge")
    return torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                        b1 * ig03 + b4 * ig33, b6 * ig55], dim=-3)


def expansion_pyramid(stack: torch.Tensor, flow: dict, rs: Resizer):
    """Per-level expansions (B, 5, h_k, w_k) of a (B, H, W) stack: each
    level the full-resolution stack blurred with the level's taps,
    resized, expanded."""
    h, w = stack.shape[-2:]
    sizes = pyramid_sizes(h, w, clamped_levels(flow, h, w), flow["pyr_scale"])
    out = []
    for k, hw in enumerate(sizes):
        taps = level_smoothing_taps(k, flow["pyr_scale"])
        img = rs.linear(sep_correlate(stack, taps, "reflect"), hw)
        out.append(poly_expand(img, flow["poly_n"], flow["poly_sigma"])
                   .contiguous())
    return out


def bilinear_sample(img: torch.Tensor, fx: torch.Tensor,
                    fy: torch.Tensor) -> torch.Tensor:
    """``img`` (..., H, W) at (fx, fy), bilinear, replicate borders."""
    h, w = img.shape[-2], img.shape[-1]
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = x0.float().clamp(-1, w).to(torch.int64)
    y0i = y0.float().clamp(-1, h).to(torch.int64)
    xa, xb = x0i.clamp(0, w - 1), (x0i + 1).clamp(0, w - 1)
    ya, yb = y0i.clamp(0, h - 1), (y0i + 1).clamp(0, h - 1)
    batch = torch.broadcast_shapes(img.shape[:-2], fx.shape[:-2])
    hw = fx.shape[-2:]
    flat = img.reshape(img.shape[:-2] + (h * w,)).expand(batch + (h * w,))

    def gather(yi, xi):
        idx = (yi * w + xi).expand(batch + hw).reshape(batch + (-1,))
        return torch.gather(flat, -1, idx).reshape(batch + hw)

    v00, v01 = gather(ya, xa), gather(ya, xb)
    v10, v11 = gather(yb, xa), gather(yb, xb)
    top = v00 + (v01 - v00) * tx
    bot = v10 + (v11 - v10) * tx
    return top + (bot - top) * ty


def displace(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
             d: int | None) -> torch.Tensor:
    """``src`` (B, [C,] H, W) sampled at (x + u, y + v), (u, v) clamped to
    +-d (None: unclamped)."""
    if d is not None:
        u = u.clamp(-float(d), float(d))
        v = v.clamp(-float(d), float(d))
    h, w = src.shape[-2], src.shape[-1]
    if src.ndim == u.ndim + 1:
        u = u.unsqueeze(-3)
        v = v.unsqueeze(-3)
    gx = torch.arange(w, dtype=src.dtype, device=src.device)
    gy = torch.arange(h, dtype=src.dtype, device=src.device).reshape(h, 1)
    return bilinear_sample(src, u + gx, v + gy)


@functools.lru_cache(maxsize=None)
def _border_map(h: int, w: int) -> np.ndarray:
    sy, sx = np.ones(h), np.ones(w)
    for i in range(min(5, h)):
        sy[i] *= _BORDER_RAMP[i]
    for i in range(min(5, h)):
        sy[h - 1 - i] *= _BORDER_RAMP[i]
    for i in range(min(5, w)):
        sx[i] *= _BORDER_RAMP[i]
    for i in range(min(5, w)):
        sx[w - 1 - i] *= _BORDER_RAMP[i]
    return np.outer(sy, sx)


def update_matrices(r0, r1, flow, d) -> torch.Tensor:
    """Per-pixel normal equations M = [G11, G12, G22, h1, h2] (B, 5, H, W)
    from r1 sampled at the clamped flow."""
    h, w = r0.shape[-2], r0.shape[-1]
    dx, dy = flow[:, 0], flow[:, 1]
    gx = torch.arange(w, dtype=r0.dtype, device=r0.device)
    gy = torch.arange(h, dtype=r0.dtype, device=r0.device).reshape(h, 1)
    x1, y1 = torch.floor(gx + dx), torch.floor(gy + dy)
    inb = (x1 >= 0) & (x1 <= w - 2) & (y1 >= 0) & (y1 <= h - 2)
    s = displace(r1, dx, dy, d).unbind(-3)
    scale = torch.as_tensor(_border_map(h, w), dtype=r0.dtype, device=r0.device)
    a = r0.unbind(-3)
    r4 = torch.where(inb, (a[2] + s[2]) * 0.5, a[2])
    r5 = torch.where(inb, (a[3] + s[3]) * 0.5, a[3])
    r6 = torch.where(inb, (a[4] + s[4]) * 0.25, a[4] * 0.5)
    r2 = (a[0] - torch.where(inb, s[0], 0.0)) * 0.5
    r3 = (a[1] - torch.where(inb, s[1], 0.0)) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx
    r2, r3, r4, r5, r6 = (t * scale for t in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3, r6 * r2 + r5 * r3], dim=-3)


def update_flow(m: torch.Tensor, winsize: int) -> torch.Tensor:
    """Box-average M over winsize (replicate border, 1/winsize^2) and solve
    each pixel's 2x2 system; (B, 2, H, W), channel 0 = x."""
    taps = np.ones(2 * (winsize // 2) + 1, dtype=np.float64)
    ms = sep_correlate(m, taps, "edge") * (1.0 / float(winsize * winsize))
    g11, g12, g22, h1, h2 = ms.unbind(-3)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet,
                        (g22 * h1 - g12 * h2) * idet], dim=-3)


def level_bound(flow: dict, d: int | None, level: int) -> int | None:
    """The sampling bound at a level: max(2, ceil(D scale^k) + 1)."""
    if d is None:
        return None
    return max(2, int(np.ceil(d * flow["pyr_scale"] ** level)) + 1)


def solve(r0_levels, r1_levels, flow: dict, d: int | None, rs: Resizer,
          seed: torch.Tensor | None = None,
          block: int = BLOCK) -> torch.Tensor:
    """Coarse-to-fine Farneback flow from target expansions ``r0_levels``
    to reference expansions ``r1_levels`` (each (B, 5, h_k, w_k)), seeded
    by ``seed`` (B, 2, H, W) or zero; (B, 2, H, W) float32, in blocks of
    ``block`` planes."""
    b = r0_levels[0].shape[0]
    if b > block:
        return torch.cat([
            solve([r[i:i + block] for r in r0_levels],
                  [r[i:i + block] for r in r1_levels], flow, d, rs,
                  None if seed is None else seed[i:i + block], block)
            for i in range(0, b, block)])
    f = None
    for k in range(len(r0_levels) - 1, -1, -1):
        r0, r1 = r0_levels[k], r1_levels[k]
        hk, wk = r0.shape[-2:]
        if f is None:
            if seed is not None and flow["use_initial_flow"]:
                f = rs.area(seed.float(), (hk, wk)) * (flow["pyr_scale"] ** k)
            else:
                f = torch.zeros((b, 2, hk, wk), device=r0.device)
        else:
            f = rs.linear(f, (hk, wk)) * (1.0 / flow["pyr_scale"])
        f = f.contiguous()
        dk = level_bound(flow, d, k)
        for _ in range(flow["iterations"]):
            f = update_flow(update_matrices(r0, r1, f, dk), flow["winsize"])
    return f


# ---- the passes and the pipeline


def block_planes(h: int, w: int, pixels: int = PIXELS) -> int:
    """Planes of h x w a tap solve holds at once: ``BLOCK`` at most, and
    within ``pixels`` where more than one plane would pass it."""
    return min(BLOCK, max(1, pixels // (h * w)))


def windows(n: int, h: int, w: int, ks2: int,
            pixels: int = WINDOW_PIXELS) -> list:
    """(start, stop) of each window of a pass's ``n`` output planes of
    h x w: as many as fit ``pixels`` with their 2 ks2 halo planes (one at
    least); the last may be short."""
    size = max(1, pixels // (h * w) - 2 * ks2)
    return [(a, min(a + size, n)) for a in range(0, n, size)]


def window_stack(vol: torch.Tensor, start: int, stop: int,
                 ks2: int) -> torch.Tensor:
    """Planes ``start - ks2 .. stop + ks2`` of ``vol`` along axis 0,
    indices taken modulo N (the WRAP boundary)."""
    idx = np.arange(start - ks2, stop + ks2) % vol.shape[0]
    return vol.index_select(0, torch.as_tensor(idx, device=vol.device))


def solve_pass(padded: torch.Tensor, taps: np.ndarray, flow: dict,
               rs: Resizer, block: int = BLOCK) -> torch.Tensor:
    """Solve mode over a stack of output slices and their ks2 halo slices
    a side: for each tap (centre, then -1 .. -ks2, then +1 .. +ks2) the
    flow from every output slice to its neighbour, seeded by the previous
    tap's, the neighbour warped by it and added with the tap's weight."""
    ks2 = len(taps) // 2
    n = padded.shape[0] - 2 * ks2
    d = flow["max_displacement"]
    levels = expansion_pyramid(padded, flow, rs)
    r0 = [r[ks2:ks2 + n] for r in levels]
    acc = padded[ks2:ks2 + n] * f32(taps[ks2])
    for sign in (-1, +1):
        f = None
        for j in range(1, ks2 + 1):
            start = ks2 + sign * j
            f = solve(r0, [r[start:start + n] for r in levels], flow, d, rs,
                      f, block)
            warped = displace(padded[start:start + n], f[:, 0], f[:, 1], d)
            acc.add_(warped * f32(taps[ks2 + sign * j]))
    return acc


def compose_pass(padded: torch.Tensor, taps: np.ndarray, flow: dict,
                 rs: Resizer, block: int = BLOCK) -> torch.Tensor:
    """Compose mode over a stack as ``solve_pass``'s: the flows between
    the stack's adjacent slices, both directions, at the bound min(D,
    adjacent_displacement); the flow to the tap at distance j composed
    outward, F_j = F_{j-1} + warp(link, F_{j-1}), and the neighbour warped
    by F_j added with the tap's weight; each run starts from zero flow."""
    ks2 = len(taps) // 2
    n = padded.shape[0] - 2 * ks2
    d = flow["max_displacement"]
    d_adj = d
    if flow["adjacent_displacement"] is not None and d is not None:
        d_adj = min(d, flow["adjacent_displacement"])
    levels = expansion_pyramid(padded, flow, rs)
    lo = [r[:-1] for r in levels]
    hi = [r[1:] for r in levels]
    adj_fwd = solve(lo, hi, flow, d_adj, rs, None, block)
    adj_bwd = (None if flow["symmetric_adjacent"] else
               solve(hi, lo, flow, d_adj, rs, None, block))
    del levels, lo, hi
    acc = padded[ks2:ks2 + n] * f32(taps[ks2])
    weights = [f32(taps[ks2 + sign * j]) for sign in (-1, +1)
               for j in range(1, ks2 + 1)]
    for sign in (-1, +1):
        f = torch.zeros((n, 2) + tuple(acc.shape[1:]), device=acc.device)
        for j in range(1, ks2 + 1):
            start = ks2 + sign * j
            if sign > 0:
                link = adj_fwd[start - 1:start - 1 + n]
            else:
                link = (-adj_fwd[start:start + n] if adj_bwd is None
                        else adj_bwd[start:start + n])
            f = f + displace(link, f[:, 0], f[:, 1], d)
            warped = displace(padded[start:start + n], f[:, 0], f[:, 1], d)
            acc = acc + warped * weights[ks2 * (sign > 0) + j - 1]
    return acc


# canonical axes of each pass's layout, Z, Y, X pass order
LAYOUTS = [(0, 1, 2), (1, 0, 2), (2, 0, 1)]


def windowed_pass(vol: torch.Tensor, taps: np.ndarray, flow: dict,
                  rs: Resizer, run, pixels: int,
                  window_pixels: int) -> torch.Tensor:
    """``run`` (``solve_pass`` or ``compose_pass``) along axis 0 of the
    (N, H, W) ``vol``, a window of output planes at a time (``windows``),
    each written into one (N, H, W) float32 output."""
    n, h, w = vol.shape
    ks2 = len(taps) // 2
    block = block_planes(h, w, pixels)
    out = torch.empty_like(vol)
    for a, b in windows(n, h, w, ks2, window_pixels):
        out[a:b] = run(window_stack(vol, a, b, ks2), taps, flow, rs, block)
    return out


def denoise(vol, sigma, flow: dict, tap_mode: str, device="cpu",
            tf32: bool = False, pixels: int = PIXELS,
            window_pixels: int = WINDOW_PIXELS) -> torch.Tensor:
    """The three-pass flow denoise of a (Z, Y, X) volume with the WRAP
    boundary, in float32: each pass filters axis 0 of the volume permuted
    to its layout, over windows of ``window_pixels`` and tap-solve blocks
    of ``pixels`` (``windowed_pass``).  Returns the (Z, Y, X) float32
    result on ``device``."""
    rs = Resizer(tf32)
    run = {"solve": solve_pass, "compose": compose_pass}[tap_mode]
    out = torch.as_tensor(np.asarray(vol), dtype=torch.float32, device=device)
    layout = (0, 1, 2)
    for axis, target in enumerate(LAYOUTS):
        taps = gaussian_taps(sigma[axis])
        out = out.permute(tuple(layout.index(ax) for ax in target)).contiguous()
        layout = target
        out = windowed_pass(out, taps, flow, rs, run, pixels, window_pixels)
    return out.permute(tuple(layout.index(ax) for ax in (0, 1, 2))).contiguous()

"""Volume quality metrics (PSNR / SSIM), the counterpart of
``flowdenoising_tpu/utils/metrics.py``: the same formulas, computed in
float64 on the device of a tensor input (an input that is not a tensor
goes to ``device``), each result a Python float.

SSIM follows Wang et al. 2004 with the 11-tap sigma=1.5 Gaussian window,
applied slice-wise over the last two axes with NumPy's ``symmetric`` border
(the edge texel repeated, and reflected again where the pad is wider than
the plane), and averaged over the slices.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from flowdenoising_tpu_torch.ops.device import as_tensors

__all__ = ["psnr", "ssim", "ssim_slice"]


def _float64(a, b, device) -> tuple[torch.Tensor, torch.Tensor]:
    a, b = as_tensors(a, b, device=device, dtype=torch.float64)
    return a.to(torch.float64), b.to(torch.float64)


def _peak(a: torch.Tensor) -> float:
    """The JAX package's default peak: the range of ``a``, at least 1e-12."""
    return max(float(a.max() - a.min()), 1e-12)


def psnr(a, b, peak: float | None = None, device="cuda") -> float:
    """10 log10(peak^2 / MSE); ``inf`` where a equals b; ``peak`` defaults
    to the range of ``a``."""
    a, b = _float64(a, b, device)
    mse = float(torch.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    if peak is None:
        peak = _peak(a)
    return 10.0 * math.log10(peak * peak / mse)


def _gaussian_window(radius: int = 5, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2 * sigma * sigma))
    return g / g.sum()


def _filter2d(img: torch.Tensor, g: np.ndarray) -> torch.Tensor:
    """Separable correlation of the (..., H, W) planes with ``g`` along H,
    then W, over NumPy's ``symmetric`` pad of each axis.  The padded index
    map comes from ``np.pad`` itself, so a pad wider than the axis reflects
    as NumPy's does."""
    r = len(g) // 2
    out = img
    for axis in (-2, -1):
        n = out.shape[axis]
        idx = np.pad(np.arange(n), r, mode="symmetric")
        p = out.index_select(axis, torch.as_tensor(idx, device=img.device))
        acc = None
        for k, gk in enumerate(g):
            term = p.narrow(axis, k, n) * float(gk)
            acc = term if acc is None else acc.add_(term)
        out = acc
    return out


def _ssim_map(a: torch.Tensor, b: torch.Tensor, peak: float) -> torch.Tensor:
    """The SSIM index of every texel of the (..., H, W) planes."""
    g = _gaussian_window()
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    mu_a = _filter2d(a, g)
    mu_b = _filter2d(b, g)
    s_aa = _filter2d(a * a, g) - mu_a * mu_a
    s_bb = _filter2d(b * b, g) - mu_b * mu_b
    s_ab = _filter2d(a * b, g) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * s_ab + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (s_aa + s_bb + c2)
    return num / den


def ssim_slice(a, b, peak: float, device="cuda") -> float:
    """Mean SSIM of one (H, W) plane."""
    a, b = _float64(a, b, device)
    return float(_ssim_map(a, b, peak).mean())


def ssim(a, b, peak: float | None = None, device="cuda") -> float:
    """Mean slice-wise SSIM over the Z axis of (Z, Y, X) volumes (of the
    plane itself for (Y, X)); ``peak`` defaults to the range of ``a``."""
    a, b = _float64(a, b, device)
    if peak is None:
        peak = _peak(a)
    if a.ndim == 2:
        return float(_ssim_map(a, b, peak).mean())
    return float(_ssim_map(a, b, peak).mean(dim=(-2, -1)).mean())

"""Separable blurs with OpenCV-compatible kernels and borders.

Counterpart of ``flowdenoising_tpu/ops/blur.py``: the pre-pyramid
GaussianBlur and the winsize box aggregation of OpenCV's Farneback.  Each
1-D correlation is a shift-and-add over one padded tensor (no convolution
library call, so no TF32 question arises), in the input's dtype: on a
bfloat16 input (a ``--dtype bfloat16`` pass) the taps are rounded to
bfloat16 and every product and sum rounds to bfloat16, as the JAX
package's correlation does.  A pyramid level's pre-blur (``pyr_blur``)
runs in the kernel K-pyr-blur on a CUDA float32 stack.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from flowdenoising_tpu_torch.ops.cuda import polyexp as kernel
from flowdenoising_tpu_torch.ops.device import as_tensors, use_kernel
from flowdenoising_tpu_torch.utils.tracing import span

# OpenCV getGaussianKernel fixed taps for sigma<=0 and ksize in {1,3,5,7}.
_SMALL_GAUSSIAN_TAB = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]),
}


@functools.lru_cache(maxsize=None)
def opencv_gaussian_taps(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel semantics (float64, normalized).

    sigma <= 0 uses the fixed small-kernel table for ksize <= 7, else the
    derived sigma ``0.3*((ksize-1)*0.5 - 1) + 0.8``.
    """
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN_TAB:
        return _SMALL_GAUSSIAN_TAB[ksize].copy()
    s = sigma if sigma > 0 else 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * s * s))
    return k / k.sum()


def smooth_kernel_for_level(level: int, pyr_scale: float = 0.5) -> np.ndarray:
    """Pre-pyramid smoothing taps used by OpenCV Farneback at a given level:
    sigma = (1/scale - 1) * 0.5, ksize = cvRound(sigma*5) | 1 clamped to >= 3."""
    scale = pyr_scale ** level
    sigma = (1.0 / scale - 1.0) * 0.5
    ksize = int(np.rint(sigma * 5)) | 1
    ksize = max(ksize, 3)
    return opencv_gaussian_taps(ksize, sigma)


@functools.lru_cache(maxsize=None)
def rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (to nearest even), as a Python float: the
    constant that ``jnp.asarray(x, dtype)`` and JAX's weak typing give an
    array of that dtype.  Multiplying a tensor of ``dtype`` by it rounds as
    the JAX package's product of two ``dtype`` values."""
    return float(torch.tensor(float(x), dtype=torch.float64).to(dtype))


def corr1d(img: torch.Tensor, taps, axis: int, pad_mode: str) -> torch.Tensor:
    """1-D correlation along ``axis`` as a shift-and-add over a padded copy.

    ``pad_mode`` is numpy's: "edge" (cv2 BORDER_REPLICATE) or "reflect"
    (cv2 BORDER_REFLECT_101).  The padded index map comes from ``np.pad``,
    so pads wider than the axis reflect exactly as numpy's do.
    """
    taps = np.asarray(taps, dtype=np.float64)
    r = len(taps) // 2
    axis = axis % img.ndim
    n = img.shape[axis]
    idx = np.pad(np.arange(n), (r, r), mode=pad_mode)
    with span("fdt.drain.blur_index"):
        idx = torch.as_tensor(idx, device=img.device)
    p = img.index_select(axis, idx)
    out = None
    for k in range(len(taps)):
        term = p.narrow(axis, k, n) * rounded(taps[k], img.dtype)
        out = term if out is None else out.add_(term)
    return out


def _sep_correlate(img: torch.Tensor, taps_h: np.ndarray, taps_w: np.ndarray,
                   pad_mode: str) -> torch.Tensor:
    """Separable 2-D correlation on the trailing axes."""
    return corr1d(corr1d(img, taps_h, -2, pad_mode), taps_w, -1, pad_mode)


def pyr_blur(img: torch.Tensor, taps) -> torch.Tensor:
    """A pyramid level's reflect-101 pre-blur of (..., H, W) with an odd
    number of ``taps``: K-pyr-blur on a CUDA float32 stack, bit for bit its
    plain version ``_sep_correlate`` elsewhere."""
    if use_kernel(img, "pyr_blur", float32=True):
        return kernel.pyr_blur(img, taps)
    return _sep_correlate(img, taps, taps, "reflect")


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur(img, (ksize, ksize), sigma) with the default
    BORDER_REFLECT_101 border, batched over leading axes."""
    taps = opencv_gaussian_taps(ksize, sigma)
    return _sep_correlate(img, taps, taps, "reflect")


def box_blur_sum(img: torch.Tensor, winsize: int) -> torch.Tensor:
    """Replicate-border box *sum* over a (2*(winsize//2)+1)^2 window.

    The caller scales by 1/winsize**2, as OpenCV does even for an even
    winsize, whose window has (winsize+1)^2 taps.
    """
    m = winsize // 2
    taps = np.ones(2 * m + 1, dtype=np.float64)
    return _sep_correlate(img, taps, taps, "edge")


def box_blur(img, winsize: int, device="cuda") -> torch.Tensor:
    """Box mean with OpenCV Farneback's 1/winsize**2 normalization:
    ``box_blur_sum`` in img's dtype (a bfloat16 image sums in bf16), then
    scaled by 1/winsize**2 rounded to that dtype.  An input that is not a
    tensor goes to ``device`` as float32."""
    img, = as_tensors(img, device=device)
    return box_blur_sum(img, winsize) * rounded(1.0 / float(winsize * winsize),
                                                img.dtype)

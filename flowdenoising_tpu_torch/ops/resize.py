"""Separable image resizing as two dense matrix products.

Counterpart of ``flowdenoising_tpu/ops/resize.py``.  Every resample of the
Farneback pyramid (OpenCV INTER_LINEAR for image and flow, INTER_AREA for
the seed flow) is ``out = W_rows @ img @ W_cols^T`` with weight matrices
built on the host in float64 and cast to float32.  The products run in full
float32: ``torch.backends.cuda.matmul.allow_tf32`` must stay False (the
default), which ``chip_smoke.py`` checks.

Weight conventions match OpenCV:
- linear: source coordinate ``s = (d + 0.5) * (in/out) - 0.5``, bilinear taps
  clamped to the valid range (border replicate).
- area: true area overlap weights of the destination pixel's source interval.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear resampling weights, OpenCV INTER_LINEAR convention."""
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float64)
    w = np.zeros((n_out, n_in), dtype=np.float64)
    scale = n_in / n_out
    for d in range(n_out):
        s = (d + 0.5) * scale - 0.5
        i0 = int(np.floor(s))
        f = s - i0
        a = np.clip(i0, 0, n_in - 1)
        b = np.clip(i0 + 1, 0, n_in - 1)
        w[d, a] += 1.0 - f
        w[d, b] += f
    return w


@functools.lru_cache(maxsize=None)
def area_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) area-average resampling weights (OpenCV INTER_AREA for
    downscaling; bilinear for upscaling, as OpenCV does)."""
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float64)
    if n_out > n_in:
        return linear_resize_matrix(n_in, n_out)
    w = np.zeros((n_out, n_in), dtype=np.float64)
    scale = n_in / n_out
    for d in range(n_out):
        lo = d * scale
        hi = (d + 1) * scale
        i0 = int(np.floor(lo))
        i1 = int(np.ceil(hi))
        for i in range(i0, min(i1, n_in)):
            overlap = min(hi, i + 1) - max(lo, i)
            if overlap > 0:
                w[d, i] = overlap
        w[d] /= w[d].sum()
    return w


def _apply_separable(img: torch.Tensor, wr: np.ndarray,
                     wc: np.ndarray) -> torch.Tensor:
    """img: (..., H, W); wr: (H', H); wc: (W', W) -> (..., H', W'), rows
    first, then columns, in float32."""
    wr_t = torch.as_tensor(wr, dtype=img.dtype, device=img.device)
    wc_t = torch.as_tensor(wc, dtype=img.dtype, device=img.device)
    out = torch.einsum("hH,...HW->...hW", wr_t, img)
    return torch.einsum("wW,...hW->...hw", wc_t, out)


def resize_linear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the trailing two axes (OpenCV INTER_LINEAR)."""
    h_in, w_in = img.shape[-2], img.shape[-1]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return img
    return _apply_separable(img, linear_resize_matrix(h_in, h_out),
                            linear_resize_matrix(w_in, w_out))


def resize_area(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Area-average resize of the trailing two axes (OpenCV INTER_AREA)."""
    h_in, w_in = img.shape[-2], img.shape[-1]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return img
    return _apply_separable(img, area_resize_matrix(h_in, h_out),
                            area_resize_matrix(w_in, w_out))


def cv_round(x: float) -> int:
    """OpenCV cvRound: round half to even (host-side ``np.rint``)."""
    return int(np.rint(x))


def pyramid_sizes(height: int, width: int, levels: int,
                  pyr_scale: float) -> list[tuple[int, int]]:
    """Per-level (h, w), index 0 = full resolution, following OpenCV's
    ``cvRound(size * pyr_scale**k)`` sizing."""
    sizes = []
    for k in range(levels + 1):
        scale = pyr_scale ** k
        sizes.append((cv_round(height * scale), cv_round(width * scale)))
    return sizes

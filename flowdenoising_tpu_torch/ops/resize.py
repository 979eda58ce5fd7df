"""Separable image resizing: a banded CUDA kernel on the card, two dense
matrix products per plane elsewhere.

Counterpart of ``flowdenoising_tpu/ops/resize.py``.  Every resample of the
Farneback pyramid (OpenCV INTER_LINEAR for image and flow, INTER_AREA for
the seed flow) is ``out = W_rows @ img @ W_cols^T`` with weight matrices
built on the host in float64 and cast to the input's dtype.  Two routes
compute it:

- A CUDA float32 tensor runs K-resize (``ops/cuda/resize.py``,
  ``csrc/resize.cu``): one launch a resize, a gather over each axis's tap
  table (``tap_table``: for each output index the first source index and a
  fixed-width run of the matrix's own float32 weights), copied to the card
  at a shape's first use and kept there (``device_table``).  It sums as a
  sequential multiply-add product does, rows first, so for finite inputs
  its bits are the dense products' wherever cuBLAS sums in order, as it
  does at every resize of the benchmark's passes (it splits the sums of
  some single planes).
- Every other tensor, a CPU or bfloat16 one, takes the dense products
  (``_apply_separable``), which stay as K-resize's plain version.  They run
  in full float32 whatever the process has set, as the JAX package pins
  them to HIGHEST: ``_full_float32`` sets the float32 precision of the CUDA
  (TF32) and oneDNN (bfloat16 on the CPU) matrix products to "ieee" around
  them and restores the caller's settings after.  A bfloat16 input (a
  ``--dtype bfloat16`` pass) has its weights rounded to bfloat16 and each
  of the two products rounded to bfloat16, as the JAX package's bf16 einsum
  at HIGHEST precision rounds them; the product itself is taken in float32
  (a product of two bf16 values is exact there), not as a bf16 matrix
  product whose reduction the library may round on the way.

Both run in the range ``fdt.resize``.

Weight conventions match OpenCV:
- linear: source coordinate ``s = (d + 0.5) * (in/out) - 0.5``, bilinear taps
  clamped to the valid range (border replicate).
- area: true area overlap weights of the destination pixel's source interval.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from flowdenoising_tpu_torch.ops.cuda import resize as kernel
from flowdenoising_tpu_torch.ops.device import use_kernel
from flowdenoising_tpu_torch.utils.tracing import RESIZE_RANGE, span


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


_MATRICES = {"linear": linear_resize_matrix, "area": area_resize_matrix}


@functools.lru_cache(maxsize=None)
def tap_table(kind: str, n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """K-resize's taps of one axis, ``kind`` "linear" or "area": (start,
    weights), start (n_out,) int32 and weights (n_out, taps) float32, so
    that row d of the (n_out, n_in) matrix cast to float32 holds
    ``weights[d]`` at ``start[d] ..  start[d] + taps - 1`` and zeros
    elsewhere.  ``taps`` spans the widest row's nonzeros (2 for linear, at
    most ceil(n_in / n_out) + 1 for area), and each run is moved left where
    it would pass the axis's end.  Read-only arrays, cached."""
    m = _MATRICES[kind](n_in, n_out)
    nonzero = m != 0
    first = nonzero.argmax(axis=1)
    last = n_in - 1 - nonzero[:, ::-1].argmax(axis=1)
    taps = int((last - first).max()) + 1
    start = np.minimum(first, n_in - taps).astype(np.int32)
    weights = np.take_along_axis(m, start[:, None] + np.arange(taps),
                                 axis=1).astype(np.float32)
    start.flags.writeable = False
    weights.flags.writeable = False
    return start, weights


@functools.cache
def device_table(kind: str, n_in: int, n_out: int,
                 device: torch.device) -> tuple[torch.Tensor, int]:
    """K-resize's table of one axis on ``device``: (n_out int32 starts
    followed by the n_out x taps float32 weights' bits, taps), copied in an
    ``fdt.drain.resize_matrix`` span at its first use and kept for the
    process, so that a later resize of the same shape holds no drain."""
    starts, weights = tap_table(kind, n_in, n_out)
    buf = np.concatenate([starts, weights.reshape(-1).view(np.int32)])
    with span("fdt.drain.resize_matrix"):
        return torch.from_numpy(buf).to(device), weights.shape[1]


# The float32 matrix-product settings that torch.set_float32_matmul_precision
# and torch.backends.fp32_precision reach: "high" or "medium" turns on TF32
# on CUDA, and "medium" bfloat16 products in oneDNN on the CPU.
_MATMUL_PRECISIONS = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)


@contextlib.contextmanager
def _full_float32():
    """IEEE float32 matrix products inside, the caller's settings after."""
    saved = [b.fp32_precision for b in _MATMUL_PRECISIONS]
    try:
        for b in _MATMUL_PRECISIONS:
            b.fp32_precision = "ieee"
        yield
    finally:
        for b, p in zip(_MATMUL_PRECISIONS, saved):
            b.fp32_precision = p


def _apply_separable(img: torch.Tensor, wr: np.ndarray,
                     wc: np.ndarray) -> torch.Tensor:
    """img: (..., H, W); wr: (H', H); wc: (W', W) -> (..., H', W'), rows
    first, then columns, each product in full float32 and rounded to img's
    dtype.

    Each plane is one product of a batched multiply (``torch.bmm``) whose
    shapes are the plane's, never the batch's: folding the batch into a
    matrix dimension let the library pick another algorithm, with another
    order of the sums, for another number of planes, so a window's planes
    came out other than the whole axis's.  Each matrix's copy to the
    device is a drain of its own (``fdt.drain.resize_matrix``)."""
    dtype = img.dtype
    lead = tuple(img.shape[:-2])
    x = img.reshape((-1,) + tuple(img.shape[-2:])).float()
    b = x.shape[0]
    with span("fdt.drain.resize_matrix"):
        wr_t = torch.as_tensor(wr, dtype=dtype, device=img.device).float()
    with span("fdt.drain.resize_matrix"):
        wc_t = torch.as_tensor(wc, dtype=dtype, device=img.device).float()
    with _full_float32():
        out = torch.bmm(wr_t.expand(b, -1, -1), x).to(dtype)
        out = torch.bmm(out.float(), wc_t.t().expand(b, -1, -1)).to(dtype)
    return out.reshape(lead + tuple(out.shape[-2:]))


def _resize(img: torch.Tensor, kind: str, out_hw: tuple[int, int]) -> torch.Tensor:
    """The trailing two axes resized to ``out_hw`` in the range
    ``fdt.resize``: K-resize on a CUDA float32 tensor, else the dense
    products; img itself where the shape is already ``out_hw``."""
    h_in, w_in = img.shape[-2], img.shape[-1]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return img
    with span(RESIZE_RANGE):
        if use_kernel(img, "resize", float32=True):
            return kernel.resize(img, (h_out, w_out),
                                 device_table(kind, h_in, h_out, img.device),
                                 device_table(kind, w_in, w_out, img.device))
        matrix = _MATRICES[kind]
        return _apply_separable(img, matrix(h_in, h_out), matrix(w_in, w_out))


def resize_linear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the trailing two axes (OpenCV INTER_LINEAR)."""
    return _resize(img, "linear", out_hw)


def resize_area(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Area-average resize of the trailing two axes (OpenCV INTER_AREA)."""
    return _resize(img, "area", out_hw)


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

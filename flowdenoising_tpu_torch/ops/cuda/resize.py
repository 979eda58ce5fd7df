"""K-resize wrapper (CUDA source ``flowdenoising_tpu_torch/csrc/resize.cu``).

The kernel replaces no TPU kernel: the JAX package resizes with two dense
einsums, and the port's dense products (``ops.resize._apply_separable``)
stay as its plain version, which a CPU tensor and a bfloat16 one keep.
``ops.resize.resize_linear`` and ``resize_area`` take this route where
``takes`` says so.  Each axis's tap table (``ops.resize.tap_table``) is
copied to the card once per (kind, sizes, device), at its first use, in an
``fdt.drain.resize_matrix`` span, and kept: a later resize of the same
shape copies nothing and holds no drain.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from flowdenoising_tpu_torch.ops.cuda import LAUNCHES
from flowdenoising_tpu_torch.ops.cuda.build import check, load_library
from flowdenoising_tpu_torch.utils.tracing import span

def takes(img: torch.Tensor) -> bool:
    """Whether a resize of img runs in K-resize: a CUDA float32 tensor.
    Every other tensor, a CPU or bfloat16 one among them, takes the dense
    products."""
    return img.device.type == "cuda" and img.dtype == torch.float32


@functools.cache
def device_table(kind: str, n_in: int, n_out: int,
                 device: torch.device) -> tuple[torch.Tensor, int]:
    """One axis's tap table on ``device``: (n_out int32 starts followed by
    the n_out x taps float32 weights' bits, taps), copied at its first use
    and cached."""
    # imported here: ops.resize imports this module
    from flowdenoising_tpu_torch.ops.resize import tap_table
    starts, weights = tap_table(kind, n_in, n_out)
    buf = np.concatenate([starts, weights.reshape(-1).view(np.int32)])
    with span("fdt.drain.resize_matrix"):
        return torch.from_numpy(buf).to(device), weights.shape[1]


def resize(img: torch.Tensor, kind: str, out_hw: tuple[int, int]) -> torch.Tensor:
    """(..., H, W) float32 on the card -> (..., H', W'), ``kind`` "linear"
    or "area": one launch of K-resize, each sum taken in ascending source
    order, as the dense products of ``ops.resize._apply_separable`` take
    it wherever cuBLAS sums in order.  Raises for any other device or
    dtype."""
    if not takes(img) or img.dim() < 2:
        raise ValueError(f"resize: expected a float32 (..., H, W) tensor on "
                         f"the card, got {img.dtype} {tuple(img.shape)} on "
                         f"{img.device}")
    h, w = img.shape[-2], img.shape[-1]
    h2, w2 = out_hw
    x = img.reshape((-1, h, w)).contiguous()
    rows, rtaps = device_table(kind, h, h2, x.device)
    cols, ctaps = device_table(kind, w, w2, x.device)
    out = torch.empty((x.shape[0], h2, w2), dtype=torch.float32,
                      device=x.device)
    rc = load_library().fdt_resize(
        x.data_ptr(), out.data_ptr(), x.shape[0], h, w, h2, w2,
        rows.data_ptr(), rtaps, cols.data_ptr(), ctaps,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "fdt_resize")
    LAUNCHES["resize"] += 1
    return out.reshape(tuple(img.shape[:-2]) + (h2, w2))

"""Batched bilinear slice warping (replaces cv2.remap).

Counterpart of ``flowdenoising_tpu/ops/warp.py``: ``out[y, x] = ref(x +
flow[y,x,0], y + flow[y,x,1])``, bilinear, replicate borders.  With a
displacement bound D the flow is clamped to +-D first.  The JAX package
evaluates that bound as a static window of shifted reads, a device for the
TPU; on |u|, |v| <= D it is the same function as the clamped gather here.
"""

from __future__ import annotations

import torch

from flowdenoising_tpu_torch.ops.cuda.sample import displace_sample

__all__ = ["bilinear_sample", "displace_sample", "displace_sample_plain",
           "warp_slices"]


def bilinear_sample(img: torch.Tensor, fx: torch.Tensor,
                    fy: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (..., H, W) at float coords (fx, fy) of shape
    (..., H', W') -- leading dims broadcast -- with bilinear interpolation
    and replicate (clamp) borders."""
    h, w = img.shape[-2], img.shape[-1]
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    # bound before the integer cast: every x0 outside [-1, w] selects the
    # same edge pair
    x0i = x0.clamp(-1, w).to(torch.int64)
    y0i = y0.clamp(-1, h).to(torch.int64)
    xa = x0i.clamp(0, w - 1)
    xb = (x0i + 1).clamp(0, w - 1)
    ya = y0i.clamp(0, h - 1)
    yb = (y0i + 1).clamp(0, h - 1)

    batch = torch.broadcast_shapes(img.shape[:-2], fx.shape[:-2])
    hw = fx.shape[-2:]
    flat = img.reshape(img.shape[:-2] + (h * w,)).expand(batch + (h * w,))

    def gather(yi, xi):
        idx = (yi * w + xi).expand(batch + hw).reshape(batch + (-1,))
        return torch.gather(flat, -1, idx).reshape(batch + hw)

    v00 = gather(ya, xa)
    v01 = gather(ya, xb)
    v10 = gather(yb, xa)
    v11 = gather(yb, xb)
    top = v00 + (v01 - v00) * tx
    bot = v10 + (v11 - v10) * tx
    return top + (bot - top) * ty


def displace_sample_plain(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                          max_displacement: int | None) -> torch.Tensor:
    """Plain version of K-sample: clamp (u, v) to +-max_displacement (None:
    no clamp), then ``bilinear_sample`` at (x + u, y + v).

    src is (..., H, W), or (..., C, H, W) with u, v (..., H, W) shared
    across C.
    """
    if max_displacement is not None:
        d = float(max_displacement)
        u = u.clamp(-d, d)
        v = v.clamp(-d, d)
    h, w = src.shape[-2], src.shape[-1]
    gx = torch.arange(w, dtype=src.dtype, device=src.device)
    gy = torch.arange(h, dtype=src.dtype, device=src.device).reshape(h, 1)
    fx = gx + u
    fy = gy + v
    if src.ndim == u.ndim + 1:
        fx = fx.unsqueeze(-3)
        fy = fy.unsqueeze(-3)
    return bilinear_sample(src, fx, fy)


def warp_slices(ref: torch.Tensor, flow: torch.Tensor,
                max_displacement: int | None = None) -> torch.Tensor:
    """Warp ``ref`` (B, H, W) by ``flow`` (B, H, W, 2), the JAX package's
    layout: channel 0 is the x displacement, channel 1 the y displacement."""
    return displace_sample(ref, flow[..., 0].contiguous(),
                           flow[..., 1].contiguous(), max_displacement)

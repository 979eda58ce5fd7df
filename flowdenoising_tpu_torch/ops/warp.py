"""Batched bilinear slice warping (replaces cv2.remap).

Counterpart of ``flowdenoising_tpu/ops/warp.py``: ``out[y, x] = ref(x +
flow[y,x,0], y + flow[y,x,1])``, bilinear, replicate borders.  With a
displacement bound D the flow is clamped to +-D first.  The JAX package
evaluates that bound as a static window of shifted reads, a device for the
TPU; on |u|, |v| <= D it is the same function as the clamped gather here.

With no bound in a bfloat16 pass the JAX package samples with its exact
gather in bf16 arithmetic, coordinates included (``displace_sample_xla``);
it has no kernel there, and neither has the port.
"""

from __future__ import annotations

import torch

from flowdenoising_tpu_torch.ops.cuda.sample import displace_sample

__all__ = ["WARP_RANGE", "bilinear_sample", "displace_sample",
           "displace_sample_plain", "displace_sample_xla", "warp_slices"]

# The torch.profiler range around the split route's tap warps (plain
# PyTorch), by which the -v 2 measured report finds their kernels.
WARP_RANGE = "warping"


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
    # same edge pair (in float32, where w is exact; a bf16 bound may not be)
    x0i = x0.float().clamp(-1, w).to(torch.int64)
    y0i = y0.float().clamp(-1, h).to(torch.int64)
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
    across C.  A bfloat16 src (the packed forms' source) is widened to
    float32 and sampled in float32, the plain version of every packed form.
    """
    if src.dtype == torch.bfloat16:
        src = src.float()
    if max_displacement is not None:
        d = float(max_displacement)
        u = u.clamp(-d, d)
        v = v.clamp(-d, d)
    return displace_sample_xla(src, u, v)


def displace_sample_xla(src: torch.Tensor, u: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``displace_sample`` with no bound, op by op:
    ``bilinear_sample`` at (u + x, v + y) with the pixel coordinates in
    src's dtype, so a bfloat16 src is sampled in bf16 arithmetic (no
    fractional coordinate past 128, no odd one past 256) and the lerps
    round to bf16 (a float32 (u, v) promotes them to float32, as in JAX).

    src is (..., H, W), or (..., C, H, W) with u, v (..., H, W) shared
    across C.
    """
    h, w = src.shape[-2], src.shape[-1]
    if src.ndim == u.ndim + 1:
        u = u.unsqueeze(-3)
        v = v.unsqueeze(-3)
    gx = torch.arange(w, dtype=src.dtype, device=src.device)
    gy = torch.arange(h, dtype=src.dtype, device=src.device).reshape(h, 1)
    return bilinear_sample(src, u + gx, v + gy)


def warp_slices(ref: torch.Tensor, flow: torch.Tensor,
                max_displacement: int | None = None) -> torch.Tensor:
    """Warp ``ref`` (B, H, W) by ``flow`` (B, H, W, 2), the JAX package's
    layout: channel 0 is the x displacement, channel 1 the y displacement."""
    return displace_sample(ref, flow[..., 0].contiguous(),
                           flow[..., 1].contiguous(), max_displacement)

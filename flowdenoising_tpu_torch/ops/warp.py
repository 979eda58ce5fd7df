"""Batched bilinear slice warping (replaces cv2.remap).

Counterpart of ``flowdenoising_tpu/ops/warp.py``: ``out[y, x] = ref(x +
flow[y,x,0], y + flow[y,x,1])``, bilinear, replicate borders.  With a
displacement bound D the flow is clamped to +-D first.  The JAX package
evaluates that bound as a static window of shifted reads, a device for the
TPU; on |u|, |v| <= D it is the same function as the clamped gather here.

``warp_slices``, ``displace_sample`` and ``bilinear_displace_windowed``
take any leading dimensions, broadcast as in the JAX package, and fold
them into the (B, [C,] H, W) shapes of K-sample
(``ops.cuda.sample.displace_sample``), which runs on a CUDA tensor; a CPU
tensor takes its plain version, ``displace_sample_plain``.  An input that
is not a tensor goes to ``device``.

A bfloat16 source with no bound is sampled as the JAX package samples it
there, with its exact gather in bf16 arithmetic, coordinates included
(``displace_sample_xla``): on a CUDA tensor by K-sample-split
(``ops.cuda.sample.sample_split``), on a CPU tensor by its plain version
``sample_split_plain``.  The result is bf16 with bf16 flows and float32
with float32 flows.  A float32 source, or a bf16 one with a bound, takes
K-sample.
"""

from __future__ import annotations

import math

import torch

from flowdenoising_tpu_torch.ops.cuda import sample as kernel
from flowdenoising_tpu_torch.ops.device import as_tensors, use_kernel
from flowdenoising_tpu_torch.utils.tracing import WARP_RANGE

__all__ = ["WARP_RANGE", "bilinear_displace_windowed", "bilinear_sample",
           "displace_sample", "displace_sample_plain", "displace_sample_xla",
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


def sample_split_plain(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                       acc: torch.Tensor | None = None,
                       weight: float | None = None) -> torch.Tensor:
    """Plain version of K-sample-split: ``displace_sample_xla(src, u, v)``,
    the exact gather in the source's bf16 arithmetic; with ``acc``, the
    pass's tap FMA ``acc += (warped * weight).to(acc.dtype)`` in place,
    returning acc."""
    warped = displace_sample_xla(src, u, v)
    if acc is None:
        return warped
    return acc.add_((warped * weight).to(acc.dtype))


def sample_split(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 acc: torch.Tensor | None = None,
                 weight: float | None = None) -> torch.Tensor:
    """K-sample-split (``ops.cuda.sample.sample_split``, whose docstring
    gives the operands and the tap FMA into ``acc``) on a CUDA tensor,
    ``sample_split_plain`` on a CPU one."""
    if use_kernel(src, "sample_split"):
        return kernel.sample_split(src, u, v, acc, weight)
    kernel.check_split(src, u, v, acc, weight)
    return sample_split_plain(src, u, v, acc, weight)


def _lead(t: torch.Tensor, nd: int) -> tuple:
    """``t``'s leading dims (all but the last two), padded with 1s to
    ``nd``."""
    return (1,) * (nd - t.ndim + 2) + tuple(t.shape[:-2])


def _sample(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
            max_displacement: int | None) -> torch.Tensor:
    """K-sample of ``img`` (..., H, W) at displacements u, v (..., H, W),
    all leading dims broadcast against each other; K-sample-split for a
    bfloat16 ``img`` with no bound.

    The trailing leading dims along which u and v are both broadcast become
    K-sample's C (one flow for C planes), the rest its B.  Nothing is copied
    that K-sample can read in place: img when it already has the broadcast
    shape and is contiguous, u and v when they are (H, W) planes at one
    batch stride (a broadcast batch has stride 0, a channels-last flow's
    channel is copied).
    """
    h, w = img.shape[-2:]
    batch = torch.broadcast_shapes(img.shape[:-2], u.shape[:-2],
                                   v.shape[:-2])
    nd = len(batch)
    ub, vb = _lead(u, nd), _lead(v, nd)
    k = nd
    while k and ub[k - 1] == 1 and vb[k - 1] == 1:
        k -= 1
    outer, inner = tuple(batch[:k]), tuple(batch[k:])
    b, c = math.prod(outer), math.prod(inner)
    split = img.dtype == torch.bfloat16 and max_displacement is None
    if b * c * h * w == 0:
        dtype = torch.promote_types(img.dtype, u.dtype) if split else img.dtype
        return img.new_empty(batch + (h, w), dtype=dtype)
    src = img.expand(batch + (h, w)).reshape(
        (b, c, h, w) if inner else (b, h, w)).contiguous()
    uu = u.reshape(ub[:k] + (h, w)).expand(outer + (h, w)).reshape(b, h, w)
    vv = v.reshape(vb[:k] + (h, w)).expand(outer + (h, w)).reshape(b, h, w)
    if uu.stride() != vv.stride() or uu.stride()[1:] != (w, 1):
        uu, vv = uu.contiguous(), vv.contiguous()
    if use_kernel(src, "displace_sample"):
        out = (kernel.sample_split(src, uu, vv) if split else
               kernel.displace_sample(src, uu, vv, max_displacement))
    else:
        out = (sample_split_plain(src, uu, vv) if split else
               displace_sample_plain(src, uu, vv, max_displacement))
    return out.reshape(batch + (h, w))


def bilinear_displace_windowed(img, u, v, max_displacement: int,
                               device="cuda") -> torch.Tensor:
    """Bilinear sampling of ``img`` (..., H, W) at displacements (u, v)
    (..., H, W) clamped into [-D, D], replicate borders; leading dims of
    img broadcast against u and v.

    The JAX package evaluates this as a static window of shifted reads (no
    gathers on the TPU); it is the clamped gather, and here K-sample, on a
    CUDA tensor.
    """
    img, u, v = as_tensors(img, u, v, device=device)
    return _sample(img, u, v, int(max_displacement))


def displace_sample(src, u, v, max_displacement: int | None,
                    sampler: str = "auto", device="cuda") -> torch.Tensor:
    """Sample ``src`` at per-pixel displacements (u, v): src is (..., H, W),
    or (..., C, H, W) with u, v (..., H, W) shared across C; u, v are
    clamped to +-max_displacement (None: no clamp).

    ``sampler`` is the JAX package's choice among its TPU forms ("auto",
    "pallas", "pallas_xwin", "windowed"), which give the same function
    wherever |u|, |v| <= D.  Here every value is that function: K-sample on
    a CUDA tensor, its plain version on a CPU tensor; none selects the
    plain version on the card.  A bfloat16 src with no bound is sampled in
    bf16 arithmetic (``displace_sample_xla``; K-sample-split on the card),
    as the JAX package's exact gather samples it.
    """
    src, u, v = as_tensors(src, u, v, device=device)
    if src.ndim == u.ndim + 1:
        u, v = u.unsqueeze(-3), v.unsqueeze(-3)
    return _sample(src, u, v, max_displacement)


def warp_slices(ref, flow, max_displacement: int | None = None,
                sampler: str = "auto", device="cuda") -> torch.Tensor:
    """Warp ``ref`` (..., H, W) by ``flow`` (..., H, W, 2), the JAX
    package's layout: channel 0 is the x displacement, channel 1 the y
    displacement.  ``max_displacement`` clamps the flow (None: no clamp);
    ``sampler`` as in ``displace_sample``.  Computed on the device of a
    tensor input, else on ``device``."""
    ref, flow = as_tensors(ref, flow, device=device)
    return displace_sample(ref, flow[..., 0], flow[..., 1], max_displacement,
                           sampler)

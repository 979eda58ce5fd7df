"""K-sample wrapper: displaced bilinear sampling (port of the Pallas kernel
``flowdenoising_tpu/ops/pallas/sample.py: _sample_kernel``; CUDA source
``flowdenoising_tpu_torch/csrc/sample.cu``); and K-sample-split, its form
for a bf16 source with no bound in bf16 arithmetic (the split route's tap
warp, with the tap FMA)."""

from __future__ import annotations

import torch

from flowdenoising_tpu_torch.ops.cuda import check_operands, launch


def check_shapes(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Raise ValueError unless u, v are (B, H, W) and src (B, H, W) or (B,
    C, H, W)."""
    if u.ndim != 3 or u.shape != v.shape:
        raise ValueError(f"u, v must both be (B, H, W); got {tuple(u.shape)} "
                         f"and {tuple(v.shape)}")
    if src.ndim not in (3, 4) or (src.shape[0],) + src.shape[-2:] != u.shape:
        raise ValueError(f"src must be (B, H, W) or (B, C, H, W) matching "
                         f"u {tuple(u.shape)}; got {tuple(src.shape)}")


def check_split(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                acc: torch.Tensor | None, weight: float | None) -> None:
    """``check_shapes``, and acc and weight given together, acc of src's
    shape."""
    check_shapes(src, u, v)
    if (acc is None) != (weight is None):
        raise ValueError("sample_split: give acc and weight together")
    if acc is not None and acc.shape != src.shape:
        raise ValueError(f"sample_split: acc {tuple(acc.shape)} must have "
                         f"src's shape {tuple(src.shape)}")


def _check_planes(what: str, u: torch.Tensor, v: torch.Tensor) -> None:
    """u and v are (H, W) planes, each contiguous, at one batch stride."""
    if u.stride() != v.stride() or u.stride()[1:] != (u.shape[2], 1):
        raise ValueError(f"{what}: u and v need contiguous (H, W) planes "
                         f"with one batch stride; got strides {u.stride()} "
                         f"and {v.stride()}")


def displace_sample(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    max_displacement: int | None) -> torch.Tensor:
    """K-sample: ``src`` (B, H, W) or (B, C, H, W) sampled at (x + u, y +
    v) with u, v (B, H, W) clamped to +-max_displacement (None: no clamp),
    bilinear, replicate borders, on the card.  All float32; src
    contiguous.  Raises for other operands.
    """
    check_shapes(src, u, v)
    f32 = (torch.float32,)
    check_operands("displace_sample", [("src", src, f32), ("u", u, f32),
                                       ("v", v, f32)], strided=("u", "v"))
    _check_planes("displace_sample", u, v)
    b, h, w = u.shape
    c = src.shape[1] if src.ndim == 4 else 1
    out = torch.empty_like(src)
    d = 0.0 if max_displacement is None else float(max_displacement)
    launch("fdt_sample", src.device, src.data_ptr(), u.data_ptr(),
           v.data_ptr(), out.data_ptr(), b, c, h, w, u.stride(0), d,
           int(max_displacement is not None))
    return out


def sample_split(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 acc: torch.Tensor | None = None,
                 weight: float | None = None) -> torch.Tensor:
    """K-sample-split: ``src`` (B, H, W) or (B, C, H, W) bfloat16 sampled
    at (x + u, y + v) with no bound on the card, in bf16 arithmetic as
    ``ops.warp.displace_sample_xla`` (bf16 pixel coordinates; every
    operation rounded to bf16 with bf16 u, v; float32 coordinates and lerps
    with float32 u, v, ``v01 - v00`` still rounded to bf16).  u, v: (B, H,
    W), both bfloat16 or both float32.

    Without ``acc`` returns the sample, bfloat16 with bf16 u, v, else
    float32.  With ``acc`` (src's shape, bfloat16) adds ``(sample *
    weight)`` rounded to bf16 into it in place (the split route's tap FMA;
    ``weight`` bf16-exact) and returns acc.  Raises for other operands.
    """
    check_split(src, u, v, acc, weight)
    check_operands("sample_split", [
        ("src", src, (torch.bfloat16,)),
        ("u", u, (torch.bfloat16, torch.float32)), ("v", v, (u.dtype,)),
        *([] if acc is None else [("acc", acc, (torch.bfloat16,))])],
        strided=("u", "v"))
    _check_planes("sample_split", u, v)
    b, h, w = u.shape
    c = src.shape[1] if src.ndim == 4 else 1
    flow_bf16 = u.dtype == torch.bfloat16
    out = None
    if acc is None:
        out = torch.empty(src.shape, device=src.device,
                          dtype=torch.bfloat16 if flow_bf16 else torch.float32)
    launch("fdt_sample_split", src.device, src.data_ptr(), u.data_ptr(),
           v.data_ptr(), int(flow_bf16), None if out is None else out.data_ptr(),
           None if acc is None else acc.data_ptr(),
           0.0 if weight is None else float(weight), b, c, h, w, u.stride(0))
    return acc if out is None else out

"""K-sample wrapper: displaced bilinear sampling (port of the Pallas kernel
``flowdenoising_tpu/ops/pallas/sample.py: _sample_kernel``; CUDA source
``flowdenoising_tpu_torch/csrc/sample.cu``)."""

from __future__ import annotations

import torch

from flowdenoising_tpu_torch.ops.cuda import LAUNCHES
from flowdenoising_tpu_torch.ops.cuda.build import check, load_library


def _check_shapes(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    if u.ndim != 3 or u.shape != v.shape:
        raise ValueError(f"u, v must both be (B, H, W); got {tuple(u.shape)} "
                         f"and {tuple(v.shape)}")
    if src.ndim not in (3, 4) or (src.shape[0],) + src.shape[-2:] != u.shape:
        raise ValueError(f"src must be (B, H, W) or (B, C, H, W) matching "
                         f"u {tuple(u.shape)}; got {tuple(src.shape)}")


def displace_sample(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    max_displacement: int | None) -> torch.Tensor:
    """Sample ``src`` (B, H, W) or (B, C, H, W) at (x + u, y + v) with u, v
    (B, H, W) clamped to +-max_displacement (None: no clamp), bilinear,
    replicate borders.

    A CPU tensor takes the plain version (``ops.warp.displace_sample_plain``),
    a CUDA tensor the kernel; any other device raises.
    """
    _check_shapes(src, u, v)
    if src.device.type == "cpu":
        # imported here: ops.warp imports this module
        from flowdenoising_tpu_torch.ops.warp import displace_sample_plain
        return displace_sample_plain(src, u, v, max_displacement)
    if src.device.type != "cuda":
        raise ValueError(f"displace_sample: no kernel for device {src.device}")
    for name, t in (("src", src), ("u", u), ("v", v)):
        if t.dtype != torch.float32 or t.device != src.device:
            raise ValueError(f"displace_sample: {name} must be float32 on "
                             f"{src.device}; got {t.dtype} on {t.device}")
    if not src.is_contiguous():
        raise ValueError("displace_sample: src must be contiguous")
    b, h, w = u.shape
    if u.stride() != v.stride() or u.stride()[1:] != (w, 1):
        raise ValueError("displace_sample: u and v need contiguous (H, W) "
                         f"planes with one batch stride; got strides "
                         f"{u.stride()} and {v.stride()}")
    c = src.shape[1] if src.ndim == 4 else 1
    out = torch.empty_like(src)
    d = 0.0 if max_displacement is None else float(max_displacement)
    rc = load_library().fdt_sample(
        src.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, c, h, w, u.stride(0), d, int(max_displacement is not None),
        torch.cuda.current_stream(src.device).cuda_stream)
    check(rc, "fdt_sample")
    LAUNCHES["sample"] += 1
    return out

"""K-polyexp and K-pyr-blur wrappers, and the planner of the float32
expansion pyramid they build (CUDA source
``flowdenoising_tpu_torch/csrc/polyexp.cu``).

The kernels replace no TPU kernel: the JAX package leaves the pyramid to
XLA, and the port ran it as plain PyTorch, which stays as their plain
version (``ops.farneback.image_pyramid``, then ``poly_expand`` a level).
``ops.farneback.polyexp_pyramid`` takes this route where ``takes`` says so
(a CUDA float32 stack, any configuration); a CPU stack and a bfloat16 one
keep the plain chain.  Each wrapper runs its kernel for a CUDA tensor and
its plain version for a CPU tensor.  The taps and constants reach a kernel by value
in the launch's arguments: nothing is copied to the device first, so the
route has no drain.
"""

from __future__ import annotations

import numpy as np
import torch

from flowdenoising_tpu_torch.config import FlowConfig
from flowdenoising_tpu_torch.ops.blur import (
    _sep_correlate, smooth_kernel_for_level)
from flowdenoising_tpu_torch.ops.cuda import LAUNCHES
from flowdenoising_tpu_torch.ops.cuda.build import check, load_library
from flowdenoising_tpu_torch.ops.resize import pyramid_sizes, resize_linear


def takes(img: torch.Tensor) -> bool:
    """Whether ``polyexp_pyramid`` builds img's pyramid in the kernels: a
    CUDA float32 stack, whatever the configuration.  Every other stack, a
    bfloat16 one (``--dtype bfloat16``) among them, takes the plain chain."""
    return img.device.type == "cuda" and img.dtype == torch.float32


def _operand(img: torch.Tensor, name: str) -> torch.Tensor:
    """img as a contiguous (B, H, W) float32 stack on the card, or raise."""
    if img.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {img.device}")
    if img.dtype != torch.float32 or img.dim() < 2:
        raise ValueError(f"{name}: expected a float32 (..., H, W) stack, got "
                         f"{img.dtype} {tuple(img.shape)}")
    return img.reshape((-1,) + tuple(img.shape[-2:])).contiguous()


def _scratch(floats: int, like: torch.Tensor) -> torch.Tensor | None:
    """``floats`` float32 values of device scratch beside ``like``, or
    None for none."""
    if not floats:
        return None
    return torch.empty(floats, dtype=torch.float32, device=like.device)


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def expand_level(img: torch.Tensor, n: int, sigma: float,
                 blur=None) -> torch.Tensor:
    """``poly_expand(img, n, sigma, channel_first=True)``, of img
    pre-blurred first with the reflect-101 taps ``blur`` where given (level
    0's 3 taps): (..., H, W) float32 -> (..., 5, H, W), contiguous.

    A CPU tensor takes the plain version; a CUDA tensor K-polyexp, one
    launch for the configuration's ``n`` of 5 and, for another, the same
    chain through device memory (``csrc/polyexp.cu``); any other device
    raises, and so do other dtypes, and blurs other than 3 taps on the
    card.
    """
    # imported here: ops.farneback imports this module
    from flowdenoising_tpu_torch.ops.farneback import (
        poly_exp_constants, poly_expand)
    if img.device.type == "cpu":
        if blur is not None:
            img = _sep_correlate(img, blur, blur, "reflect")
        return poly_expand(img, n, sigma, channel_first=True).contiguous()
    x = _operand(img, "expand_level")
    if blur is not None and len(blur) != 3:
        raise ValueError(f"expand_level: a blur of 3 taps or none, got "
                         f"{len(blur)}")
    g, xg, xxg, *igs = poly_exp_constants(n, float(sigma))
    args = np.concatenate([g, xg, xxg, np.zeros(3) if blur is None else blur,
                           igs]).astype(np.float32)
    b, h, w = x.shape
    lib = load_library()
    out = torch.empty((b, 5, h, w), dtype=torch.float32, device=x.device)
    scratch = _scratch(lib.fdt_polyexp_scratch(n, b, h, w), x)
    rc = lib.fdt_polyexp(
        x.data_ptr(), out.data_ptr(), _ptr(scratch), b, h, w, n,
        args.ctypes.data, int(blur is not None),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "fdt_polyexp")
    LAUNCHES["polyexp"] += 1
    return out.reshape(tuple(img.shape[:-2]) + (5, h, w))


def pyr_blur(img: torch.Tensor, taps) -> torch.Tensor:
    """A level's pre-blur, ``_sep_correlate(img, taps, taps, "reflect")``
    of (..., H, W) float32 at full resolution, for an odd number of taps.

    A CPU tensor takes that plain version; a CUDA tensor one launch of
    K-pyr-blur where its tile fits the taps' halo in shared memory, else
    the same two correlations through device memory; any other device
    raises, and so do other dtypes on the card.
    """
    if img.device.type == "cpu":
        return _sep_correlate(img, taps, taps, "reflect")
    x = _operand(img, "pyr_blur")
    t = np.asarray(taps, dtype=np.float64).astype(np.float32)
    if len(t) % 2 == 0:
        raise ValueError(f"pyr_blur: an odd number of taps, got {len(t)}")
    b, h, w = x.shape
    lib = load_library()
    out = torch.empty_like(x)
    scratch = _scratch(lib.fdt_pyr_blur_scratch(len(t), b, h, w), x)
    rc = lib.fdt_pyr_blur(
        x.data_ptr(), out.data_ptr(), _ptr(scratch), b, h, w, t.ctypes.data,
        len(t), torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "fdt_pyr_blur")
    LAUNCHES["pyr_blur"] += 1
    return out.reshape(img.shape)


def pyramid(img: torch.Tensor, cfg: FlowConfig) -> list[torch.Tensor]:
    """The expansion pyramid of (..., H, W) images, level by level: level
    0 is one K-polyexp with its pre-blur; a level k >= 1 is K-pyr-blur at
    full resolution, ``resize_linear`` to the level's size, and K-polyexp.
    At most one full-resolution smoothed stack is held at a time.  Bit for
    bit ``poly_expand`` of each level of ``image_pyramid``."""
    h, w = img.shape[-2], img.shape[-1]
    sizes = pyramid_sizes(h, w, cfg.clamped_levels(h, w), cfg.pyr_scale)
    n, sigma = cfg.poly_n, cfg.poly_sigma
    out = [expand_level(img, n, sigma,
                        blur=smooth_kernel_for_level(0, cfg.pyr_scale))]
    for k in range(1, len(sizes)):
        taps = smooth_kernel_for_level(k, cfg.pyr_scale)
        out.append(expand_level(resize_linear(pyr_blur(img, taps), sizes[k]),
                                n, sigma))
    return out

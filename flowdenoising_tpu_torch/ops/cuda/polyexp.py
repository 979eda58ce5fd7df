"""K-polyexp and K-pyr-blur wrappers: a pyramid level's polynomial
expansion and its pre-blur at full resolution (CUDA source
``flowdenoising_tpu_torch/csrc/polyexp.cu``).

The kernels replace no TPU kernel: the JAX package leaves the pyramid to
XLA.  ``ops.farneback.polyexp_pyramid`` runs them on a CUDA float32 stack.
The taps and constants reach a kernel by value in the launch's arguments:
nothing is copied to the device first, so the route has no drain.
"""

from __future__ import annotations

import numpy as np
import torch

from flowdenoising_tpu_torch.ops.cuda import entry, launch, planes


def _scratch(floats: int, like: torch.Tensor) -> torch.Tensor | None:
    """``floats`` float32 values of device scratch beside ``like``, or
    None for none."""
    if not floats:
        return None
    return torch.empty(floats, dtype=torch.float32, device=like.device)


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def expand_level(img: torch.Tensor, n: int, constants,
                 blur=None) -> torch.Tensor:
    """K-polyexp: the polynomial expansion of (..., H, W) float32 on the
    card, pre-blurred first with the reflect-101 taps ``blur`` where given
    (level 0's 3 taps) -> (..., 5, H, W), contiguous.  ``constants`` are
    ``ops.farneback.poly_exp_constants(n, sigma)``.  One launch for an
    ``n`` of 5 and, for another, the same chain through device memory;
    raises for other operands and blurs other than 3 taps.
    """
    x = planes("expand_level", img)
    if blur is not None and len(blur) != 3:
        raise ValueError(f"expand_level: a blur of 3 taps or none, got "
                         f"{len(blur)}")
    g, xg, xxg, *igs = constants
    args = np.concatenate([g, xg, xxg, np.zeros(3) if blur is None else blur,
                           igs]).astype(np.float32)
    b, h, w = x.shape
    out = torch.empty((b, 5, h, w), dtype=torch.float32, device=x.device)
    scratch = _scratch(entry("fdt_polyexp_scratch")(n, b, h, w), x)
    launch("fdt_polyexp", x.device, x.data_ptr(), out.data_ptr(),
           _ptr(scratch), b, h, w, n, args.ctypes.data, int(blur is not None))
    return out.reshape(tuple(img.shape[:-2]) + (5, h, w))


def pyr_blur(img: torch.Tensor, taps) -> torch.Tensor:
    """K-pyr-blur: a level's pre-blur, the separable reflect-101
    correlation of (..., H, W) float32 with an odd number of ``taps``, on
    the card at full resolution: one launch where its tile fits the taps'
    halo in shared memory, else the same two correlations through device
    memory.  Raises for other operands.
    """
    x = planes("pyr_blur", img)
    t = np.asarray(taps, dtype=np.float64).astype(np.float32)
    if len(t) % 2 == 0:
        raise ValueError(f"pyr_blur: an odd number of taps, got {len(t)}")
    b, h, w = x.shape
    out = torch.empty_like(x)
    scratch = _scratch(entry("fdt_pyr_blur_scratch")(len(t), b, h, w), x)
    launch("fdt_pyr_blur", x.device, x.data_ptr(), out.data_ptr(),
           _ptr(scratch), b, h, w, t.ctypes.data, len(t))
    return out.reshape(img.shape)

"""Three-pass Z -> Y -> X denoising pipeline.

Counterpart of ``flowdenoising_tpu/core/pipeline.py``.  Each pass filters
along axis 0 of a permuted, contiguous copy of the volume, so the in-plane
axes stay contiguous:

- Z pass: (Z, Y, X); OF planes are (Y, X).
- Y pass: (Y, Z, X); OF planes are (Z, X).
- X pass: (X, Z, Y); OF planes are (Z, Y).

The volume moves straight from one pass's layout to the next's (one
permutation per pass boundary).  The MEAN boundary pads with the INPUT
volume's mean in all three passes.  Passes run over the whole axis; an
explicit ``slab_size`` runs each pass over axis-0 slabs (with the kernel
support's halo), with results equal to the whole-axis pass.

Everything runs on the device of the input tensor; any other input (a
numpy array) is taken to ``device``, CUDA unless the caller asks for the
CPU.
"""

from __future__ import annotations

import torch

from flowdenoising_tpu_torch.config import Boundary, FilterConfig
from flowdenoising_tpu_torch.core.axis_filter import (
    gaussian_pass_padded, of_pass_padded, pad_stack)
from flowdenoising_tpu_torch.kernels import get_gaussian_kernels

# Canonical axes of each pass's layout, in Z, Y, X pass order.
_PASS_LAYOUTS = [(0, 1, 2), (1, 0, 2), (2, 0, 1)]


def slabbed_padded_pass(padded_pass_fn, padded: torch.Tensor, taps,
                        n: int, slab_size: int | None) -> torch.Tensor:
    """Run a pass over axis-0 slabs of an already padded stack
    (n + 2*ks2 slices); slabs are balanced in size and the last is padded
    by repeating the final slice, as in the JAX package."""
    ks2 = len(taps) // 2
    if slab_size is None or slab_size >= n:
        return padded_pass_fn(padded, taps)
    n_slabs = -(-n // slab_size)
    slab = -(-n // n_slabs)
    extra = n_slabs * slab - n
    if extra:
        tail = padded[-1:].expand((extra,) + tuple(padded.shape[1:]))
        padded = torch.cat([padded, tail], dim=0)
    outs = [padded_pass_fn(padded[s:s + slab + 2 * ks2], taps)
            for s in range(0, n_slabs * slab, slab)]
    return torch.cat(outs, dim=0)[:n]


def _as_volume(vol, device="cuda") -> torch.Tensor:
    """``vol`` as a float32 tensor: a tensor stays on its own device, any
    other input goes to ``device``.  Raises when that is a CUDA device and
    none is available -- never a silent fall back to the CPU."""
    if isinstance(vol, torch.Tensor):
        return vol.to(torch.float32)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available "
                           "(pass device=\"cpu\" to run the plain PyTorch "
                           "versions on the CPU)")
    return torch.as_tensor(vol, dtype=torch.float32, device=device)


def _run_passes(vol: torch.Tensor, kernels, boundary: Boundary, slab_size,
                padded_pass_fn, on_pass):
    mean_val = vol.mean() if boundary is Boundary.MEAN else None
    out = vol
    layout = (0, 1, 2)
    for i, taps in enumerate(kernels):
        target = _PASS_LAYOUTS[i]
        perm = tuple(layout.index(ax) for ax in target)
        if perm != (0, 1, 2):
            out = out.permute(perm)
        layout = target
        out = out.contiguous()
        ks2 = len(taps) // 2
        padded = pad_stack(out, ks2, boundary, mean_val)
        out = slabbed_padded_pass(padded_pass_fn, padded, taps,
                                  out.shape[0], slab_size)
        del padded
        if on_pass is not None:
            on_pass(i, out.permute(tuple(target.index(ax) for ax in (0, 1, 2))))
    return out.permute(tuple(layout.index(ax) for ax in (0, 1, 2))).contiguous()


def gaussian_denoise(vol, sigma=(2.0, 2.0, 2.0),
                     boundary: Boundary = Boundary.WRAP,
                     slab_size: int | None = None, kernels=None,
                     on_pass=None, device="cuda") -> torch.Tensor:
    """No-OF separable 3-D Gaussian denoise (reference ``-n`` path).
    ``vol`` and ``device`` as for ``denoise``."""
    kernels = get_gaussian_kernels(sigma) if kernels is None else kernels
    return _run_passes(_as_volume(vol, device), kernels, boundary, slab_size,
                       gaussian_pass_padded, on_pass)


def denoise(vol, cfg: FilterConfig = FilterConfig(), kernels=None,
            on_pass=None, device="cuda") -> torch.Tensor:
    """Full OF-compensated denoise: Z, Y, X passes of Farneback-compensated
    Gaussian accumulation (or the plain Gaussian when cfg.use_flow is
    False).

    ``vol`` is a (Z, Y, X) tensor, which is filtered on its own device, or
    an array, which is taken to ``device`` (default CUDA; raises without a
    CUDA device unless ``device="cpu"``).  Each pass runs in
    ``cfg.flow.dtype`` (the bf16 fast mode: ``dtype`` and ``precision``
    bfloat16) and returns float32, so the volume is float32 between passes
    and the result is float32 on the device the work ran on.  ``on_pass(i, volume)`` is called after pass i.
    (Resuming at a later pass, the JAX package's ``start_pass``/
    ``mean_val``, comes with checkpoints: ROADMAP A10.)
    """
    if not cfg.use_flow:
        return gaussian_denoise(vol, cfg.sigma, cfg.boundary, cfg.slab_size,
                                kernels, on_pass=on_pass, device=device)
    kernels = get_gaussian_kernels(cfg.sigma) if kernels is None else kernels

    def of_pass(padded, taps):
        return of_pass_padded(padded, taps, cfg.flow)

    return _run_passes(_as_volume(vol, device), kernels, cfg.boundary,
                       cfg.slab_size, of_pass, on_pass)

"""Where an entry point computes: a tensor on its own device, anything else
on the device the caller names (CUDA unless the caller asks for the CPU);
and whether an operation runs its hand-written kernel there or its plain
PyTorch version (``use_kernel``)."""

from __future__ import annotations

import numpy as np
import torch

from flowdenoising_tpu_torch.utils.tracing import span


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when none
    is available -- never a silent fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available "
                           "(pass device=\"cpu\" to run the plain PyTorch "
                           "versions on the CPU)")
    return device


def use_kernel(t: torch.Tensor, what: str, float32: bool = False) -> bool:
    """Whether ``what`` runs its kernel (``ops.cuda``) on ``t``, not its
    plain version: for a CUDA tensor, of dtype float32 with ``float32``;
    never for a CPU tensor.  Raises ValueError for any other device: no
    kernel, and no silent substitute."""
    if t.device.type == "cuda":
        return not float32 or t.dtype == torch.float32
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel for device {t.device}")


def as_tensors(*xs, device="cuda", dtype=torch.float32) -> tuple:
    """The inputs as tensors on one device.  Tensors stay as they are; every
    other input (a NumPy array, a list, a scalar) becomes a ``dtype`` tensor
    on the device of the first tensor among the inputs, or on ``device``
    when there is none.  None stays None."""
    target = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    out = []
    for x in xs:
        if x is not None and not isinstance(x, torch.Tensor):
            if target is None:
                target = require_device(device)
            with span("fdt.drain.input"):
                x = torch.as_tensor(np.asarray(x), dtype=dtype, device=target)
        out.append(x)
    return tuple(out)

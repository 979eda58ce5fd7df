"""K-um wrapper: the normal-equation entries M of one Farneback iteration
(port of the Pallas kernel ``flowdenoising_tpu/ops/pallas/
update_matrices.py: _um_kernel``, with its packed form; CUDA source
``flowdenoising_tpu_torch/csrc/um.cu``)."""

from __future__ import annotations

import torch

from flowdenoising_tpu_torch.ops.cuda import check_operands, launch
from flowdenoising_tpu_torch.ops.cuda.umuf import check_shapes


def update_matrices(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor,
                    max_displacement: int | None = None) -> torch.Tensor:
    """K-um: M = [G11, G12, G22, h1, h2] (B, 5, H, W) from the expansions
    r0, r1 (B, 5, H, W) of target and reference and the flow (B, 2, H, W),
    channel 0 = x, in one launch on the card.  r1 is sampled at the flow
    clamped to +-max_displacement (None: no clamp).  r0 and flow are
    float32; r1 is float32, or bfloat16 for the packed form (K-um-bf16),
    which samples it in float32.  Raises for other operands.
    """
    b, h, w = check_shapes("update_matrices", r0, r1, flow)
    check_operands("update_matrices", [
        ("r0", r0, (torch.float32,)),
        ("r1", r1, (torch.float32, torch.bfloat16)),
        ("flow", flow, (torch.float32,))], batch=b)
    m = torch.empty_like(r0)
    d = 0.0 if max_displacement is None else float(max_displacement)
    name = ("fdt_update_matrices_bf16" if r1.dtype == torch.bfloat16
            else "fdt_update_matrices")
    launch(name, r0.device, r0.data_ptr(), r1.data_ptr(), flow.data_ptr(),
           m.data_ptr(), b, h, w, d, int(max_displacement is not None))
    return m

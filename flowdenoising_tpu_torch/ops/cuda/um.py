"""K-um wrapper: the normal-equation entries M of one Farneback iteration
(port of the Pallas kernel ``flowdenoising_tpu/ops/pallas/
update_matrices.py: _um_kernel``, with its packed form; CUDA source
``flowdenoising_tpu_torch/csrc/um.cu``)."""

from __future__ import annotations

import torch

from flowdenoising_tpu_torch.ops.cuda import LAUNCHES
from flowdenoising_tpu_torch.ops.cuda.build import check, load_library


def update_matrices(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor,
                    max_displacement: int | None = None) -> torch.Tensor:
    """M = [G11, G12, G22, h1, h2] (B, 5, H, W) from the expansions r0, r1
    (B, 5, H, W) of target and reference and the flow (B, 2, H, W),
    channel 0 = x.  r1 is sampled at the flow clamped to
    +-max_displacement (None: no clamp).  r0 and flow are float32; r1 is
    float32, or bfloat16 for the packed form (K-um-bf16), which samples it
    in float32.

    A CPU tensor takes the plain version (``ops.farneback.
    update_matrices_plain``), a CUDA tensor one kernel launch; any other
    device raises.
    """
    b, _, h, w = flow.shape
    if (r0.shape != (b, 5, h, w) or r1.shape != r0.shape
            or flow.shape != (b, 2, h, w)):
        raise ValueError(f"update_matrices: expected r0, r1 (B, 5, H, W) and "
                         f"flow (B, 2, H, W); got {tuple(r0.shape)}, "
                         f"{tuple(r1.shape)}, {tuple(flow.shape)}")
    if r0.device.type == "cpu":
        # imported here: ops.farneback imports this module
        from flowdenoising_tpu_torch.ops.farneback import update_matrices_plain
        return update_matrices_plain(r0, r1, flow, max_displacement)
    if r0.device.type != "cuda":
        raise ValueError(f"update_matrices: no kernel for device {r0.device}")
    for name, t, dtypes in (("r0", r0, (torch.float32,)),
                            ("r1", r1, (torch.float32, torch.bfloat16)),
                            ("flow", flow, (torch.float32,))):
        if (t.dtype not in dtypes or t.device != r0.device
                or not t.is_contiguous()):
            raise ValueError(f"update_matrices: {name} must be contiguous "
                             f"{' or '.join(map(str, dtypes))} on {r0.device}")
    if b > 65535:
        raise ValueError(f"update_matrices: batch {b} exceeds the grid's 65535")
    m = torch.empty_like(r0)
    d = 0.0 if max_displacement is None else float(max_displacement)
    packed = r1.dtype == torch.bfloat16
    form = "um_bf16" if packed else "um"
    entry = "fdt_update_matrices_bf16" if packed else "fdt_update_matrices"
    rc = getattr(load_library(), entry)(
        r0.data_ptr(), r1.data_ptr(), flow.data_ptr(), m.data_ptr(), b, h, w,
        d, int(max_displacement is not None),
        torch.cuda.current_stream(r0.device).cuda_stream)
    check(rc, entry)
    LAUNCHES[form] += 1
    return m

"""K-compose wrapper: one tap of the composed-flow pass (port of the Pallas
kernel ``flowdenoising_tpu/ops/pallas/compose.py: _compose_kernel``, with
its packed form; CUDA source ``flowdenoising_tpu_torch/csrc/compose.cu``),
and its plain PyTorch version."""

from __future__ import annotations

import numpy as np
import torch

from flowdenoising_tpu_torch.ops.cuda import LAUNCHES
from flowdenoising_tpu_torch.ops.cuda.build import check, load_library
from flowdenoising_tpu_torch.ops.warp import displace_sample_plain


def compose_tap_plain(link: torch.Tensor, flow: torch.Tensor,
                      neighbor: torch.Tensor, acc: torch.Tensor,
                      weight: float, d: int | None, round_carry: bool = False):
    """Plain version of K-compose: ``flow' = flow + warp(link, flow)`` and
    ``acc' = acc + warp(neighbor, flow') * weight``.

    link, flow: (B, 2, H, W), channel 0 = x; neighbor, acc: (B, H, W).  The
    warps sample at the flow clamped to +-d (None: no clamp); flow' is the
    unclamped sum.  link and neighbor may be bfloat16 (the packed form):
    they are sampled in float32.  ``round_carry`` rounds flow' and acc' to
    bfloat16 (a bf16 pass's carry) after the neighbour was sampled at the
    unrounded flow'.  Returns new float32 tensors (flow', acc').
    """
    flow = flow + displace_sample_plain(link, flow[:, 0], flow[:, 1], d)
    warped = displace_sample_plain(neighbor, flow[:, 0], flow[:, 1], d)
    acc = acc + warped * weight
    if round_carry:
        flow = flow.to(torch.bfloat16).float()
        acc = acc.to(torch.bfloat16).float()
    return flow, acc


def compose_tap(link: torch.Tensor, flow: torch.Tensor,
                neighbor: torch.Tensor, acc: torch.Tensor, weight: float,
                d: int | None, link_start: int, nb_start: int,
                round_carry: bool = False):
    """One compose tap, updating ``flow`` and ``acc`` in place.

    link: the whole stack of adjacent flows (B_link, 2, H, W); neighbor:
    the whole padded stack (B_nb, H, W).  The tap reads their planes
    ``link_start .. link_start + B - 1`` and ``nb_start .. nb_start + B -
    1`` for flow (B, 2, H, W) and acc (B, H, W).  flow and acc are float32;
    link and neighbor are both float32, or both bfloat16 for the packed
    form (K-compose-bf16, ``--precision bfloat16``).  ``weight`` is rounded
    to float32; ``round_carry`` rounds the stored flow and acc to bfloat16
    (``--dtype bfloat16``).  Returns (flow, acc).

    A CPU tensor takes the plain version (``compose_tap_plain``), a CUDA
    tensor the kernel; any other device raises.
    """
    b, _, h, w = flow.shape
    if (flow.shape != (b, 2, h, w) or link.ndim != 4
            or link.shape[1:] != (2, h, w) or acc.shape != (b, h, w)
            or neighbor.ndim != 3 or neighbor.shape[1:] != (h, w)):
        raise ValueError(
            f"compose_tap: expected link (B_link, 2, H, W), flow (B, 2, H, "
            f"W), neighbor (B_nb, H, W), acc (B, H, W); got "
            f"{tuple(link.shape)}, {tuple(flow.shape)}, "
            f"{tuple(neighbor.shape)}, {tuple(acc.shape)}")
    for name, start, stack in (("link_start", link_start, link),
                               ("nb_start", nb_start, neighbor)):
        if not 0 <= start <= stack.shape[0] - b:
            raise ValueError(f"compose_tap: {name} {start} out of range for "
                             f"{b} planes of a stack of {stack.shape[0]}")
    weight = float(np.float32(weight))
    if flow.device.type == "cpu":
        f2, a2 = compose_tap_plain(link[link_start:link_start + b], flow,
                                   neighbor[nb_start:nb_start + b], acc,
                                   weight, d, round_carry)
        return flow.copy_(f2), acc.copy_(a2)
    if flow.device.type != "cuda":
        raise ValueError(f"compose_tap: no kernel for device {flow.device}")
    src = link.dtype if link.dtype == torch.bfloat16 else torch.float32
    for name, t, dtype in (("link", link, src), ("flow", flow, torch.float32),
                           ("neighbor", neighbor, src),
                           ("acc", acc, torch.float32)):
        if (t.dtype != dtype or t.device != flow.device
                or not t.is_contiguous()):
            raise ValueError(f"compose_tap: {name} must be contiguous "
                             f"{dtype} on {flow.device}")
    packed = src == torch.bfloat16
    form = "compose_bf16" if packed else "compose"
    entry = "fdt_compose_step_bf16" if packed else "fdt_compose_step"
    dval = 0.0 if d is None else float(d)
    rc = getattr(load_library(), entry)(
        link.data_ptr(), neighbor.data_ptr(), flow.data_ptr(), acc.data_ptr(),
        b, h, w, link_start, nb_start, weight, dval, int(d is not None),
        int(round_carry), torch.cuda.current_stream(flow.device).cuda_stream)
    check(rc, entry)
    LAUNCHES[form] += 1
    return flow, acc

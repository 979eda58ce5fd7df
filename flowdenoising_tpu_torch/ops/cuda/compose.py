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


def compose_run_plain(adj_fwd: torch.Tensor, adj_bwd: torch.Tensor | None,
                      neighbor: torch.Tensor, acc: torch.Tensor, weights,
                      d: int | None, round_carry: bool = False) -> torch.Tensor:
    """Plain version of K-compose-run: the taps of one compose pass as a
    chain of ``compose_tap_plain`` steps, in the pass's order.

    ``weights`` holds 2*ks2 tap weights, offsets -1 .. -ks2 then +1 ..
    +ks2.  Starting from acc (the center tap), the backward run composes
    flow from zero through the links ``adj_bwd[ks2-j+b]`` and adds
    neighbour ``ks2-j+b`` at each offset -j; the flow goes back to zero;
    the forward run takes links ``adj_fwd[ks2+j-1+b]`` and neighbours
    ``ks2+j+b``.  ``adj_bwd`` None stands for ``-adj_fwd`` (symmetric
    adjacent flows).  Returns the new float32 accumulator.
    """
    ks2 = len(weights) // 2
    n = acc.shape[0]
    for sign in (-1, +1):
        f = torch.zeros((n, 2) + tuple(acc.shape[1:]), device=acc.device)
        for j in range(1, ks2 + 1):
            start = ks2 + sign * j
            if sign > 0:
                link = adj_fwd[start - 1:start - 1 + n]
            else:
                link = (-adj_fwd[start:start + n] if adj_bwd is None
                        else adj_bwd[start:start + n])
            f, acc = compose_tap_plain(link, f, neighbor[start:start + n], acc,
                                       weights[ks2 * (sign > 0) + j - 1], d,
                                       round_carry)
    return acc


def compose_run(adj_fwd: torch.Tensor, adj_bwd: torch.Tensor | None,
                neighbor: torch.Tensor, acc: torch.Tensor, weights,
                d: int | None, round_carry: bool = False) -> torch.Tensor:
    """One whole compose pass (K-compose-run), updating ``acc`` in place.

    adj_fwd, adj_bwd: the adjacent flows (n + 2*ks2 - 1, 2, H, W) of the
    padded stack, ``adj_bwd`` None for symmetric adjacent flows (the
    kernel reads adj_fwd with a sign instead of a negated copy); neighbor:
    the padded stack (n + 2*ks2, H, W); acc: (n, H, W) float32, the
    center tap on entry; ``weights``: 2*ks2 tap weights (offsets -1 ..
    -ks2, then +1 .. +ks2), rounded to float32.  The links and neighbor
    are all float32, or all bfloat16 for the packed form
    (K-compose-run-bf16, ``--precision bfloat16``); ``round_carry`` rounds
    the flow and accumulator after every tap to bfloat16 (``--dtype
    bfloat16``).  Returns acc.

    A CPU tensor takes the plain version (``compose_run_plain``), a CUDA
    tensor the kernel; any other device raises.
    """
    weights = [float(np.float32(w)) for w in weights]
    ks2 = len(weights) // 2
    n = acc.shape[0]
    links = [("adj_fwd", adj_fwd)] + ([] if adj_bwd is None
                                      else [("adj_bwd", adj_bwd)])
    h, w = acc.shape[1:] if acc.ndim == 3 else (None, None)
    bad = (len(weights) % 2 or acc.ndim != 3
           or neighbor.shape != (n + 2 * ks2, h, w)
           or any(t.shape != (n + 2 * ks2 - 1, 2, h, w) for _, t in links))
    if bad:
        raise ValueError(
            f"compose_run: expected 2*ks2 weights, acc (n, H, W), neighbor "
            f"(n + 2*ks2, H, W), links (n + 2*ks2 - 1, 2, H, W); got "
            f"{len(weights)} weights, acc {tuple(acc.shape)}, neighbor "
            f"{tuple(neighbor.shape)}, links "
            f"{[tuple(t.shape) for _, t in links]}")
    if acc.device.type == "cpu":
        return acc.copy_(compose_run_plain(adj_fwd, adj_bwd, neighbor, acc,
                                           weights, d, round_carry))
    if acc.device.type != "cuda":
        raise ValueError(f"compose_run: no kernel for device {acc.device}")
    src = neighbor.dtype if neighbor.dtype == torch.bfloat16 else torch.float32
    for name, t, dtype in (*((nm, t, src) for nm, t in links),
                           ("neighbor", neighbor, src),
                           ("acc", acc, torch.float32)):
        if t.dtype != dtype or t.device != acc.device or not t.is_contiguous():
            raise ValueError(f"compose_run: {name} must be contiguous {dtype} "
                             f"on {acc.device}")
    if ks2 == 0:
        return acc
    packed = src == torch.bfloat16
    form = "compose_run_bf16" if packed else "compose_run"
    entry = "fdt_" + form
    # from pinned memory, so the copy does not wait for the stream to drain
    wts = torch.tensor(weights, dtype=torch.float32).pin_memory().to(
        acc.device, non_blocking=True)
    bwd = adj_fwd if adj_bwd is None else adj_bwd
    rc = getattr(load_library(), entry)(
        bwd.data_ptr(), adj_fwd.data_ptr(), neighbor.data_ptr(),
        acc.data_ptr(), wts.data_ptr(), n, h, w, ks2,
        -1.0 if adj_bwd is None else 1.0, 0.0 if d is None else float(d),
        int(d is not None), int(round_carry),
        torch.cuda.current_stream(acc.device).cuda_stream)
    check(rc, entry)
    LAUNCHES[form] += 1
    return acc

"""The composed-flow pass's taps: ``compose_tap``, ``compose_run`` and
``compose_run_split`` run K-compose (one tap), K-compose-run (a whole pass)
and K-compose-run-split (the split route's pass, bf16 with no bound) on a
CUDA tensor (``ops/cuda/compose.py``) and their plain versions, kept here,
on a CPU tensor."""

from __future__ import annotations

import numpy as np
import torch

from flowdenoising_tpu_torch.ops.cuda import compose as kernel
from flowdenoising_tpu_torch.ops.device import use_kernel
from flowdenoising_tpu_torch.ops.warp import (
    displace_sample_plain, displace_sample_xla)


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
    """One compose tap, updating ``flow`` and ``acc`` in place: K-compose
    (``ops.cuda.compose.compose_tap``, whose docstring gives the operands)
    or ``compose_tap_plain`` of the tap's planes.  ``weight`` is rounded to
    float32.  Returns (flow, acc).
    """
    weight = float(np.float32(weight))
    if use_kernel(flow, "compose_tap"):
        return kernel.compose_tap(link, flow, neighbor, acc, weight, d,
                                  link_start, nb_start, round_carry)
    b = kernel.check_tap(link, flow, neighbor, acc, link_start, nb_start)
    f2, a2 = compose_tap_plain(link[link_start:link_start + b], flow,
                               neighbor[nb_start:nb_start + b], acc, weight,
                               d, round_carry)
    return flow.copy_(f2), acc.copy_(a2)


def _taps(adj_fwd: torch.Tensor, adj_bwd: torch.Tensor | None,
          neighbor: torch.Tensor, n: int, weights):
    """A compose pass's taps in its order, offsets -1 .. -ks2, then +1 ..
    +ks2: (j, link, neighbour planes, weight) of the tap at offset +-j.
    The backward run takes links ``adj_bwd[ks2-j+b]`` (``-adj_fwd`` where
    adj_bwd is None) and neighbours ``ks2-j+b``; the forward run links
    ``adj_fwd[ks2+j-1+b]`` and neighbours ``ks2+j+b``."""
    ks2 = len(weights) // 2
    for sign in (-1, +1):
        for j in range(1, ks2 + 1):
            start = ks2 + sign * j
            if sign > 0:
                link = adj_fwd[start - 1:start - 1 + n]
            else:
                link = (-adj_fwd[start:start + n] if adj_bwd is None
                        else adj_bwd[start:start + n])
            yield (j, link, neighbor[start:start + n],
                   weights[ks2 * (sign > 0) + j - 1])


def compose_run_plain(adj_fwd: torch.Tensor, adj_bwd: torch.Tensor | None,
                      neighbor: torch.Tensor, acc: torch.Tensor, weights,
                      d: int | None, round_carry: bool = False) -> torch.Tensor:
    """Plain version of K-compose-run: the taps of one compose pass as a
    chain of ``compose_tap_plain`` steps, in the pass's order.

    ``weights`` holds 2*ks2 tap weights, offsets -1 .. -ks2 then +1 ..
    +ks2.  Starting from acc (the center tap), each run composes the flow
    from zero through its links and adds its neighbours (``_taps``).
    ``adj_bwd`` None stands for ``-adj_fwd`` (symmetric adjacent flows).
    Returns the new float32 accumulator.
    """
    for j, link, nb, weight in _taps(adj_fwd, adj_bwd, neighbor, acc.shape[0],
                                     weights):
        if j == 1:    # each run composes the flow from zero
            f = torch.zeros(link.shape, device=acc.device)
        f, acc = compose_tap_plain(link, f, nb, acc, weight, d, round_carry)
    return acc


def compose_run(adj_fwd: torch.Tensor, adj_bwd: torch.Tensor | None,
                neighbor: torch.Tensor, acc: torch.Tensor, weights,
                d: int | None, round_carry: bool = False) -> torch.Tensor:
    """One whole compose pass, updating ``acc`` in place: K-compose-run
    (``ops.cuda.compose.compose_run``, whose docstring gives the operands)
    or ``compose_run_plain``.  ``weights`` are rounded to float32.
    Returns acc.
    """
    weights = [float(np.float32(w)) for w in weights]
    if use_kernel(acc, "compose_run"):
        return kernel.compose_run(adj_fwd, adj_bwd, neighbor, acc, weights, d,
                                  round_carry)
    kernel.check_run("compose_run", adj_fwd, adj_bwd, neighbor, acc, weights)
    return acc.copy_(compose_run_plain(adj_fwd, adj_bwd, neighbor, acc,
                                       weights, d, round_carry))


def compose_chain_plain(adj_fwd: torch.Tensor, adj_bwd: torch.Tensor | None,
                        neighbor: torch.Tensor, acc: torch.Tensor,
                        weights) -> torch.Tensor:
    """Plain version of K-compose-run-split: the compose pass with no bound
    as the JAX package's tap scan runs it when it has no fused step
    (``flowdenoising_tpu/core/axis_filter.py: _of_pass_composed``,
    ``body_of``), in the pass dtype.

    Per tap, F = (F + warp(link, F)) and acc += (warp(neighbour, F) * w),
    each warp the exact gather (``displace_sample_xla``) and each result
    rounded to the pass dtype, the carry F starting from zeros in the pass
    dtype in each run; the planes and the order are ``compose_run_plain``'s
    (``adj_bwd`` None stands for ``-adj_fwd``).  adj_*: (n + 2*ks2 - 1, 2,
    H, W), neighbor (n + 2*ks2, H, W) and acc (n, H, W), the center tap on
    entry, all in the pass dtype; ``weights``: 2*ks2 tap weights in that
    dtype.  Updates acc in place and returns it."""
    dtype = acc.dtype
    for j, link, nb, weight in _taps(adj_fwd, adj_bwd, neighbor, acc.shape[0],
                                     weights):
        if j == 1:
            flow = torch.zeros(link.shape, dtype=dtype, device=acc.device)
        flow = (flow + displace_sample_xla(link, flow[:, 0], flow[:, 1])
                ).to(dtype)
        warped = displace_sample_xla(nb, flow[:, 0], flow[:, 1])
        acc.add_((warped * weight).to(dtype))
    return acc


def compose_run_split(adj_fwd: torch.Tensor, adj_bwd: torch.Tensor | None,
                      neighbor: torch.Tensor, acc: torch.Tensor,
                      weights) -> torch.Tensor:
    """One compose pass of the split route, updating ``acc`` in place:
    K-compose-run-split (``ops.cuda.compose.compose_run_split``, whose
    docstring gives the operands) or ``compose_chain_plain``, bit for bit
    the same.  Returns acc.
    """
    if use_kernel(acc, "compose_run_split"):
        return kernel.compose_run_split(adj_fwd, adj_bwd, neighbor, acc,
                                        weights)
    kernel.check_run("compose_run_split", adj_fwd, adj_bwd, neighbor, acc,
                     weights)
    return compose_chain_plain(adj_fwd, adj_bwd, neighbor, acc, weights)

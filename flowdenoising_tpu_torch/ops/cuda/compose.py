"""K-compose wrapper: one tap of the composed-flow pass (port of the Pallas
kernel ``flowdenoising_tpu/ops/pallas/compose.py: _compose_kernel``, with
its packed form; CUDA source ``flowdenoising_tpu_torch/csrc/compose.cu``);
K-compose-run, a whole pass in one launch; K-compose-run-split, the split
route's pass (bf16 arithmetic with no bound)."""

from __future__ import annotations

import torch

from flowdenoising_tpu_torch.ops.cuda import check_operands, launch


def check_tap(link: torch.Tensor, flow: torch.Tensor, neighbor: torch.Tensor,
              acc: torch.Tensor, link_start: int, nb_start: int) -> int:
    """A compose tap's B; raises ValueError unless the shapes and the
    starts are a tap's."""
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
    return b


def check_run(what: str, adj_fwd: torch.Tensor, adj_bwd: torch.Tensor | None,
              neighbor: torch.Tensor, acc: torch.Tensor, weights) -> int:
    """A compose pass's ks2; raises ValueError unless the shapes are a
    pass's."""
    ks2 = len(weights) // 2
    n = acc.shape[0]
    h, w = acc.shape[1:] if acc.ndim == 3 else (None, None)
    links = [adj_fwd] + ([] if adj_bwd is None else [adj_bwd])
    if (len(weights) % 2 or acc.ndim != 3
            or neighbor.shape != (n + 2 * ks2, h, w)
            or any(t.shape != (n + 2 * ks2 - 1, 2, h, w) for t in links)):
        raise ValueError(
            f"{what}: expected 2*ks2 weights, acc (n, H, W), neighbor "
            f"(n + 2*ks2, H, W), links (n + 2*ks2 - 1, 2, H, W); got "
            f"{len(weights)} weights, acc {tuple(acc.shape)}, neighbor "
            f"{tuple(neighbor.shape)}, links {[tuple(t.shape) for t in links]}")
    return ks2


def _run(what: str, name: str, adj_fwd: torch.Tensor,
         adj_bwd: torch.Tensor | None, neighbor: torch.Tensor,
         acc: torch.Tensor, weights, src: tuple, acc_dtype: tuple,
         *args) -> torch.Tensor:
    """Check a compose pass's operands (links and neighbor of ``src``, acc
    of ``acc_dtype``) and launch ``name`` over it with ``args`` after the
    common ones; the weights are copied from pinned memory, so that the copy
    does not wait for the stream to drain."""
    ks2 = check_run(what, adj_fwd, adj_bwd, neighbor, acc, weights)
    links = [("adj_fwd", adj_fwd)] + ([] if adj_bwd is None
                                      else [("adj_bwd", adj_bwd)])
    check_operands(what, [("acc", acc, acc_dtype), ("neighbor", neighbor, src),
                          *((nm, t, src) for nm, t in links)])
    if ks2 == 0:
        return acc
    wts = torch.tensor([float(w) for w in weights], dtype=torch.float32
                       ).pin_memory().to(acc.device, non_blocking=True)
    bwd = adj_fwd if adj_bwd is None else adj_bwd
    n, h, w = acc.shape
    launch(name, acc.device, bwd.data_ptr(), adj_fwd.data_ptr(),
           neighbor.data_ptr(), acc.data_ptr(), wts.data_ptr(), n, h, w, ks2,
           -1.0 if adj_bwd is None else 1.0, *args)
    return acc


def compose_tap(link: torch.Tensor, flow: torch.Tensor,
                neighbor: torch.Tensor, acc: torch.Tensor, weight: float,
                d: int | None, link_start: int, nb_start: int,
                round_carry: bool = False):
    """K-compose: one compose tap on the card, updating ``flow`` and
    ``acc`` in place.

    link: the whole stack of adjacent flows (B_link, 2, H, W); neighbor:
    the whole padded stack (B_nb, H, W).  The tap reads their planes
    ``link_start .. link_start + B - 1`` and ``nb_start .. nb_start + B -
    1`` for flow (B, 2, H, W) and acc (B, H, W).  flow and acc are float32;
    link and neighbor are both float32, or both bfloat16 for the packed
    form (K-compose-bf16, ``--precision bfloat16``).  ``weight`` is rounded
    to float32; ``round_carry`` rounds the stored flow and acc to bfloat16
    (``--dtype bfloat16``).  Returns (flow, acc); raises for other
    operands.
    """
    b = check_tap(link, flow, neighbor, acc, link_start, nb_start)
    src = (link.dtype,) if link.dtype == torch.bfloat16 else (torch.float32,)
    check_operands("compose_tap", [
        ("flow", flow, (torch.float32,)), ("link", link, src),
        ("neighbor", neighbor, src), ("acc", acc, (torch.float32,))])
    name = ("fdt_compose_step_bf16" if link.dtype == torch.bfloat16
            else "fdt_compose_step")
    h, w = flow.shape[2:]
    launch(name, flow.device, link.data_ptr(), neighbor.data_ptr(),
           flow.data_ptr(), acc.data_ptr(), b, h, w, link_start, nb_start,
           float(weight), 0.0 if d is None else float(d), int(d is not None),
           int(round_carry))
    return flow, acc


def compose_run(adj_fwd: torch.Tensor, adj_bwd: torch.Tensor | None,
                neighbor: torch.Tensor, acc: torch.Tensor, weights,
                d: int | None, round_carry: bool = False) -> torch.Tensor:
    """K-compose-run: one whole compose pass in one launch on the card,
    updating ``acc`` in place.

    adj_fwd, adj_bwd: the adjacent flows (n + 2*ks2 - 1, 2, H, W) of the
    padded stack, ``adj_bwd`` None for symmetric adjacent flows (the
    kernel reads adj_fwd with a sign instead of a negated copy); neighbor:
    the padded stack (n + 2*ks2, H, W); acc: (n, H, W) float32, the
    center tap on entry; ``weights``: 2*ks2 tap weights (offsets -1 ..
    -ks2, then +1 .. +ks2), rounded to float32.  The links and neighbor
    are all float32, or all bfloat16 for the packed form
    (K-compose-run-bf16, ``--precision bfloat16``); ``round_carry`` rounds
    the flow and accumulator after every tap to bfloat16 (``--dtype
    bfloat16``).  Returns acc; raises for other operands.
    """
    bf16 = neighbor.dtype == torch.bfloat16
    return _run("compose_run", "fdt_compose_run_bf16" if bf16 else
                "fdt_compose_run", adj_fwd, adj_bwd, neighbor, acc, weights,
                (neighbor.dtype,) if bf16 else (torch.float32,),
                (torch.float32,), 0.0 if d is None else float(d),
                int(d is not None), int(round_carry))


def compose_run_split(adj_fwd: torch.Tensor, adj_bwd: torch.Tensor | None,
                      neighbor: torch.Tensor, acc: torch.Tensor,
                      weights) -> torch.Tensor:
    """K-compose-run-split: one compose pass of the split route in one
    launch on the card, updating ``acc`` in place, bit for bit
    ``ops.compose.compose_chain_plain``.

    adj_fwd, adj_bwd: the adjacent flows (n + 2*ks2 - 1, 2, H, W), bfloat16,
    ``adj_bwd`` None for symmetric adjacent flows (the kernel reads adj_fwd
    with a sign instead of a negated copy); neighbor: the padded stack (n +
    2*ks2, H, W), bfloat16; acc: (n, H, W) bfloat16, the center tap on
    entry; ``weights``: 2*ks2 tap weights (offsets -1 .. -ks2, then +1 ..
    +ks2), each bf16-exact.  Returns acc; raises for other operands.
    """
    bf16 = (torch.bfloat16,)
    return _run("compose_run_split", "fdt_compose_run_split", adj_fwd, adj_bwd,
                neighbor, acc, weights, bf16, bf16)

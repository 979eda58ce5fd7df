"""K-umuf wrapper: chained fused Farneback iterations at one pyramid level
(port of the Pallas kernel ``flowdenoising_tpu/ops/pallas/umuf.py:
_umuf_kernel``, with its packed form; CUDA source
``flowdenoising_tpu_torch/csrc/umuf.cu``).

``plan_umuf`` is the launch planner: plain Python, no CUDA, so the CPU
tests hold its choices to the shared-memory limits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flowdenoising_tpu_torch.ops.cuda import check_operands, launch

# Shared memory of one H100 SM, what one block may take, and what the card
# reserves a block: two blocks of at most SMEM_TWO_BLOCKS fit on an SM.
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
SMEM_TWO_BLOCKS = SMEM_PER_SM // 2 - 1024
# Output tiles (rows, columns) the planner tries, largest first.
TILES = ((32, 64), (32, 32), (16, 32), (16, 16), (8, 16), (8, 8), (4, 4))
# The most phase-1 work a plan may do per output pixel, as a multiple of
# the tile's: the context of k fused iterations is recomputed by the
# neighbouring blocks, and past twice the tile's work that costs more than
# the device-memory round trips the fusion saves.
MAX_PHASE1_WORK = 2.0


@dataclasses.dataclass(frozen=True)
class UmufPlan:
    """How ``umuf_iterate`` runs ``iters`` iterations: ``launches`` holds
    the iterations of each launch (k, ..., k, rest); each block owns a
    ``tile_y`` x ``tile_x`` output tile with ``threads`` threads and
    ``smem`` bytes of shared memory (at the first launch's k);
    ``phase1_work`` is phase 1's pixels per output pixel and iteration."""
    tile_y: int
    tile_x: int
    per_launch: int
    launches: tuple[int, ...]
    threads: int
    smem: int
    phase1_work: float


def umuf_smem_bytes(h: int, w: int, winsize: int, k: int, tile_y: int,
                    tile_x: int) -> int:
    """Shared memory of one K-umuf block (``csrc/umuf.cu``:
    ``umuf_smem_bytes``): M, 5 planes of (RH + r) x SW floats, and for k > 1
    the flow carry, 2 planes of RH x SW, where RH x SW is the tile grown by
    k*r on every side, clamped to the plane."""
    r = winsize // 2
    rh = min(tile_y + 2 * k * r, h)
    sw = min(tile_x + 2 * k * r, w)
    return 4 * (5 * (rh + r) * sw + (2 * rh * sw if k > 1 else 0))


def _phase1_work(h: int, w: int, r: int, k: int, tile_y: int,
                 tile_x: int) -> float:
    """Phase-1 pixels per output pixel and iteration of an interior tile:
    iteration j computes M on the tile grown by (k - j) * r."""
    area = sum(min(tile_y + 2 * (k - j) * r, h) * min(tile_x + 2 * (k - j) * r, w)
               for j in range(k))
    return area / (k * tile_y * tile_x)


def plan_umuf(h: int, w: int, winsize: int, iters: int,
              per_launch: int | None = None,
              smem_limit: int = SMEM_TWO_BLOCKS) -> UmufPlan:
    """The tile, the iterations per launch k and the shared memory of K-umuf
    (and of K-umuf-split, which has its layout) on (h, w) planes.

    Without ``per_launch``: the largest k <= iters for which a tile of
    ``TILES`` fits two blocks on an SM while phase 1 does at most
    ``MAX_PHASE1_WORK`` times the tile's pixels, with the largest such tile;
    else k = 1 with the largest tile that fits.  ``per_launch`` fixes k (the
    largest tile that fits).  ``smem_limit`` replaces the two blocks' share
    of an SM (``SMEM_PER_BLOCK``: one block an SM).  The output is the same
    bit for bit for every plan.  Raises ValueError when no tile fits at k =
    1: the winsize's window halo is too wide for the kernel's shared memory.
    """
    if iters < 0 or winsize < 1 or h < 1 or w < 1:
        raise ValueError(f"plan_umuf: bad arguments h={h} w={w} "
                         f"winsize={winsize} iters={iters}")
    r = winsize // 2
    if per_launch is not None:
        if not 1 <= per_launch <= max(iters, 1):
            raise ValueError(f"plan_umuf: per_launch {per_launch} not in "
                             f"1..{max(iters, 1)}")
        ks, limit = [per_launch], None
    else:
        ks, limit = range(max(iters, 1), 0, -1), MAX_PHASE1_WORK
    for k in ks:
        for ty, tx in TILES:
            ty, tx = min(ty, h), min(tx, w)
            smem = umuf_smem_bytes(h, w, winsize, k, ty, tx)
            work = _phase1_work(h, w, r, k, ty, tx)
            if smem > smem_limit or (limit and k > 1 and work > limit):
                continue
            launches = (k,) * (iters // k) + ((iters % k,) if iters % k else ())
            return UmufPlan(ty, tx, k, launches, 512 if ty * tx >= 2048 else 256,
                            smem, work)
    raise ValueError(f"umuf_iterate: winsize {winsize} needs a window halo of "
                     f"{r} px, wider than the kernel's shared-memory tile "
                     "holds")


def check_shapes(what: str, r0: torch.Tensor, r1: torch.Tensor,
                 flow: torch.Tensor) -> tuple[int, int, int]:
    """(B, H, W) of a Farneback iteration's operands, r0 and r1 (B, 5, H,
    W) and flow (B, 2, H, W); raises ValueError for other shapes."""
    b, _, h, w = flow.shape
    if (r0.shape != (b, 5, h, w) or r1.shape != r0.shape
            or flow.shape != (b, 2, h, w)):
        raise ValueError(f"{what}: expected r0, r1 (B, 5, H, W) and flow "
                         f"(B, 2, H, W); got {tuple(r0.shape)}, "
                         f"{tuple(r1.shape)}, {tuple(flow.shape)}")
    return b, h, w


def umuf_iterate(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor,
                 iters: int, d: int | None, winsize: int,
                 per_launch: int | None = None,
                 ramp_bf16: bool = False) -> torch.Tensor:
    """K-umuf: ``iters`` Farneback iterations ``flow <- update_flow(
    update_matrices(r0, r1, flow, d), winsize)`` on the card, as
    ``plan_umuf`` plans them, ``per_launch`` iterations a launch if given.

    r0, r1: (B, 5, H, W) polynomial expansions of target and reference;
    flow: (B, 2, H, W), channel 0 = x.  r0 and flow are float32; r1 is
    float32, or bfloat16 for the packed form (K-umuf-bf16, ``--precision
    bfloat16``), which samples it in float32.  ``d`` bounds the sampling
    displacement (None: no clamp).  ``ramp_bf16`` rounds the border ramp to
    bfloat16 (a bf16 pass's tiny levels).  Returns a new (B, 2, H, W) flow.
    Raises for other operands, and for a winsize whose window halo does not
    fit the kernel's shared memory.
    """
    b, h, w = check_shapes("umuf_iterate", r0, r1, flow)
    check_operands("umuf_iterate", [
        ("r0", r0, (torch.float32,)),
        ("r1", r1, (torch.float32, torch.bfloat16)),
        ("flow", flow, (torch.float32,))], batch=b)
    plan = plan_umuf(h, w, winsize, iters, per_launch)
    name = "fdt_umuf_bf16" if r1.dtype == torch.bfloat16 else "fdt_umuf"
    clamp = int(d is not None)
    dval = 0.0 if d is None else float(d)
    inv_ws2 = float(np.float32(1.0 / float(winsize * winsize)))
    bufs = [torch.empty_like(flow), torch.empty_like(flow)]
    cur = flow
    for i, k in enumerate(plan.launches):
        nxt = bufs[i % 2]
        launch(name, r0.device, r0.data_ptr(), r1.data_ptr(), cur.data_ptr(),
               nxt.data_ptr(), b, h, w, dval, clamp, int(ramp_bf16), winsize,
               inv_ws2, k, plan.tile_y, plan.tile_x, plan.threads)
        cur = nxt
    return cur

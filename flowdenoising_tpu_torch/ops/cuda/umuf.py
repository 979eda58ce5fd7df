"""K-umuf wrapper: chained fused Farneback iterations at one pyramid level
(port of the Pallas kernel ``flowdenoising_tpu/ops/pallas/umuf.py:
_umuf_kernel``, with its packed form; CUDA source
``flowdenoising_tpu_torch/csrc/umuf.cu``).

``plan_strip`` is K-umuf's launch planner, and ``plan_umuf`` the tile
planner of K-umuf-split (``csrc/umuf_split.cu``): plain Python, no CUDA, so
the CPU tests hold their choices to the shared-memory limits.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from flowdenoising_tpu_torch.ops.cuda import check_operands, launch

# Shared memory of one H100 SM, what one block may take, what the card
# reserves a block, and the threads and blocks an SM holds.
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
SMEM_RESERVED = 1024
SMEM_TWO_BLOCKS = SMEM_PER_SM // 2 - SMEM_RESERVED
THREADS_PER_SM = 2048
BLOCKS_PER_SM = 32
REGISTERS_PER_SM = 65536
# The most phase-1 work a plan may do per output pixel, as a multiple of
# the plane's: the context of k fused iterations is recomputed by the
# neighbouring blocks, and past twice the plane's work that costs more than
# the device-memory round trips the fusion saves.
MAX_PHASE1_WORK = 2.0

# --- K-umuf: the strip sweep (csrc/umuf.cu) ---

# The widest output strip a block sweeps; the rows a step, the most threads
# a block (four blocks an SM at 72 registers a thread; with a ring, two at
# 64) and the widest vertical window (r = winsize // 2) kept in registers,
# past which the kernel keeps 2r + S rows of M a column in shared memory,
# swept by S threads a column: csrc/umuf.cu's STEP_ROWS, MAX_THREADS,
# MAX_RING_THREADS and REG_WINDOW_MAX_R.
STRIP_X = 64
STEP_ROWS = 4
MAX_THREADS = 224
MAX_RING_THREADS = 512
REG_WINDOW_MAX_R = 3
# The registers a thread of K-umuf may take: its launch bound's, four blocks
# of MAX_THREADS an SM, or two of MAX_RING_THREADS.
REGISTERS = 72
RING_REGISTERS = 64


@dataclasses.dataclass(frozen=True)
class StripPlan:
    """How ``umuf_iterate`` runs ``iters`` iterations: ``launches`` holds
    the iterations of each launch (k, ..., k, rest); a block of ``threads``
    threads and ``smem`` bytes of shared memory (at the first launch's k)
    sweeps ``strip_x`` output columns of a plane down ``step_rows`` rows a
    step, and an SM holds ``blocks`` of them by shared memory, threads and
    registers; ``phase1_work`` is phase 1's pixels per plane pixel and
    iteration, the
    strips' column halos counted."""
    strip_x: int
    step_rows: int
    per_launch: int
    launches: tuple[int, ...]
    threads: int
    smem: int
    blocks: int
    phase1_work: float


def ring_window(r: int) -> bool:
    """Whether the kernel keeps the vertical window of r = winsize // 2 in a
    ring in shared memory (r = 0 or past ``REG_WINDOW_MAX_R``), not in
    registers."""
    return r == 0 or r > REG_WINDOW_MAX_R


def stage_widths(w: int, winsize: int, k: int, strip_x: int) -> list[int]:
    """Columns of each stage j < k of a strip (``csrc/umuf.cu:
    stage_width``): the strip grown by (k - j) * r, at most the plane's
    w."""
    r = winsize // 2
    return [min(strip_x + 2 * (k - j) * r, w) for j in range(k)]


def strip_smem_bytes(w: int, winsize: int, k: int, step_rows: int,
                     strip_x: int) -> int:
    """Shared memory of one K-umuf block (``csrc/umuf.cu:
    strip_smem_bytes``): two buffers of 5 x ``step_rows`` vertical sums a
    column of stages 0..k-1 and, where ``ring_window``, a ring of 5 x (2r +
    ``step_rows``) rows of M a column."""
    r = winsize // 2
    cols = sum(stage_widths(w, winsize, k, strip_x))
    ring = 5 * (2 * r + step_rows) * cols if ring_window(r) else 0
    return 4 * (2 * 5 * step_rows * cols + ring)


def strip_threads(w: int, winsize: int, k: int, strip_x: int) -> int:
    """Threads of a K-umuf block: a thread a column of every stage but the
    output stage (whose columns stage k - 1's threads take), ``STEP_ROWS``
    a column where ``ring_window``, in whole warps."""
    team = STEP_ROWS if ring_window(winsize // 2) else 1
    return 32 * math.ceil(team * sum(stage_widths(w, winsize, k, strip_x)) / 32)


def strip_limits(winsize: int) -> tuple[int, int]:
    """The most threads a K-umuf block of this winsize takes, and the
    registers a thread: its form's launch bound."""
    if ring_window(winsize // 2):
        return MAX_RING_THREADS, RING_REGISTERS
    return MAX_THREADS, REGISTERS


def _strip_work(w: int, r: int, k: int, strip_x: int) -> float:
    """Phase-1 pixels per plane pixel and iteration: stage j of each strip
    computes M on the strip grown by (k - j) * r, clamped to the plane."""
    cols = sum(min(x0 + strip_x - 1 + (k - j) * r, w - 1)
               - max(x0 - (k - j) * r, 0) + 1
               for x0 in range(0, w, strip_x) for j in range(k))
    return cols / (k * w)


def plan_strip(h: int, w: int, winsize: int, iters: int,
               per_launch: int | None = None) -> StripPlan:
    """The strip, the rows a step, the iterations per launch k and the
    block of K-umuf on (h, w) planes.

    The plane's columns go into the fewest strips of at most ``STRIP_X``,
    all as even as they can be (630 columns: 10 strips of 63), so no block
    sweeps a stub.  Without ``per_launch`` k is the largest <= iters whose
    block fits (threads at most ``strip_limits``, shared memory at most one
    block's) with phase 1 doing at most ``MAX_PHASE1_WORK`` times the
    plane's pixels, halving the strip where it does not fit; where the
    window lives in a ring k is 1 (on the H100 a ring's further stages
    cost more than the launches they save: narrower strips, more halo);
    ``per_launch`` fixes k.  The output is the same bit for bit for every plan.  Raises
    ValueError when no strip fits at k = 1: the winsize's window is too
    wide for the kernel's block; and for a plane whose five channels pass
    the kernel's 32-bit offsets.
    """
    if iters < 0 or winsize < 1 or h < 1 or w < 1:
        raise ValueError(f"plan_strip: bad arguments h={h} w={w} "
                         f"winsize={winsize} iters={iters}")
    if 5 * h * w >= 2 ** 31:
        raise ValueError(f"plan_strip: a {h} x {w} plane passes the "
                         "kernel's 32-bit offsets")
    r = winsize // 2
    max_threads, registers = strip_limits(winsize)
    if per_launch is not None:
        if not 1 <= per_launch <= max(iters, 1):
            raise ValueError(f"plan_strip: per_launch {per_launch} not in "
                             f"1..{max(iters, 1)}")
        ks, limit = [per_launch], None
    elif ring_window(r):
        ks, limit = [1], None
    else:
        ks, limit = range(max(iters, 1), 0, -1), MAX_PHASE1_WORK
    for k in ks:
        widest = STRIP_X
        while widest >= 1:
            strip_x = math.ceil(w / math.ceil(w / widest))
            widest //= 2
            smem = strip_smem_bytes(w, winsize, k, STEP_ROWS, strip_x)
            threads = strip_threads(w, winsize, k, strip_x)
            work = _strip_work(w, r, k, strip_x)
            if (smem > SMEM_PER_BLOCK or threads > max_threads
                    or (limit and k > 1 and work > limit)):
                continue
            launches = (k,) * (iters // k) + ((iters % k,) if iters % k else ())
            blocks = min(SMEM_PER_SM // (smem + SMEM_RESERVED),
                         THREADS_PER_SM // threads, BLOCKS_PER_SM,
                         REGISTERS_PER_SM // (registers * threads))
            return StripPlan(strip_x, STEP_ROWS, k, launches, threads, smem,
                             blocks, work)
    raise ValueError(f"umuf_iterate: winsize {winsize} needs a window halo of "
                     f"{r} px, wider than the kernel's block holds")


# --- K-umuf-split's tile plan (csrc/umuf_split.cu) ---

# Output tiles (rows, columns) the planner tries, largest first.
TILES = ((32, 64), (32, 32), (16, 32), (16, 16), (8, 16), (8, 8), (4, 4))


@dataclasses.dataclass(frozen=True)
class UmufPlan:
    """How ``umuf_split_iterate`` runs ``iters`` iterations: ``launches``
    holds the iterations of each launch (k, ..., k, rest); each block owns a
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
    """Shared memory of one K-umuf-split block (``csrc/farneback.cuh:
    umuf_smem_bytes``): M, 5 planes of (RH + r) x SW floats, and for k > 1
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
    """The tile, the iterations per launch k and the shared memory of
    K-umuf-split on (h, w) planes.

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
    ``plan_strip`` plans them, ``per_launch`` iterations a launch if given.

    r0, r1: (B, 5, H, W) polynomial expansions of target and reference;
    flow: (B, 2, H, W), channel 0 = x.  r0 and flow are float32; r1 is
    float32, or bfloat16 for the packed form (K-umuf-bf16, ``--precision
    bfloat16``), which samples it in float32.  ``d`` bounds the sampling
    displacement (None: no clamp).  ``ramp_bf16`` rounds the border ramp to
    bfloat16 (a bf16 pass's tiny levels).  Returns a new (B, 2, H, W) flow.
    Raises for other operands, and for a winsize whose window does not fit
    the kernel's block.
    """
    b, h, w = check_shapes("umuf_iterate", r0, r1, flow)
    check_operands("umuf_iterate", [
        ("r0", r0, (torch.float32,)),
        ("r1", r1, (torch.float32, torch.bfloat16)),
        ("flow", flow, (torch.float32,))], batch=b)
    plan = plan_strip(h, w, winsize, iters, per_launch)
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
               inv_ws2, k, plan.strip_x, plan.threads)
        cur = nxt
    return cur

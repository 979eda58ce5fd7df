"""K-umuf's plain version (the port's ``umuf_iterate`` on CPU tensors:
``iters`` x update_flow(update_matrices(...))) against the JAX package on
the CPU -- the fused Pallas kernel in interpret mode, the split XLA
iteration that JAX runs on tiny levels, and the split composition for the
hazards (even winsize, planes narrower than the border bands, no bound).
atol 5e-4, rtol 1e-4 (the bar of tests/test_pallas_umuf.py).

The CUDA kernel is held against this plain version on the card by
``chip_smoke.py`` and by tests/test_torch_cuda.py.  Here, where no kernel
runs, the kernel's decomposition -- strips swept down the plane, the k
iterations of a launch pipelined over rows -- is emulated in plain PyTorch
and held to the plain version bit for bit, and the launch planner to the
card's shared memory; so is K-umuf-split's tiling (output tiles with r*k
context), which ``plan_umuf`` plans.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flowdenoising_tpu.config import FlowConfig as JFlowConfig
from flowdenoising_tpu.ops import farneback as JF
from flowdenoising_tpu.ops.pallas import umuf as JU

from flowdenoising_tpu_torch.ops import cuda as K
from flowdenoising_tpu_torch.ops import farneback as F
from flowdenoising_tpu_torch.ops.farneback import umuf_iterate
from flowdenoising_tpu_torch.ops.cuda.umuf import (
    MAX_PHASE1_WORK, REGISTERS_PER_SM, SMEM_PER_BLOCK, SMEM_PER_SM,
    SMEM_RESERVED, SMEM_TWO_BLOCKS, STEP_ROWS, THREADS_PER_SM, plan_strip,
    plan_umuf, ring_window, stage_widths, strip_limits, strip_smem_bytes,
    strip_threads, umuf_smem_bytes)

torch.set_num_threads(1)

TOL = dict(atol=5e-4, rtol=1e-4)


def _setup(b, h, w, seed, flow_scale=1.5):
    """Channels-last JAX operands (expansions of noise images of scale 40,
    flow N(0, flow_scale))."""
    r = np.random.default_rng(seed)
    img0 = jnp.asarray(r.normal(size=(b, h, w)).astype(np.float32) * 40)
    img1 = jnp.asarray(r.normal(size=(b, h, w)).astype(np.float32) * 40)
    flow = (r.normal(size=(b, h, w, 2)) * flow_scale).astype(np.float32)
    return JF.poly_expand(img0), JF.poly_expand(img1), jnp.asarray(flow)


def _cf(x):
    """Channels-last array -> channel-first CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, -3)))


def _port(r0, r1, flow, iters, d, winsize):
    out = umuf_iterate(_cf(r0), _cf(r1), _cf(flow), iters, d, winsize)
    return np.moveaxis(out.numpy(), -3, -1)


def _split(r0, r1, flow, iters, d, winsize):
    for _ in range(iters):
        m = JF.update_matrices(r0, r1, flow, d, sampler="windowed" if d else "auto")
        flow = JF.update_flow(m, winsize, sampler="xla")
    return np.asarray(flow)


@pytest.mark.parametrize("winsize,d", [(5, 4), (7, 3)])
def test_plain_matches_pallas_interpret(winsize, d):
    r0, r1, flow = _setup(1, 16, 20, seed=winsize * 10 + d)
    ref = np.asarray(JU.umuf_iterate(r0, r1, flow, 3, d, winsize, interpret=True))
    np.testing.assert_allclose(_port(r0, r1, flow, 3, d, winsize), ref, **TOL)


@pytest.mark.parametrize("winsize,d", [(5, 2), (7, 3), (5, 4)])
def test_plain_matches_small_level_iterate(winsize, d):
    r0, r1, flow = _setup(3, 16, 24, seed=d)       # area 384 <= 2048
    cfg = JFlowConfig(winsize=winsize, iterations=3)
    ref = np.asarray(JF._small_level_iterate(r0, r1, flow, cfg, d))
    np.testing.assert_allclose(_port(r0, r1, flow, 3, d, winsize), ref, **TOL)


@pytest.mark.parametrize("h,w,winsize,d,scale", [
    (20, 22, 4, 3, 1.5),      # even winsize: 5x5 window scaled by 1/16
    (8, 9, 5, 2, 1.0),        # both border bands overlap
    (14, 18, 5, None, 4.0),   # no bound: exact sampling
    (16, 16, 5, 2, 6.0),      # flows far beyond the bound
])
def test_plain_matches_split_hazards(h, w, winsize, d, scale):
    r0, r1, flow = _setup(2, h, w, seed=h + w, flow_scale=scale)
    np.testing.assert_allclose(_port(r0, r1, flow, 3, d, winsize),
                               _split(r0, r1, flow, 3, d, winsize), **TOL)


def test_cpu_wrapper_counts_no_launch_and_checks_shapes():
    r0, r1, flow = _setup(1, 8, 8, seed=0)
    before = K.LAUNCHES["umuf"]
    _port(r0, r1, flow, 2, 2, 5)
    assert K.LAUNCHES["umuf"] == before
    with pytest.raises(ValueError):
        umuf_iterate(_cf(r0), _cf(r1)[:, :4], _cf(flow), 1, 2, 5)


# --- the kernel's decomposition (csrc/umuf.cu): the strip sweep, emulated
# on the CPU ---

def _sweep_emulation(r0, r1, flow, iters, d, winsize, plan, ramp_bf16=False,
                     window_short=0, halo_short=0, lag_short=0):
    """K-umuf's strip sweep in plain PyTorch, in the kernel's order, at
    ``plan`` (a StripPlan).  Each launch of k iterations sweeps every strip of
    ``plan.strip_x`` output columns down the plane, S = ``plan.step_rows``
    rows a step, in k stages and an output stage.  At step t stage j takes
    rows L = t*S - j*(S + r) .. L + S - 1 (r = winsize // 2) on the strip
    grown by (k - j) * r columns, clamped to the plane: the level's flow
    (stage 0) or the flow solved from the vertical sums stage j - 1 emitted
    the step before, then M; it pushes each row's M into its columns'
    window and emits the vertical window sum of row y - r once row y is in.
    The output stage solves the sums of stage k - 1 into the flow.

    Only what the kernel holds is there, by row: a window of the last 2r + 1
    pushes (where ``ring_window``, a ring of 2r + S, pushed a step at a
    time, then emitted), where pushing row 0 fills the window with it and a
    row below the plane pushes row H - 1 again; and the sums of the step
    before.  Everything else is NaN, and windows clamp to the plane, not to
    what a stage holds, so a window, a halo or a lag that many rows or
    columns short (``window_short``, ``halo_short``, ``lag_short``) leaves
    NaN in the output.  ``ramp_bf16`` rounds the border ramp to bfloat16, as
    the kernel's flag does."""
    b, _, h, w = flow.shape
    r = winsize // 2
    S = plan.step_rows
    whole_step = ring_window(r)
    depth = 2 * r + (S if whole_step else 1) - window_short
    inv = 1.0 / float(winsize * winsize)
    nan = float("nan")

    def missing():
        return torch.full((b, 5, w), nan)

    def solve(row, lo, hi):
        """The flow on columns lo..hi from one row of vertical sums: the
        horizontal window sum in ascending order, the scale, the solve."""
        xs = torch.arange(lo, hi + 1)
        a = row[..., (xs - r).clamp(0, w - 1)]
        for i in range(1, 2 * r + 1):
            a = a + row[..., (xs - r + i).clamp(0, w - 1)]
        g11, g12, g22, h1, h2 = (a * inv).unbind(1)
        idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
        return torch.stack([(g11 * h2 - g12 * h1) * idet,
                            (g22 * h1 - g12 * h2) * idet], 1)

    for n in plan.launches:
        out = torch.full_like(flow, nan)
        lag = S + r - lag_short
        for x0 in range(0, w, plan.strip_x):
            x1 = min(x0 + plan.strip_x, w) - 1
            cols = []
            for j in range(n + 1):
                g = (n - j) * r - (halo_short if j < n else 0)
                cols.append((max(x0 - g, 0), min(x1 + g, w - 1)))
            windows = [[] for _ in range(n)]     # (row, M of the row) a push
            sums = [{} for _ in range(n)]        # row -> vertical sums
            for t in range(-(-(h + n * (S + r)) // S)):
                emitted = [{} for _ in range(n)]
                for j in range(n + 1):
                    lo, hi = cols[j]
                    ys = [t * S - j * lag + s for s in range(S)]

                    def flow_at(y):
                        if j == 0:
                            return flow[:, :, y, lo:hi + 1]
                        return solve(sums[j - 1].get(y, missing()), lo, hi)

                    if j == n:
                        for y in ys:
                            if 0 <= y < h:
                                out[:, :, y, lo:hi + 1] = flow_at(y)
                        continue
                    f = torch.full_like(flow, nan)
                    for y in ys:
                        if 0 <= y < h:
                            f[:, :, y, lo:hi + 1] = flow_at(y)
                    m = torch.full((b, 5, h, w), nan)
                    m[..., lo:hi + 1] = F.update_matrices_plain(
                        r0, r1, f, d, ramp_bf16)[..., lo:hi + 1]
                    win = windows[j]

                    def push(y):
                        if y == 0:
                            win[:] = [(0, m[:, :, 0])] * depth
                        else:
                            win.append((min(y, h - 1),
                                        m[:, :, y] if y < h else win[-1][1]))
                            del win[:-depth]

                    def emit(o):
                        held = dict(win)
                        acc = held.get(min(max(o - r, 0), h - 1), missing())
                        for i in range(1, 2 * r + 1):
                            acc = acc + held.get(min(max(o - r + i, 0), h - 1),
                                                 missing())
                        emitted[j][o] = acc

                    live = [y for y in ys if 0 <= y <= h - 1 + r]
                    for y in live:
                        push(y)
                        if not whole_step and y >= r:
                            emit(y - r)
                    for y in live:
                        if whole_step and y >= r:
                            emit(y - r)
                sums = emitted
        flow = out
    return flow


def _cf_setup(b, h, w, seed, band=5.0):
    r = np.random.default_rng(seed)
    imgs = torch.from_numpy((r.normal(size=(2, b, h, w)) * 40).astype(np.float32))
    rr = F.poly_expand(imgs, channel_first=True).contiguous()
    flow = torch.from_numpy((r.normal(size=(b, 2, h, w)) * 2).astype(np.float32))
    flow[:, 0, : h // 4] += band         # a band beyond the bound (d = 2 by default)
    return rr[0], rr[1], flow


def _plan(h, w, winsize, iters, k=None, strip_x=None, step_rows=None):
    """plan_strip's plan, its strip or its rows a step replaced (the output
    does not depend on either)."""
    plan = plan_strip(h, w, winsize, iters, k)
    return dataclasses.replace(plan, strip_x=strip_x or plan.strip_x,
                               step_rows=step_rows or plan.step_rows)


# scaled-down levels of the cells' passes (Z: 768x1024 .. 192x256 and 630^2
# .. 158^2; Y and X: 165 or 184 rows), narrow strips so that every plane
# has interior strip edges, and planes shorter than the pipeline's fill
@pytest.mark.parametrize("h,w,winsize,iters,d,k,strip_x,step_rows", [
    (48, 64, 5, 3, 9, None, 16, None),    # the Z pass's level 0, d 9
    (24, 32, 5, 3, 5, None, 8, 4),        # its level 1, d 5
    (21, 64, 5, 3, 9, None, 16, None),    # the Y and X passes: short planes
    (11, 32, 5, 3, 3, None, 8, 4),
    (40, 40, 5, 3, None, None, 13, None),  # the probe's levels: no clamp
    (37, 70, 4, 2, 2, None, 16, 4),       # even winsize
    (37, 70, 7, 3, 2, 3, 16, None),       # r 3, the widest window in registers
    (30, 41, 9, 3, 2, 2, 8, 4),           # r 4: rings; launches of 2 and 1
    (26, 40, 15, 3, None, None, 10, None),  # r 7
    (30, 26, 3, 3, 2, 1, 8, None),        # r 1, one iteration a launch
    (23, 29, 1, 3, 2, None, 8, None),     # r 0: a ring of S rows
    (5, 30, 5, 3, 2, None, 8, None),      # shorter than the fill (k(S + r))
    (3, 3, 5, 3, 2, None, None, None),    # plane smaller than the strip
    (1, 17, 7, 2, 2, None, 8, 4),
    (19, 1, 5, 3, 2, None, None, 4),
])
def test_sweep_emulation_equals_plain_bitwise(h, w, winsize, iters, d, k,
                                              strip_x, step_rows):
    """The strip sweep, at the planner's k and strip or at a given one, with
    S 4 or 8, equals umuf_iterate_plain bit for bit."""
    r0, r1, flow = _cf_setup(1, h, w, seed=h * w + winsize + iters)
    plan = _plan(h, w, winsize, iters, k, strip_x, step_rows)
    got = _sweep_emulation(r0, r1, flow, iters, d, winsize, plan)
    ref = F.umuf_iterate_plain(r0, r1, flow, iters, d, winsize)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


@pytest.mark.parametrize("short", ["window", "halo", "lag"])
@pytest.mark.parametrize("winsize,k,step_rows", [(5, 3, 8), (5, 2, 4), (7, 3, 4),
                                                 (9, 2, 8)])
def test_sweep_emulation_one_short_shows(short, winsize, k, step_rows):
    """The emulation's NaN check bites: a column window holding one push
    fewer, stage halos one column narrower, or a lag one row shorter leave
    NaN in the output."""
    r0, r1, flow = _cf_setup(1, 30, 48, seed=winsize * 10 + k)
    plan = _plan(30, 48, winsize, k, k, 16, step_rows)
    got = _sweep_emulation(r0, r1, flow, k, 2, winsize, plan,
                           **{f"{short}_short": 1})
    assert torch.isnan(got).any()


# --- the packed form (K-umuf-bf16): r1 in bfloat16 on the same plan ---

@pytest.mark.parametrize("h,w,winsize,iters,d,k,strip_x", [
    (20, 24, 5, 3, 2, 3, None),           # plane narrower than a strip's reach
    (37, 45, 5, 3, 2, 3, 16),             # odd widths, strips at every edge
    (40, 64, 5, 3, 3, 3, 16),
    (33, 41, 4, 3, 3, 2, 8),              # even winsize, launches of 2 and 1
    (32, 32, 5, 3, 5, None, None),        # the planner's plan
    (45, 53, 7, 3, 5, 2, 16),
    (20, 24, 5, 3, 9, 3, 8),
    (24, 70, 5, 3, 9, 3, 16),
    (40, 40, 5, 2, 49, 2, 16),            # d 49, the auto probe's D 48
    (30, 35, 5, 1, 49, 1, 16),
])
def test_sweep_emulation_of_the_packed_form_equals_plain_bitwise(
        h, w, winsize, iters, d, k, strip_x):
    """The strip sweep with r1 in bfloat16 at the bounds the bf16 paths run
    (d 2, 3, 5, 9) and the auto probe's largest (49), with flows beyond +-d
    in x and y, equals umuf_iterate_plain bit for bit."""
    r0, r1, flow = _cf_setup(1, h, w, seed=h * w + d, band=2.0 * d + 3.5)
    flow[:, 1, :, : w // 3] -= 2.0 * d + 2.5     # and one beyond -d in y
    r1 = r1.to(torch.bfloat16)
    plan = _plan(h, w, winsize, iters, k, strip_x)
    got = _sweep_emulation(r0, r1, flow, iters, d, winsize, plan)
    ref = F.umuf_iterate_plain(r0, r1, flow, iters, d, winsize)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


@pytest.mark.parametrize("h,w,iters,k,strip_x", [
    (32, 32, 3, None, None),              # the tiny level of a 256^3 pass
    (20, 24, 3, 2, 8),
    (3, 3, 2, None, None),
    (37, 45, 3, 3, 16),
])
def test_sweep_emulation_with_the_bf16_ramp_equals_plain_bitwise(h, w, iters,
                                                                 k, strip_x):
    """The float32 form with the border ramp rounded to bfloat16 (a bf16
    pass's tiny levels) sweeps as it does without: bit for bit the plain
    version with the same ramp."""
    r0, r1, flow = _cf_setup(1, h, w, seed=h * w + iters)
    plan = _plan(h, w, 5, iters, k, strip_x)
    got = _sweep_emulation(r0, r1, flow, iters, 2, 5, plan, ramp_bf16=True)
    ref = F.umuf_iterate_plain(r0, r1, flow, iters, 2, 5, ramp_bf16=True)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    assert not torch.equal(ref, F.umuf_iterate_plain(r0, r1, flow, iters, 2, 5))


# --- the strip planner ---

def _largest_strip_winsize():
    ws = 1
    while True:
        try:
            plan_strip(4096, 4096, ws + 1, 1)
        except ValueError:
            return ws
        ws += 1


def test_strip_planner_fits_every_winsize_it_accepts():
    """Every plan fits the SM at the blocks it claims, its block fits the
    kernel's bounds, its strips cover the plane, and it takes every winsize
    the tile planner took (59)."""
    largest = _largest_strip_winsize()
    assert largest >= 59
    for ws in range(1, largest + 1):
        for iters in range(1, 6):
            for h, w in ((4096, 4096), (768, 1024), (37, 70), (3, 3), (1, 5)):
                for k in (None, *range(1, iters + 1)):
                    try:
                        plan = plan_strip(h, w, ws, iters, k)
                    except ValueError:
                        # a fixed k > 1 may not fit; k = 1 always does
                        assert k is not None and k > 1
                        continue
                    assert sum(plan.launches) == iters
                    assert all(1 <= n <= plan.per_launch for n in plan.launches)
                    kk = plan.per_launch
                    assert plan.smem == strip_smem_bytes(w, ws, kk, plan.step_rows,
                                                         plan.strip_x)
                    assert plan.threads == strip_threads(w, ws, kk, plan.strip_x)
                    assert plan.threads >= sum(stage_widths(w, ws, kk, plan.strip_x))
                    max_threads, registers = strip_limits(ws)
                    assert plan.threads <= max_threads and plan.threads % 32 == 0
                    assert plan.smem <= SMEM_PER_BLOCK
                    assert plan.blocks >= 1
                    assert plan.blocks * (plan.smem + SMEM_RESERVED) <= SMEM_PER_SM
                    assert plan.blocks * plan.threads <= THREADS_PER_SM
                    assert plan.blocks * plan.threads * registers <= REGISTERS_PER_SM
                    assert plan.step_rows in (4, 8)
                    assert 1 <= plan.strip_x <= w
                    # even strips: the last is at most one column narrower
                    assert -(-w // plan.strip_x) * plan.strip_x - w < -(-w // plan.strip_x)
                    if k is None and plan.per_launch > 1:
                        assert plan.phase1_work <= MAX_PHASE1_WORK


@pytest.mark.parametrize("winsize", [1, 8, 9, 15, 21, 59, 101])
def test_strip_planner_runs_a_ring_one_iteration_a_launch(winsize):
    """Where the window lives in a ring (r = 0 or past the registers' r 3)
    the planner takes k = 1 on every plane, the widest strip whose team of
    STEP_ROWS threads a column fits; a fixed k is still taken."""
    assert ring_window(winsize // 2)
    for h, w in ((768, 1024), (630, 630), (42, 192), (3, 3)):
        plan = plan_strip(h, w, winsize, 3)
        assert plan.launches == (1, 1, 1)
        assert plan.threads == strip_threads(w, winsize, 1, plan.strip_x)
        assert plan.threads >= STEP_ROWS * sum(stage_widths(w, winsize, 1,
                                                            plan.strip_x))
    if winsize <= 15:
        assert plan_strip(256, 256, winsize, 3, 2).launches == (2, 1)


def test_strip_planner_refuses_windows_wider_than_its_block():
    largest = _largest_strip_winsize()
    # umuf_iterate plans before it loads the kernel library, so on the card
    # such a winsize raises this ValueError and launches nothing
    for ws in (largest + 1, largest + 2, 201):
        for iters in (1, 3):
            with pytest.raises(ValueError, match="halo"):
                plan_strip(256, 256, ws, iters)
    with pytest.raises(ValueError, match="32-bit"):
        plan_strip(20000, 21475, 5, 3)    # 5 x h x w just past 2^31


# the block of each strip width above: rows a step, threads, shared memory,
# blocks an SM
PINNED_BLOCK = {64: (4, 224, 34560, 4), 63: (4, 224, 34080, 4),
                53: (4, 192, 29280, 4), 32: (4, 96, 15360, 9)}


# The 15 level shapes of the cells (3 levels a pass: EPFL CA1 Z 768x1024,
# Y 165x1024, X 165x768; CZII Z 630x630, Y and X 184x630), the probe's two
# and a 256^3 pass's four, at winsize 5 and 3 iterations: one launch a level
@pytest.mark.parametrize("h,w,want", [
    (768, 1024, (64, 16)), (384, 512, (64, 8)), (192, 256, (64, 4)),
    (165, 1024, (64, 16)), (83, 512, (64, 8)), (42, 256, (64, 4)),
    (165, 768, (64, 12)), (83, 384, (64, 6)), (42, 192, (64, 3)),
    (630, 630, (63, 10)), (315, 315, (63, 5)), (158, 158, (53, 3)),
    (184, 630, (63, 10)), (92, 315, (63, 5)), (46, 158, (53, 3)),
    (128, 128, (64, 2)), (64, 256, (64, 4)),
    (256, 256, (64, 4)), (32, 32, (32, 1)),
])
def test_strip_plans_at_the_cells_levels(h, w, want):
    """The plans the card's times were taken at, pinned: one launch of 3
    iterations, strips as even as the plane allows, phase 1 at most 1.13
    times the plane's work (the tile took 1.41)."""
    p = plan_strip(h, w, 5, 3)
    assert (p.strip_x, -(-w // p.strip_x)) == want
    assert p.launches == (3,) and p.per_launch == 3
    assert p.phase1_work <= 1.13
    assert (p.step_rows, p.threads, p.smem, p.blocks) == PINNED_BLOCK[p.strip_x]


@pytest.mark.parametrize("s", [512, 256, 128, 64])
def test_strip_plan_at_the_packed_levels(s):
    """The plane sizes the bf16 paths run packed (ops/farneback.py:
    _packed_at_level): 256^2, 128^2 and 64^2 at 256^3, 512^2 to 64^2 at
    512^3, at every bound (the plan does not depend on d): one launch, the
    float32 form's block."""
    plan = plan_strip(s, s, 5, 3)
    assert plan.launches == (3,)
    assert plan.smem == strip_smem_bytes(s, 5, 3, plan.step_rows, plan.strip_x)
    assert plan.blocks * (plan.smem + SMEM_RESERVED) <= SMEM_PER_SM
    assert plan.phase1_work <= 1.13


# --- the tile planner (K-umuf-split's: csrc/umuf_split.cu) ---

def _largest_winsize():
    ws = 1
    while True:
        try:
            plan_umuf(4096, 4096, ws + 1, 1)
        except ValueError:
            return ws
        ws += 1


def test_planner_fits_every_winsize_it_accepts():
    largest = _largest_winsize()
    assert largest >= 15              # OpenCV's usual winsizes, with room
    for ws in range(1, largest + 1):
        for iters in range(1, 6):
            for h, w in ((4096, 4096), (256, 256), (37, 70), (3, 3)):
                for k in (None, *range(1, iters + 1)):
                    try:
                        plan = plan_umuf(h, w, ws, iters, k)
                    except ValueError:
                        # a fixed k > 1 may not fit; k = 1 always does
                        assert k is not None and k > 1
                        continue
                    assert sum(plan.launches) == iters
                    assert all(1 <= n <= plan.per_launch for n in plan.launches)
                    assert plan.smem == umuf_smem_bytes(
                        h, w, ws, plan.per_launch, plan.tile_y, plan.tile_x)
                    assert plan.smem <= SMEM_TWO_BLOCKS < SMEM_PER_BLOCK
                    assert plan.tile_y <= h and plan.tile_x <= w
                    assert plan.threads in (256, 512)
                    if k is None and plan.per_launch > 1:
                        assert plan.phase1_work <= MAX_PHASE1_WORK


def test_planner_default_at_the_main_path():
    # winsize 5, 3 iterations: one launch per level at every level of a
    # 256^2 plane, so 4 per tap solve
    for s in (256, 128, 64, 32):
        assert plan_umuf(s, s, 5, 3).launches == (3,)


def test_planner_refuses_windows_wider_than_shared_memory():
    largest = _largest_winsize()
    # umuf_iterate plans before it loads the kernel library, so on the card
    # such a winsize raises this ValueError and launches nothing
    for ws in (largest + 1, largest + 2, 101):
        for iters in (1, 3):
            with pytest.raises(ValueError, match="halo"):
                plan_umuf(256, 256, ws, iters)


@pytest.mark.parametrize("args,want", [
    ((256, 256, 5, 3), (32, 64, 3, (3,), 512, 96672)),
    ((512, 512, 5, 3), (32, 64, 3, (3,), 512, 96672)),
    ((128, 128, 5, 3), (32, 64, 3, (3,), 512, 96672)),
    ((64, 64, 5, 3), (32, 64, 3, (3,), 512, 81408)),
    ((32, 32, 5, 3), (32, 32, 3, (3,), 256, 29952)),
    ((37, 70, 7, 3), (32, 64, 3, (3,), 512, 76720)),
    ((100, 130, 15, 3), (32, 64, 1, (1, 1, 1), 512, 82680)),
    ((3, 3, 5, 2), (3, 3, 2, (2,), 256, 372)),
    ((4096, 4096, 5, 5), (32, 32, 5, (5,), 256, 77792)),
])
def test_split_tile_plans_are_pinned(args, want):
    """K-umuf-split's plans, pinned: the tile, k, launches, threads and
    shared memory the card's times were taken at."""
    p = plan_umuf(*args)
    assert (p.tile_y, p.tile_x, p.per_launch, p.launches, p.threads, p.smem) == want


def _tiled_emulation(r0, r1, flow, iters, d, winsize, tile_y, tile_x, k,
                     short=0, ramp_bf16=False, split=False):
    """K-umuf's decomposition in plain PyTorch: ceil(iters / k) launches; in
    each, every tile_y x tile_x output tile starts from the flow on the tile
    grown by k*r (r = winsize // 2), clamped to the plane; iteration j
    computes M on the tile grown by (k - j) * r and the flow on the tile
    grown by (k - 1 - j) * r, replicating M only where the region meets the
    plane's edge.  Flow outside the region is NaN, so a window that reached
    past it would show.  ``short`` starts each tile from a flow region that
    many pixels narrower than k*r, a halo the kernel must not have;
    ``ramp_bf16`` rounds the border ramp to bfloat16, as the kernel's flag
    does.  ``split`` takes K-umuf-split's phase 1 (``update_matrices_xla``
    on bf16 r0 and r1, no bound, M widened to float32) and its flows: the
    input flow, bf16 or float32, in the first iteration only, the float32
    carry after it."""
    b, _, h, w = flow.shape
    r = winsize // 2
    nan = torch.full(flow.shape, float("nan"))

    def phase1(f):
        if split:
            return F.update_matrices_xla(r0, r1, f).float()
        return F.update_matrices_plain(r0, r1, f, d, ramp_bf16)

    for n in (k,) * (iters // k) + ((iters % k,) if iters % k else ()):
        out = nan.clone()
        for ty0 in range(0, h, tile_y):
            for tx0 in range(0, w, tile_x):
                ty1, tx1 = min(ty0 + tile_y, h), min(tx0 + tile_x, w)

                def grown(c):
                    return (slice(max(ty0 - c, 0), min(ty1 + c, h)),
                            slice(max(tx0 - c, 0), min(tx1 + c, w)))

                f = torch.full_like(flow, float("nan"))
                fy, fx = grown(n * r - short)
                f[..., fy, fx] = flow[..., fy, fx]
                for j in range(n):
                    my, mx = grown((n - j) * r)
                    # M is pointwise in the flow: compute it on the plane,
                    # keep the region; the box sum replicates the region's
                    # edges, which are the plane's or lie r outside the
                    # flow region kept below, as far as its windows reach
                    m = phase1(f)[..., my, mx]
                    new = F.update_flow_plain(m, winsize)
                    oy, ox = grown((n - 1 - j) * r)
                    f = nan.clone()
                    f[..., oy, ox] = new[..., oy.start - my.start:oy.stop - my.start,
                                         ox.start - mx.start:ox.stop - mx.start]
                out[..., ty0:ty1, tx0:tx1] = f[..., ty0:ty1, tx0:tx1]
        flow = out
    return flow


# --- the split form (K-umuf-split): bf16 r0 and r1, no bound, on the same
# plan; its own tests are tests/test_torch_umuf_split.py ---

def _split_setup(b, h, w, seed, flow_dtype):
    """bf16 expansions of noise images (the split route's pyramid levels
    are bf16) and a flow N(0, 2) with bands pushed 40 px past the plane's
    right and top edges, in ``flow_dtype``."""
    r = np.random.default_rng(seed)
    imgs = torch.from_numpy((r.normal(size=(2, b, h, w)) * 40).astype(np.float32))
    rr = F.poly_expand(imgs.to(torch.bfloat16), channel_first=True).contiguous()
    flow = torch.from_numpy((r.normal(size=(b, 2, h, w)) * 2).astype(np.float32))
    flow[:, 0, : h // 4] += 40.0
    flow[:, 1, :, : w // 3] -= 40.0
    return rr[0], rr[1], flow.to(getattr(torch, flow_dtype))


@pytest.mark.parametrize("flow_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("h,w,winsize,iters,k,tile", [
    (40, 261, 5, 3, None, None),          # past 256: bf16 coordinates round
    (37, 70, 7, 3, 2, (8, 16)),           # launches of 2 and 1
    (20, 24, 4, 3, 1, None),              # even winsize, one iteration a launch
    (3, 3, 5, 2, None, None),             # plane smaller than the tile
    (70, 45, 15, 3, None, None),
    (8, 300, 5, 3, 3, (8, 64)),
])
def test_tiled_emulation_of_the_split_form_equals_plain_bitwise(
        h, w, winsize, iters, k, tile, flow_dtype):
    """K-umuf-split's tiling, from a bf16 or a float32 input flow, equals
    split_iterate_plain bit for bit at the plans plan_umuf gives."""
    r0, r1, flow = _split_setup(1, h, w, h * w + winsize, flow_dtype)
    plan = plan_umuf(h, w, winsize, iters, k)
    ty, tx = tile if tile else (plan.tile_y, plan.tile_x)
    got = _tiled_emulation(r0, r1, flow, iters, None, winsize, ty, tx,
                           plan.per_launch, split=True)
    ref = F.split_iterate_plain(r0, r1, flow, iters, winsize)
    assert got.dtype == ref.dtype == torch.float32
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


@pytest.mark.parametrize("flow_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("winsize,k", [(3, 1), (5, 1), (5, 2), (5, 3), (4, 3)])
def test_tiled_emulation_of_the_split_form_with_a_halo_one_short_shows(
        winsize, k, flow_dtype):
    """The NaN check bites for the split form too, from either input
    flow."""
    r0, r1, flow = _split_setup(1, 48, 48, winsize * 10 + k, flow_dtype)
    got = _tiled_emulation(r0, r1, flow, k, None, winsize, 16, 16, k, short=1,
                           split=True)
    assert torch.isnan(got[..., 16:32, 16:32]).any()

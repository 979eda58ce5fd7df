"""K-umuf's plain version (the port's ``umuf_iterate`` on CPU tensors:
``iters`` x update_flow(update_matrices(...))) against the JAX package on
the CPU -- the fused Pallas kernel in interpret mode, the split XLA
iteration that JAX runs on tiny levels, and the split composition for the
hazards (even winsize, planes narrower than the border bands, no bound).
atol 5e-4, rtol 1e-4 (the bar of tests/test_pallas_umuf.py).

The CUDA kernel is held against this plain version on the card by
``chip_smoke.py`` and by tests/test_torch_cuda.py.  Here, where no kernel
runs, the kernel's decomposition -- output tiles with r*k context, k
iterations a launch -- is emulated in plain PyTorch and held to the plain
version bit for bit, and the launch planner to the card's shared memory.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flowdenoising_tpu.config import FlowConfig as JFlowConfig
from flowdenoising_tpu.ops import farneback as JF
from flowdenoising_tpu.ops.pallas import umuf as JU

from flowdenoising_tpu_torch.ops import cuda as K
from flowdenoising_tpu_torch.ops import farneback as F
from flowdenoising_tpu_torch.ops.cuda.umuf import (
    MAX_PHASE1_WORK, SMEM_PER_BLOCK, SMEM_TWO_BLOCKS, plan_umuf, umuf_iterate,
    umuf_smem_bytes)

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


# --- the kernel's decomposition (csrc/umuf.cu), emulated on the CPU ---

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


def _cf_setup(b, h, w, seed, band=5.0):
    r = np.random.default_rng(seed)
    imgs = torch.from_numpy((r.normal(size=(2, b, h, w)) * 40).astype(np.float32))
    rr = F.poly_expand(imgs).contiguous()
    flow = torch.from_numpy((r.normal(size=(b, 2, h, w)) * 2).astype(np.float32))
    flow[:, 0, : h // 4] += band         # a band beyond the bound (d = 2 by default)
    return rr[0], rr[1], flow


@pytest.mark.parametrize("h,w,winsize,iters,d,k,tile", [
    (3, 3, 5, 3, 2, None, None),          # plane smaller than the tile
    (3, 3, 15, 2, None, 1, (2, 2)),
    (37, 70, 5, 3, 2, None, None),        # not a multiple of the tile
    (37, 70, 5, 3, None, 2, (8, 16)),     # k < iters: launches of 2 and 1
    (37, 70, 4, 2, 2, None, (8, 8)),      # even winsize
    (37, 70, 7, 3, 2, 3, (16, 16)),
    (37, 70, 15, 3, None, None, None),
    (37, 70, 15, 2, 2, 2, (8, 8)),
    (256, 20, 5, 1, 2, None, None),
    (256, 20, 7, 3, None, 1, (32, 8)),
    (256, 20, 15, 3, 2, None, (16, 16)),
    (256, 20, 4, 3, 2, 2, None),
])
def test_tiled_emulation_equals_plain_bitwise(h, w, winsize, iters, d, k, tile):
    """The kernel's tiling with r*k context, at the planner's plan or at a
    given tile and k, equals umuf_iterate_plain bit for bit."""
    r0, r1, flow = _cf_setup(1, h, w, seed=h * w + winsize + iters)
    plan = plan_umuf(h, w, winsize, iters, k)
    ty, tx = tile if tile else (plan.tile_y, plan.tile_x)
    got = _tiled_emulation(r0, r1, flow, iters, d, winsize, ty, tx,
                           plan.per_launch)
    ref = F.umuf_iterate_plain(r0, r1, flow, iters, d, winsize)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


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


@pytest.mark.parametrize("winsize,k", [(3, 1), (5, 1), (5, 2), (5, 3), (7, 2),
                                       (4, 3)])
def test_tiled_emulation_with_a_halo_one_short_shows(winsize, k):
    """The emulation's NaN check bites: interior tiles started from a flow
    region one pixel narrower than k*r leave NaN in the output."""
    r0, r1, flow = _cf_setup(1, 48, 48, seed=winsize * 10 + k)
    got = _tiled_emulation(r0, r1, flow, k, 2, winsize, 16, 16, k, short=1)
    assert torch.isnan(got[..., 16:32, 16:32]).any()


# --- the packed form (K-umuf-bf16): r1 in bfloat16 on the same plan ---

@pytest.mark.parametrize("h,w,winsize,iters,d,k,tile", [
    (20, 24, 5, 3, 2, 3, (32, 32)),       # plane narrower than the tile's reach
    (37, 45, 5, 3, 2, 3, (16, 16)),       # odd widths, tiles at every edge
    (70, 90, 5, 3, 3, 3, (32, 32)),
    (33, 41, 4, 3, 3, 2, (8, 16)),        # even winsize, launches of 2 and 1
    (64, 64, 5, 3, 5, None, None),        # the planner's plan
    (45, 53, 7, 3, 5, 2, (16, 32)),
    (20, 24, 5, 3, 9, 3, (32, 32)),
    (70, 96, 5, 3, 9, 3, (32, 32)),
    (40, 40, 5, 2, 49, 2, (16, 16)),      # d 49, the auto probe's D 48
    (66, 35, 5, 1, 49, 1, (32, 16)),
])
def test_tiled_emulation_of_the_packed_form_equals_plain_bitwise(
        h, w, winsize, iters, d, k, tile):
    """The kernel's tiling with r1 in bfloat16 at the bounds the bf16 paths
    run (d 2, 3, 5, 9) and the auto probe's largest (49), with flows beyond
    +-d in x and y, equals umuf_iterate_plain bit for bit."""
    r0, r1, flow = _cf_setup(1, h, w, seed=h * w + d, band=2.0 * d + 3.5)
    flow[:, 1, :, : w // 3] -= 2.0 * d + 2.5     # and one beyond -d in y
    r1 = r1.to(torch.bfloat16)
    plan = plan_umuf(h, w, winsize, iters, k)
    ty, tx = tile if tile else (plan.tile_y, plan.tile_x)
    got = _tiled_emulation(r0, r1, flow, iters, d, winsize, ty, tx,
                           plan.per_launch)
    ref = F.umuf_iterate_plain(r0, r1, flow, iters, d, winsize)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


@pytest.mark.parametrize("h,w,iters,k,tile", [
    (32, 32, 3, None, None),              # the tiny level of a 256^3 pass
    (20, 24, 3, 2, (8, 16)),
    (3, 3, 2, None, None),
    (37, 45, 3, 3, (16, 16)),
])
def test_tiled_emulation_with_the_bf16_ramp_equals_plain_bitwise(h, w, iters,
                                                                 k, tile):
    """The float32 form with the border ramp rounded to bfloat16 (a bf16
    pass's tiny levels) tiles as it does without: bit for bit the plain
    version with the same ramp."""
    r0, r1, flow = _cf_setup(1, h, w, seed=h * w + iters)
    plan = plan_umuf(h, w, 5, iters, k)
    ty, tx = tile if tile else (plan.tile_y, plan.tile_x)
    got = _tiled_emulation(r0, r1, flow, iters, 2, 5, ty, tx, plan.per_launch,
                           ramp_bf16=True)
    ref = F.umuf_iterate_plain(r0, r1, flow, iters, 2, 5, ramp_bf16=True)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    assert not torch.equal(ref, F.umuf_iterate_plain(r0, r1, flow, iters, 2, 5))


# The plane sizes the bf16 paths run packed (ops/farneback.py:
# _packed_at_level): 256^2, 128^2 and 64^2 at 256^3, 512^2 to 64^2 at
# 512^3, at every bound (the plan does not depend on d).
@pytest.mark.parametrize("s", [512, 256, 128, 64])
def test_plan_fits_two_blocks_at_the_packed_levels(s):
    plan = plan_umuf(s, s, 5, 3)
    assert plan.launches == (3,)
    assert plan.smem == umuf_smem_bytes(s, s, 5, 3, plan.tile_y, plan.tile_x)
    assert plan.smem <= SMEM_TWO_BLOCKS
    assert plan.phase1_work <= MAX_PHASE1_WORK


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
def test_gather_plans_are_the_float32_forms(args, want):
    """The plans of both forms, pinned: the tile, k, launches, threads and
    shared memory the card's times were taken at."""
    p = plan_umuf(*args)
    assert (p.tile_y, p.tile_x, p.per_launch, p.launches, p.threads, p.smem) == want


# --- the split form (K-umuf-split): bf16 r0 and r1, no bound, on the same
# plan; its own tests are tests/test_torch_umuf_split.py ---

def _split_setup(b, h, w, seed, flow_dtype):
    """bf16 expansions of noise images (the split route's pyramid levels
    are bf16) and a flow N(0, 2) with bands pushed 40 px past the plane's
    right and top edges, in ``flow_dtype``."""
    r = np.random.default_rng(seed)
    imgs = torch.from_numpy((r.normal(size=(2, b, h, w)) * 40).astype(np.float32))
    rr = F.poly_expand(imgs.to(torch.bfloat16)).contiguous()
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

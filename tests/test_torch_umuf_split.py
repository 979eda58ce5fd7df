"""K-umuf-split on the CPU: its phase 1, its wrapper and its planner.

The kernel (``flowdenoising_tpu_torch/csrc/umuf_split.cu``) cannot run
here.  Its phase 1, ``matrices_split``, is emulated below line by line in
float32 with every bf16 rounding explicit and held bit for bit to the plain
version ``update_matrices_xla`` (which ``tests/test_torch_bf16_nobound.py``
holds bit for bit to the JAX package's eager XLA phase 1) on the planes of
that file, on a plane wider than 1024 and on one taller than 256, with bf16
and float32 flows: so the kernel's rounding recipe is checked before any
card run.  Its tile loop is emulated in ``tests/test_torch_umuf.py``; on the
card ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the kernel to
``split_iterate_plain`` bit for bit.
"""

import numpy as np
import pytest
import torch

from conftest import make_blob_volume
from split_tap import BF16, rb, rounder, split_sample, split_tap
from flowdenoising_tpu_torch.config import FlowConfig
from flowdenoising_tpu_torch.ops import cuda as K
from flowdenoising_tpu_torch.ops import farneback as F
from flowdenoising_tpu_torch.ops.cuda.umuf import (
    SMEM_PER_BLOCK, SMEM_TWO_BLOCKS, plan_umuf, umuf_smem_bytes)
from flowdenoising_tpu_torch.ops.cuda.umuf_split import plan_split

torch.set_num_threads(1)

# csrc/farneback.cuh: kRamp
RAMP = (0.14, 0.14, 0.4472, 0.4472, 0.4472)


def edge_weights(n):
    """csrc/farneback.cuh: edge_weight(i, n) for every i of an axis, in
    float64 as the device computes it."""
    s = np.ones(n)
    for i in range(n):
        if i < 5:
            s[i] *= RAMP[i]
        if n - 1 - i < 5:
            s[i] *= RAMP[n - 1 - i]
    return s


def matrices_split(r0, r1, flow, bf):
    """csrc/umuf_split.cu: matrices_split<bf> at every pixel at once, in
    float32, each of its lines here in its order: ``R`` is its rnd<BF>
    (round to bf16 with a bf16 flow), ``rb`` its round_bf16; r1's taps are
    bf16.cuh's split tap (``tests/split_tap.py``)."""
    R = rounder(bf)
    _, _, h, w = r0.shape
    a = r0.float().unbind(1)
    tap = split_tap(flow[:, 0].float(), flow[:, 1].float(), bf)
    dx, dy = flow[:, 0].float(), flow[:, 1].float()
    xlast = R(torch.tensor(float(w - 2)))
    ylast = R(torch.tensor(float(h - 2)))
    inb = ((tap.x0f >= 0) & (tap.x0f <= xlast) & (tap.y0f >= 0)
           & (tap.y0f <= ylast))
    s = [split_sample(q, tap, bf) for q in r1.float().unbind(1)]
    zero = torch.zeros(())
    r4 = torch.where(inb, R(R(a[2] + s[2]) * 0.5), a[2])
    r5 = torch.where(inb, R(R(a[3] + s[3]) * 0.5), a[3])
    r6 = torch.where(inb, R(R(a[4] + s[4]) * 0.25), rb(a[4] * 0.5))
    r2 = R(R(a[0] - torch.where(inb, s[0], zero)) * 0.5)
    r3 = R(R(a[1] - torch.where(inb, s[1], zero)) * 0.5)
    r2 = R(R(r2 + R(r4 * dy)) + R(r6 * dx))
    r3 = R(R(r3 + R(r6 * dy)) + R(r5 * dx))
    sc = rb(torch.from_numpy(np.outer(edge_weights(h), edge_weights(w))).float())
    r2, r3, r4, r5, r6 = (R(v * sc) for v in (r2, r3, r4, r5, r6))
    return torch.stack([R(R(r4 * r4) + R(r6 * r6)), R(R(r4 + r5) * r6),
                        R(R(r5 * r5) + R(r6 * r6)), R(R(r4 * r2) + R(r6 * r3)),
                        R(R(r6 * r2) + R(r5 * r3))], 1)


# the planes of tests/test_torch_bf16_nobound.py, one wider than 1024 and
# one taller than 256 (bf16 pixel coordinates round past 256)
PLANES = {"64x64": (6, 64, 64, 2), "40x261": (3, 40, 261, 5),
          "8x1030": (3, 8, 1030, 7), "300x20": (3, 300, 20, 8)}


def _level0(plane):
    """Level 0 of the split route's bf16 expansion pyramid of a blob
    stack: (r0, r1) of its adjacent plane pairs."""
    n, h, w, seed = PLANES[plane]
    vol = torch.from_numpy(make_blob_volume(n, h, w, seed=seed)).to(BF16)
    r = F.polyexp_pyramid(vol, FlowConfig(dtype="bfloat16", levels=0))[0]
    return r[:-1].contiguous(), r[1:].contiguous()


def _flow(b, h, w, seed, scale=3.0):
    """A flow N(0, scale) with a band pushed 40 px past the right edge and
    one 40 px past the top."""
    f = np.random.default_rng(seed).normal(size=(b, 2, h, w)).astype(np.float32)
    f *= scale
    f[:, 0, :, : w // 5] += 40
    f[:, 1, : h // 4] -= 40
    return torch.from_numpy(f)


@pytest.mark.parametrize("scale", [3.0, 600.0])
@pytest.mark.parametrize("flow_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("plane", sorted(PLANES))
def test_emulated_phase1_equals_update_matrices_xla(plane, flow_dtype, scale):
    r0, r1 = _level0(plane)
    b, _, h, w = r0.shape
    flow = _flow(b, h, w, seed=len(plane), scale=scale).to(getattr(torch, flow_dtype))
    ref = F.update_matrices_xla(r0, r1, flow)
    assert ref.dtype == flow.dtype          # bf16 M from a bf16 flow
    got = matrices_split(r0, r1, flow, bf=flow.dtype == BF16)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref.float(), atol=0, rtol=0)


def test_the_two_flow_dtypes_round_apart():
    # the bf16 arithmetic of the first iteration is not the float32 one: a
    # kernel that widened the bf16 flow would differ from the plain version
    r0, r1 = _level0("40x261")
    flow = _flow(*r0.shape[:1], *r0.shape[2:], seed=1).to(BF16)
    assert not torch.equal(F.update_matrices_xla(r0, r1, flow).float(),
                           F.update_matrices_xla(r0, r1, flow.float()))
    assert not torch.equal(matrices_split(r0, r1, flow, bf=True),
                           matrices_split(r0, r1, flow, bf=False))


@pytest.mark.parametrize("h,w", [(1, 1), (3, 7), (9, 9), (10, 11), (40, 261),
                                 (64, 64), (300, 20), (8, 1030)])
def test_bf16_border_scale_is_the_rounded_float32_map(h, w):
    """The split route's border scale, the float64 ramp map cast to bf16
    (ops/farneback.py: _border_scale), equals round_bf16(float32(map)) at
    every cell, which is how the kernel forms it from the per-axis weights
    of farneback.cuh: edge_weight."""
    like = torch.zeros((), dtype=BF16)
    scale = F._border_scale(h, w, like)
    assert scale.dtype == BF16
    kernel = rb(torch.from_numpy(np.outer(edge_weights(h), edge_weights(w))).float())
    np.testing.assert_array_equal(np.outer(edge_weights(h), edge_weights(w)),
                                  F._border_scale_map(h, w))
    torch.testing.assert_close(scale.float(), kernel, atol=0, rtol=0)


def test_cpu_wrapper_counts_no_launch_and_refuses_bad_inputs():
    r0, r1 = _level0("64x64")
    flow = _flow(*r0.shape[:1], *r0.shape[2:], seed=3).to(BF16)
    before = dict(K.LAUNCHES)
    out = F.split_iterate(r0, r1, flow, 3, 5)
    assert K.LAUNCHES == before           # a CPU tensor: the plain version
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, F.split_iterate_plain(r0, r1, flow, 3, 5),
                               atol=0, rtol=0)
    with pytest.raises(ValueError):
        F.split_iterate(r0[:, :4], r1[:, :4], flow, 1, 5)
    with pytest.raises(ValueError):
        F.split_iterate(r0, r1[:-1], flow[:-1], 1, 5)
    with pytest.raises(ValueError):
        F.split_iterate(r0, r1, flow[:, :1], 1, 5)
    meta = torch.empty(r0.shape, dtype=BF16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        F.split_iterate(meta, meta, flow.to("meta"), 1, 5)
    assert K.LAUNCHES == before


def _uf_takes(winsize):
    """Whether K-uf, which ran the split route's phase 2 before, takes a
    winsize: its 16 x 32 tile with a halo of r in 227 KB (csrc/uf.cu:
    fdt_update_flow_smem, farneback.cuh: tile_smem_bytes)."""
    r = winsize // 2
    return 4 * 5 * (32 + 2 * r) * (16 + 2 * r) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("h,w", [(4096, 4096), (256, 256), (512, 261), (40, 4096)])
def test_plan_split_takes_every_winsize_uf_took(h, w):
    """plan_umuf (two blocks an SM) stops short of K-uf's largest winsize
    on a large plane; plan_split goes on at one block an SM, to the same
    limit, and equals plan_umuf wherever plan_umuf plans."""
    largest_uf = max(ws for ws in range(1, 200) if _uf_takes(ws))
    assert largest_uf == 85
    for ws in range(1, largest_uf + 1):
        for iters, k in ((3, None), (3, 1), (1, None)):
            plan = plan_split(h, w, ws, iters, k)
            assert sum(plan.launches) == iters
            assert plan.smem == umuf_smem_bytes(h, w, ws, plan.per_launch,
                                                plan.tile_y, plan.tile_x)
            assert plan.smem <= SMEM_PER_BLOCK
            try:
                two_blocks = plan_umuf(h, w, ws, iters, k)
            except ValueError:
                assert plan.smem > SMEM_TWO_BLOCKS
            else:
                assert plan == two_blocks
    if h == w == 4096:
        with pytest.raises(ValueError, match="halo"):
            plan_umuf(h, w, largest_uf, 1)      # the planners differ here
        with pytest.raises(ValueError, match="halo"):
            plan_split(h, w, largest_uf + 2, 1)


def test_plan_split_at_the_main_path():
    # winsize 5, 3 iterations: one launch a level, as K-umuf's plan
    for s in (512, 256, 128, 64, 32):
        assert plan_split(s, s, 5, 3) == plan_umuf(s, s, 5, 3)
        assert plan_split(s, s, 5, 3).launches == (3,)

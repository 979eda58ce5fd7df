"""The port's bf16 fast mode, pass and end to end, against the JAX
package's TPU path on the CPU (the oracles of tests/test_torch_bf16.py's
docstring, for whole passes):

- a solve-mode pass and a 3-pass ``denoise`` at ``dtype`` and
  ``precision`` bfloat16 against an oracle that runs the TPU path's pass
  (``core/axis_filter.py: of_pass_padded``, the prepped branch) eagerly:
  ``prepped_tap_solver`` and the Pallas sampler in interpret mode, the bf16
  roundings of the tap loop written out;
- the compose pass (the README's fast mode: compose, symmetric adjacent
  flows, bf16) against the ``flow_from_pyramids`` level loop (the Pallas
  levels packed in interpret mode, the tiny ones on the split XLA
  iteration) plus the prepped compose tap chain;
- the JAX package's own CPU path at bf16, which is not that algorithm.

The PSNR bars are set by measurement on these inputs (the measured value
is printed); for scale, each test reports the oracle's own bf16 against
float32 PSNR, and the port must be closer to the bf16 oracle than that.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_blob_volume
from ref_pipeline import psnr
from flowdenoising_tpu.config import Boundary as JBoundary
from flowdenoising_tpu.config import FilterConfig as JFilterConfig
from flowdenoising_tpu.config import FlowConfig as JFlowConfig
from flowdenoising_tpu.core.axis_filter import of_pass_padded as j_of_pass_padded
from flowdenoising_tpu.core.axis_filter import pad_stack as j_pad_stack
from flowdenoising_tpu.kernels import get_gaussian_kernels as j_kernels
from flowdenoising_tpu.ops import farneback as JF
from flowdenoising_tpu.ops import resize as JR
from flowdenoising_tpu.ops.pallas import compose as PC
from flowdenoising_tpu.ops.pallas import umuf as JU
from flowdenoising_tpu.ops.pallas.sample import bilinear_displace_pallas

from flowdenoising_tpu_torch.config import from_reference
from flowdenoising_tpu_torch.core.axis_filter import of_pass_padded
from flowdenoising_tpu_torch.core.pipeline import denoise

torch.set_num_threads(1)

SIGMA = 0.5           # 5 taps: two a run
FAST = dict(max_displacement=4, dtype="bfloat16", precision="bfloat16")
# The pass dtype's views of the pipeline (flowdenoising_tpu/core/pipeline.py:
# _axis_views): forward and inverse transposes of the Z, Y and X passes.
VIEWS = [((0, 1, 2), (0, 1, 2)), ((1, 0, 2), (1, 0, 2)), ((2, 0, 1), (1, 2, 0))]


def jax_solve_pass(padded, taps, jc):
    """The TPU path's solve-mode pass (axis_filter.py:126-211, the prepped
    branch), eagerly: its tap scan as a loop, with the same roundings."""
    dtype = jnp.dtype(jc.dtype)
    padded = jnp.asarray(padded).astype(dtype)
    ks2 = len(taps) // 2
    n = padded.shape[0] - 2 * ks2
    acc = padded[ks2:ks2 + n] * jnp.asarray(taps[ks2], dtype)
    solver = JF.prepped_tap_solver(padded, ks2, n, jc, interpret=True)
    for sign in (-1, +1):
        prev = jnp.zeros((n, 2) + padded.shape[1:], dtype)
        for j in range(1, ks2 + 1):
            start = ks2 + sign * j
            flow = solver(start, prev).astype(dtype)
            warped = bilinear_displace_pallas(
                padded[start:start + n], flow[:, 0], flow[:, 1],
                jc.max_displacement, interpret=True)
            acc = acc + (warped * jnp.asarray(taps[ks2 + sign * j], dtype)
                         ).astype(dtype)
            prev = flow
    return np.asarray(acc.astype(jnp.float32))


def jax_levels(r0_levels, r1_levels, jc, zero_dtype=None):
    """flow_from_pyramids' level loop (ops/farneback.py:333-350) with
    _iterate_level's two routes on the TPU: the split XLA iteration on tiny
    levels, the Pallas kernel (interpret mode, packed at bf16 precision) on
    the others, each fed ``flow.astype(r0.dtype)``.  The coarsest level
    starts from zeros of ``zero_dtype`` (the JAX package's: the pyramid
    dtype)."""
    packed = jc.precision == "bfloat16"
    flow = None
    for k in range(len(r0_levels) - 1, -1, -1):
        r0, r1 = r0_levels[k], r1_levels[k]
        hk, wk = r0.shape[-3], r0.shape[-2]
        if flow is None:
            flow = jnp.zeros(r0.shape[:-1] + (2,), zero_dtype or r0.dtype)
        else:
            f = JR.resize_linear(jnp.moveaxis(flow, -1, -3), (hk, wk))
            flow = jnp.moveaxis(f * (1.0 / jc.pyr_scale), -3, -1)
        d = JF._level_displacement(jc, k)
        if d <= JF._XLA_LEVEL_MAX_D and hk * wk <= JF._XLA_LEVEL_AREA:
            flow = JF._small_level_iterate(r0, r1, flow, jc, d)
        else:
            flow = JU.umuf_iterate(r0, r1, flow.astype(r0.dtype), jc.iterations,
                                   d, jc.winsize, interpret=True, packed=packed)
    return flow


def jax_compose_pass(padded, taps, jc, zero_dtype=None):
    """The TPU path's compose pass (axis_filter.py:232-317, the prepped
    branch) with symmetric adjacent flows: one adjacent solve, then the
    prepped tap chain with its bf16 carry rounding."""
    dtype = jnp.dtype(jc.dtype)
    padded = jnp.asarray(padded).astype(dtype)
    ks2 = len(taps) // 2
    n, w = padded.shape[0] - 2 * ks2, padded.shape[2]
    d = jc.max_displacement
    adj_cfg = dataclasses.replace(
        jc, max_displacement=min(d, jc.adjacent_displacement))
    r = JF.polyexp_pyramid(padded, jc)
    fwd = jax_levels([x[:-1] for x in r], [x[1:] for x in r], adj_cfg,
                     zero_dtype).astype(dtype)
    kw = dict(packed=jc.precision == "bfloat16", eo=False)
    tiles = PC.compose_plan(padded.shape[1], w, d, False)
    nb_tiles = PC.prep_compose_src(padded[:, None], d, w, tiles=tiles, **kw)
    carry = PC.init_compose_carry(padded[ks2:ks2 + n], taps[ks2], tiles, w,
                                  dtype)
    for sign, adj, shift in ((-1, -fwd, 0), (+1, fwd, -1)):
        link_tiles = PC.prep_compose_src(jnp.moveaxis(adj, -1, -3), d, w,
                                         tiles=tiles, **kw)
        for j in range(1, ks2 + 1):
            start = ks2 + sign * j
            carry = PC.compose_tap_prepped(
                link_tiles, nb_tiles, carry, tiles,
                jnp.asarray(taps[ks2 + sign * j], dtype),
                jnp.int32(start + shift), jnp.int32(start), d=d, w=w,
                dtype=dtype, interpret=True, **kw)
        carry = PC.reset_compose_flow(carry)
    return np.asarray(PC.finish_compose_carry(carry, w))


@pytest.fixture(scope="module")
def vol():
    # the Z pass's 64^2 planes: at D 4 the 64^2 level is packed (d 5) and
    # the 32^2 level takes the tiny route (d 3); the Y and X passes' 6 x 64
    # planes are one packed level
    return make_blob_volume(6, 64, 64, seed=2)


@pytest.fixture(scope="module")
def fast_cfg():
    return JFilterConfig(sigma=(SIGMA,) * 3, flow=JFlowConfig(**FAST))


@pytest.fixture(scope="module")
def solve_oracle(vol, fast_cfg):
    """The oracle's 3-pass denoise of ``vol`` and its Z pass's padded input
    and output."""
    out, z_pass = np.asarray(vol, np.float32), None
    for (fwd, inv), taps in zip(VIEWS, j_kernels(fast_cfg.sigma)):
        padded = j_pad_stack(jnp.transpose(jnp.asarray(out), fwd),
                             len(taps) // 2, fast_cfg.boundary)
        passed = jax_solve_pass(padded, taps, fast_cfg.flow)
        z_pass = z_pass or (np.asarray(padded), passed)
        out = np.transpose(passed, inv)
    return out, z_pass


def test_solve_pass_matches_tpu_oracle(solve_oracle, fast_cfg):
    padded, ref = solve_oracle[1]
    taps = j_kernels(fast_cfg.sigma)[0]
    out = of_pass_padded(torch.from_numpy(padded), taps,
                         from_reference(fast_cfg.flow))
    assert out.dtype == torch.float32
    value = psnr(out.numpy(), ref)
    print(f"bf16 solve pass vs TPU oracle: PSNR {value:.2f} dB, max abs "
          f"{np.abs(out.numpy() - ref).max():.3g}")
    assert value >= 85.0, value


def test_denoise_matches_tpu_oracle(vol, solve_oracle, fast_cfg):
    ref = solve_oracle[0]
    out = denoise(torch.from_numpy(vol), from_reference(fast_cfg)).numpy()
    # the float32 side: the port's float32 denoise, which holds the JAX
    # package's at > 100 dB (tests/test_torch_pipeline.py)
    f32 = denoise(torch.from_numpy(vol), from_reference(dataclasses.replace(
        fast_cfg, flow=JFlowConfig(max_displacement=4)))).numpy()
    value, scale = psnr(out, ref), psnr(ref, f32)
    print(f"bf16 denoise vs TPU oracle: PSNR {value:.2f} dB; the oracle vs "
          f"the float32 denoise: {scale:.2f} dB")
    assert value >= 75.0, value
    assert value > scale


@pytest.mark.parametrize("zero_dtype,bar", [(jnp.float32, 80.0), (None, 70.0)],
                         ids=["port_tiny_level", "jax_tiny_level"])
def test_compose_fast_pass_matches_tpu_oracle(vol, fast_cfg, zero_dtype, bar):
    # The port runs the adjacent solves' tiny coarsest level as the prepped
    # solver does, from a float32 zero flow.  The JAX package starts it from
    # zeros in the pyramid dtype, which runs that level's split iteration in
    # bf16 arithmetic: a divergence of the reference, measured here too.
    taps = j_kernels(fast_cfg.sigma)[0]
    padded = np.asarray(j_pad_stack(jnp.asarray(vol), len(taps) // 2,
                                    JBoundary.WRAP))
    jc = dataclasses.replace(fast_cfg.flow, tap_mode="compose",
                             symmetric_adjacent=True)
    ref = jax_compose_pass(padded, taps, jc, zero_dtype)
    out = of_pass_padded(torch.from_numpy(padded), taps, from_reference(jc))
    value = psnr(out.numpy(), ref)
    print(f"bf16 compose pass vs TPU oracle ({'float32' if zero_dtype else 'bf16'}"
          f" zero flow at the tiny level): PSNR {value:.2f} dB, max abs "
          f"{np.abs(out.numpy() - ref).max():.3g}")
    assert value >= bar, value


def test_jax_cpu_path_diverges(solve_oracle, fast_cfg):
    # JAX's own bf16 pass on the CPU packs nothing and runs Farneback and
    # the windowed warps in bf16 arithmetic: not the TPU path's algorithm
    padded, ref = solve_oracle[1]
    taps = j_kernels(fast_cfg.sigma)[0]
    cpu = np.asarray(j_of_pass_padded(jnp.asarray(padded), taps, fast_cfg.flow))
    out = of_pass_padded(torch.from_numpy(padded), taps,
                         from_reference(fast_cfg.flow)).numpy()
    cpu_db, port_db = psnr(cpu, ref), psnr(out, ref)
    print(f"bf16 solve pass vs TPU oracle: JAX CPU path {cpu_db:.2f} dB, "
          f"port {port_db:.2f} dB")
    assert cpu_db + 10.0 < port_db

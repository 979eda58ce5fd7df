"""The functions the port took on with the JAX package's API, against the
JAX package's on the CPU, on inputs made from a NumPy seed:

- ``of_pass`` and ``gaussian_pass`` for the wrap, mean and replicate
  boundaries, in solve and compose mode, at atol 1e-4 * max|ref| (the bar
  tests/test_torch_pipeline.py holds passes to); ``of_pass`` at dtype
  bfloat16 against the JAX package's TPU path, run eagerly with its Pallas
  kernels in interpret mode (the oracle of tests/test_torch_bf16_pass.py;
  the JAX package's own CPU path at bf16 is another algorithm), at atol 0;
- ``box_blur`` in float32 and bfloat16;
- ``bilinear_displace_windowed`` on shapes that broadcast, atol 2e-4;
- ``prepped_tap_solver`` against the JAX package's ``farneback_flow`` of
  the same slices (``flow_from_pyramids``, which its ``prepped_tap_solver``
  equals), at the flow bars: max 1e-3 px, mean 1e-5 px;
- ``psnr``, ``ssim`` and ``ssim_slice`` within 1e-12 relative, on planes
  smaller than SSIM's 11-tap window too, and the cases of
  tests/test_metrics.py;
- ``of_pass`` and ``gaussian_pass`` against the cv2 oracle
  tests/ref_pipeline.py, the cases of tests/test_filter.py at its bars.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ref_pipeline as R
from conftest import make_blob_image, make_blob_volume
from test_torch_bf16_pass import jax_solve_pass
from flowdenoising_tpu.config import Boundary as JBoundary
from flowdenoising_tpu.config import FlowConfig as JFlowConfig
from flowdenoising_tpu.core.axis_filter import gaussian_pass as j_gaussian_pass
from flowdenoising_tpu.core.axis_filter import of_pass as j_of_pass
from flowdenoising_tpu.core.axis_filter import pad_stack as j_pad_stack
from flowdenoising_tpu.kernels import get_gaussian_kernel
from flowdenoising_tpu.ops.blur import box_blur as j_box_blur
from flowdenoising_tpu.ops.farneback import farneback_flow as j_farneback_flow
from flowdenoising_tpu.ops.warp import (
    bilinear_displace_windowed as j_bilinear_displace_windowed)
from flowdenoising_tpu.utils import metrics as JM

import flowdenoising_tpu_torch as T
from flowdenoising_tpu_torch.config import Boundary, FlowConfig, from_reference
from flowdenoising_tpu_torch.core.axis_filter import gaussian_pass, of_pass
from flowdenoising_tpu_torch.ops.blur import box_blur
from flowdenoising_tpu_torch.ops.farneback import prepped_tap_solver
from flowdenoising_tpu_torch.ops.warp import (
    bilinear_displace_windowed, warp_slices)
from flowdenoising_tpu_torch.utils import metrics as TM

torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(scope="module")
def vol():
    return make_blob_volume(8, 40, 36, seed=3)


def _close_to_max(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("boundary", list(JBoundary))
def test_gaussian_pass_matches_jax(vol, boundary):
    taps = get_gaussian_kernel(1.0)
    ref = j_gaussian_pass(jnp.asarray(vol), taps, boundary, mean_val=None)
    out = gaussian_pass(vol, taps, Boundary(boundary.value), device=CPU)
    assert out.dtype == torch.float32 and out.shape == vol.shape
    _close_to_max(out.numpy(), ref)


# (boundary, tap mode, the port's bound, the JAX package's bound).  The
# port's bound D 4 in the replicate and mean boundaries is held against the
# JAX package's unbounded gather: those pads make pairs of identical or
# constant planes, whose flow is near singular (G ~ 0; cv2 itself returns
# 2.2 px between two equal planes), so it amplifies the rounding of the
# sampling coordinate ~1e3-fold.  The port, like the JAX package's TPU
# kernels, its exact gather and cv2.remap, forms x + u in float32; the JAX
# package's CPU path with a bound (the windowed form) weighs |u - s| and
# never does, and lands elsewhere there
# (test_degenerate_pair_follows_the_exact_gather).  With |flow| < D, as on
# this volume, the bounded and the unbounded function are the same.
OF_CASES = [(b, mode, d, jd) for mode in ("solve", "compose")
            for b, d, jd in ((JBoundary.WRAP, 4, 4), (JBoundary.WRAP, None, None),
                             (JBoundary.MEAN, 4, None),
                             (JBoundary.REPLICATE, 4, None))]


@pytest.mark.parametrize(
    "boundary,tap_mode,bound,jax_bound", OF_CASES,
    ids=[f"{b.value}-{m}-D{d}-jaxD{jd}" for b, m, d, jd in OF_CASES])
def test_of_pass_matches_jax(vol, boundary, tap_mode, bound, jax_bound):
    taps = get_gaussian_kernel(0.5)
    jc = JFlowConfig(levels=2, min_size=8, max_displacement=jax_bound,
                     tap_mode=tap_mode)
    ref = j_of_pass(jnp.asarray(vol), taps, jc, boundary)
    ours = dataclasses.replace(from_reference(jc), max_displacement=bound)
    out = of_pass(torch.from_numpy(vol), taps, ours, Boundary(boundary.value))
    assert out.dtype == torch.float32 and out.shape == vol.shape
    _close_to_max(out.numpy(), ref)


def test_degenerate_pair_follows_the_exact_gather(vol):
    # vol[0] and vol[2] are the same plane (the blob field moves by whole
    # pixels): the port's bounded flow is the JAX package's unbounded one,
    # at the flow bars, while the JAX package's own bounded CPU flow lands
    # elsewhere
    assert np.array_equal(vol[0], vol[2])
    pair = [jnp.asarray(vol[None, 0]), jnp.asarray(vol[None, 2])]
    jc = JFlowConfig(levels=2, min_size=8, max_displacement=4)
    exact = np.asarray(j_farneback_flow(
        *pair, dataclasses.replace(jc, max_displacement=None)))
    windowed = np.asarray(j_farneback_flow(*pair, jc))
    out = T.farneback_flow(vol[None, 0], vol[None, 2], from_reference(jc),
                           device=CPU).numpy()
    err = np.abs(out - exact)
    assert err.max() < 1e-3 and err.mean() < 1e-5, (err.max(), err.mean())
    assert np.abs(windowed - exact).max() > 0.05


def test_of_pass_mean_value_given(vol):
    taps = get_gaussian_kernel(0.5)
    jc = JFlowConfig(levels=1, min_size=8, max_displacement=None)
    ref = j_of_pass(jnp.asarray(vol), taps, jc, JBoundary.MEAN, mean_val=7.5)
    out = of_pass(vol, taps, dataclasses.replace(from_reference(jc),
                                                 max_displacement=4),
                  Boundary.MEAN, mean_val=7.5, device=CPU)
    _close_to_max(out.numpy(), ref)


def test_of_pass_bf16_matches_tpu_path(vol):
    # the stack cast to bf16 before the pad, as the JAX package's of_pass
    taps = get_gaussian_kernel(0.5)
    jc = JFlowConfig(levels=1, min_size=8, max_displacement=4,
                     dtype="bfloat16", precision="bfloat16")
    padded = j_pad_stack(jnp.asarray(vol).astype(jnp.bfloat16),
                         len(taps) // 2, JBoundary.WRAP)
    ref = jax_solve_pass(padded, taps, jc)
    out = of_pass(vol, taps, from_reference(jc), device=CPU)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("winsize", [4, 5])
def test_box_blur_matches_jax(dtype, winsize):
    img = make_blob_image(20, 23, seed=4)[None].repeat(2, 0)
    ref = np.asarray(j_box_blur(jnp.asarray(img).astype(dtype), winsize)
                     .astype(jnp.float32))
    out = box_blur(torch.from_numpy(img).to(getattr(torch, dtype)), winsize)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(out.float().numpy(), ref)


@pytest.mark.parametrize("img_shape,uv_shape", [
    ((2, 3, 24, 31), (2, 1, 24, 31)),    # one flow per batch, C planes
    ((24, 31), (3, 24, 31)),             # one image, three flows
    ((3, 24, 31), (24, 31)),             # three images, one flow
    ((2, 3, 24, 31), (3, 24, 31)),       # flows broadcast over the batch
], ids=["channels", "image_broadcast", "flow_broadcast", "leading_broadcast"])
def test_bilinear_displace_windowed_broadcasts(img_shape, uv_shape):
    r = np.random.default_rng(len(img_shape) + len(uv_shape))
    n = int(np.prod(img_shape[:-2]))
    base = make_blob_image(24 + n, 31 + n, seed=9)
    img = np.stack([base[i:i + 24, i:i + 31] for i in range(n)]
                   ).reshape(img_shape).astype(np.float32)
    u = (r.normal(size=uv_shape) * 2).astype(np.float32)
    v = (r.normal(size=uv_shape) * 2).astype(np.float32)
    u[..., :6, :] += 9      # a band beyond the bound
    ref = np.asarray(j_bilinear_displace_windowed(
        jnp.asarray(img), jnp.asarray(u), jnp.asarray(v), 3))
    out = bilinear_displace_windowed(torch.from_numpy(img), torch.from_numpy(u),
                                     torch.from_numpy(v), 3)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4)


@pytest.mark.parametrize("seeded", [False, True])
def test_prepped_tap_solver_matches_jax(seeded):
    r = np.random.default_rng(4)
    base = make_blob_image(40, 44, seed=5)
    stack = np.stack([base[i:i + 40, 2 * i:2 * i + 44] for i in range(7)])
    stack += r.normal(size=stack.shape).astype(np.float32)
    jc = JFlowConfig(levels=2, min_size=8)
    init = (r.normal(size=(3, 2, 40, 44)) * 0.3).astype(np.float32)
    solve = prepped_tap_solver(torch.from_numpy(stack), 2, 3, from_reference(jc),
                               interpret=True)
    start = 4
    out = solve(start, torch.from_numpy(init) if seeded else None)
    assert out.shape == (3, 2, 40, 44) and out.dtype == torch.float32
    ref = j_farneback_flow(jnp.asarray(stack[start:start + 3]),
                           jnp.asarray(stack[2:5]), jc,
                           jnp.asarray(np.moveaxis(init, 1, -1)) if seeded else None)
    err = np.abs(out.permute(0, 2, 3, 1).numpy() - np.asarray(ref))
    assert err.max() < 1e-3, err.max()
    assert err.mean() < 1e-5, err.mean()


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("shape", [(4, 4), (7, 13), (3, 7, 13), (2, 24, 20)])
def test_metrics_match_jax(shape):
    r = np.random.default_rng(int(np.prod(shape)))
    a = r.normal(size=shape) * 30 + 100
    b = a + r.normal(size=shape) * 5
    assert _rel(TM.psnr(a, b, device=CPU), JM.psnr(a, b)) <= 1e-12
    assert _rel(TM.psnr(a, b, peak=255.0, device=CPU),
                JM.psnr(a, b, peak=255.0)) <= 1e-12
    assert _rel(TM.ssim(a, b, device=CPU), JM.ssim(a, b)) <= 1e-12
    assert _rel(TM.ssim(a, b, peak=255.0, device=CPU),
                JM.ssim(a, b, peak=255.0)) <= 1e-12
    plane = (a if a.ndim == 2 else a[0]).astype(np.float32)
    other = (b if b.ndim == 2 else b[0]).astype(np.float32)
    assert _rel(TM.ssim_slice(torch.from_numpy(plane), torch.from_numpy(other),
                              80.0),
                JM.ssim_slice(plane, other, 80.0)) <= 1e-12


# tests/test_metrics.py, on the port

def test_psnr_identity_and_scaling():
    a = np.random.default_rng(0).normal(size=(4, 16, 16)).astype(np.float32)
    assert TM.psnr(a, a, device=CPU) == float("inf")
    p1 = TM.psnr(a, a + 0.01, device=CPU)
    p2 = TM.psnr(a, a + 0.1, device=CPU)
    assert p1 > p2
    assert abs((p1 - p2) - 20.0) < 1e-2  # 10x noise = 20 dB (f32 rounding)


def test_ssim_identity_and_monotonicity():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(32, 32)).astype(np.float64)
    assert abs(TM.ssim(a, a, device=CPU) - 1.0) < 1e-12
    s1 = TM.ssim(a, a + rng.normal(scale=0.05, size=a.shape), device=CPU)
    s2 = TM.ssim(a, a + rng.normal(scale=0.5, size=a.shape), device=CPU)
    assert 0 < s2 < s1 < 1


def test_ssim_volume():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(3, 24, 24))
    b = a + rng.normal(scale=0.1, size=a.shape)
    s = TM.ssim(a, b, device=CPU)
    assert 0 < s < 1


# tests/test_filter.py's cases against the cv2 oracle, on the port

SIGMA = 0.5
L = 3
W = 5
TOL_MAX = 1.0
TOL_MEAN = 0.02


def _filter_vol():
    return make_blob_volume(12, 36, 40, seed=1)


def test_gaussian_pass_wrap_matches_reference_math():
    vol = _filter_vol()
    k = get_gaussian_kernel(2.0)
    ours = gaussian_pass(vol, k, Boundary.WRAP, device=CPU).numpy()
    ref = R.gaussian_filter_axis_wrap(vol, k, 0)
    np.testing.assert_allclose(ours, ref, atol=2e-3)


def test_of_pass_wrap_matches_reference_seeded():
    vol = _filter_vol()
    k = get_gaussian_kernel(SIGMA)
    cfg = FlowConfig(levels=L, winsize=W, use_initial_flow=True)
    ours = of_pass(vol, k, cfg, Boundary.WRAP, device=CPU).numpy()
    ref = R.of_filter_axis_wrap(vol, k, 0, L, W, seeded=True)
    err = np.abs(ours - ref)
    assert err.max() < TOL_MAX, err.max()
    assert err.mean() < TOL_MEAN, err.mean()


@pytest.mark.slow
def test_of_pass_meanpad_matches_sequential():
    vol = _filter_vol()
    k = get_gaussian_kernel(SIGMA)
    mean = vol.mean()
    cfg = FlowConfig(levels=L, winsize=W, use_initial_flow=True)
    ours = of_pass(vol, k, cfg, Boundary.MEAN, mean_val=mean, device=CPU).numpy()
    ref = R.of_filter_axis_meanpad(vol, k, 0, L, W, mean, seeded=True)
    err = np.abs(ours - ref)
    assert err.max() < TOL_MAX
    assert err.mean() < TOL_MEAN


def test_tiny_axis_wrap_kernel_longer_than_axis():
    vol = make_blob_volume(4, 36, 40, seed=3)
    k = get_gaussian_kernel(2.0)
    ours = gaussian_pass(vol, k, Boundary.WRAP, device=CPU).numpy()
    ref = R.gaussian_filter_axis_wrap(vol, k, 0)
    np.testing.assert_allclose(ours, ref, atol=2e-3)


@pytest.mark.slow
def test_tiny_axis_of_wrap_kernel_longer_than_axis():
    vol = make_blob_volume(4, 36, 40, seed=4)
    k = get_gaussian_kernel(2.0)
    cfg = FlowConfig(levels=0, winsize=W, use_initial_flow=True)
    ours = of_pass(vol, k, cfg, Boundary.WRAP, device=CPU).numpy()
    ref = R.of_filter_axis_wrap(vol, k, 0, 0, W, seeded=True)
    err = np.abs(ours - ref)
    assert err.max() < TOL_MAX, err.max()
    assert err.mean() < TOL_MEAN, err.mean()


def test_bilinear_displace_windowed_is_warp_slices():
    # the same function as the bounded warp, on the port's one sampler
    r = np.random.default_rng(12)
    img = make_blob_image(30, 30, seed=12)[None, 2:32, 2:32].copy()
    flow = (r.normal(size=(1, 30, 30, 2)) * 3).astype(np.float32)
    a = bilinear_displace_windowed(img, flow[..., 0], flow[..., 1], 2, device=CPU)
    b = warp_slices(img, flow, 2, sampler="windowed", device=CPU)
    torch.testing.assert_close(a, b, atol=0, rtol=0)

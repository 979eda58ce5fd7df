"""The port's compose tap mode against the JAX package's, on the CPU.

- K-compose's plain version (``compose_tap_plain``, what the wrapper runs on
  a CPU tensor) against the Pallas kernel in interpret mode and against the
  unfused step of the JAX package (windowed sampler; exact gather for no
  bound), at the tolerances of tests/test_pallas_compose.py: flow atol
  1e-5, accumulator atol 1e-4.
- The wrapper's batch offsets into whole stacks, and its in-place update.
- The compose pass: a kernel with only adjacent taps equals solve mode
  (as tests/test_compose.py); ``denoise`` against JAX ``denoise`` in every
  boundary, with ``symmetric_adjacent`` and with no bound, at PSNR >= 55 dB
  (the repo's end-to-end bar); slabs bitwise equal to the whole axis; a CLI
  MRC round trip.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` and by tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_blob_volume
from ref_pipeline import psnr
from flowdenoising_tpu.config import Boundary as JBoundary
from flowdenoising_tpu.config import FilterConfig as JFilterConfig
from flowdenoising_tpu.config import FlowConfig as JFlowConfig
from flowdenoising_tpu.core.pipeline import denoise as j_denoise
from flowdenoising_tpu.ops.pallas.compose import compose_tap_pallas
from flowdenoising_tpu.ops.warp import displace_sample as j_displace_sample
from flowdenoising_tpu.ops.warp import warp_slices as j_warp_slices

from flowdenoising_tpu_torch import cli
from flowdenoising_tpu_torch.config import FilterConfig, FlowConfig, from_reference
from flowdenoising_tpu_torch.core.axis_filter import of_pass_padded, pad_stack
from flowdenoising_tpu_torch.core.pipeline import denoise
from flowdenoising_tpu_torch.io.mrc import read_mrc, write_mrc
from flowdenoising_tpu_torch.kernels import get_gaussian_kernel
from flowdenoising_tpu_torch.ops import cuda as K
from flowdenoising_tpu_torch.ops.compose import compose_tap, compose_tap_plain

torch.set_num_threads(1)

FLOW_ATOL = 1e-5
ACC_ATOL = 1e-4
PSNR_BAR = 55.0


def _setup(b=2, h=24, w=40, seed=0, scale=1.5):
    """The inputs of tests/test_pallas_compose.py: channels-last link and
    flow, neighbour of scale ~50."""
    r = np.random.default_rng(seed)
    link = (r.normal(size=(b, h, w, 2)) * 0.6).astype(np.float32)
    flow = (r.normal(size=(b, h, w, 2)) * scale).astype(np.float32)
    neighbor = r.normal(size=(b, h, w)).astype(np.float32) * 50
    acc = r.normal(size=(b, h, w)).astype(np.float32)
    return link, flow, neighbor, acc


def _cf(a):
    """Channels-last (B, H, W, 2) numpy -> the port's (B, 2, H, W) tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _port_step(link, flow, neighbor, acc, weight, d):
    fo, ao = compose_tap_plain(_cf(link), _cf(flow), torch.from_numpy(neighbor),
                               torch.from_numpy(acc), weight, d)
    return np.moveaxis(fo.numpy(), 1, -1), ao.numpy()


def _jax_unfused_step(link, flow, neighbor, acc, weight, d):
    """The JAX package's unfused compose step (axis_filter.py:340-345)."""
    link, flow = jnp.asarray(link), jnp.asarray(flow)
    warped_link = j_displace_sample(jnp.moveaxis(link, -1, -3), flow[..., 0],
                                    flow[..., 1], d, "windowed")
    flow = flow + jnp.moveaxis(warped_link, -3, -1)
    warped = j_warp_slices(jnp.asarray(neighbor), flow, d, "windowed")
    return np.asarray(flow), np.asarray(jnp.asarray(acc) + warped * weight)


def _jax_pallas_step(link, flow, neighbor, acc, weight, d):
    fo, ao = compose_tap_pallas(jnp.asarray(link), jnp.asarray(flow),
                                jnp.asarray(neighbor), jnp.asarray(acc),
                                weight, d, interpret=True)
    return np.asarray(fo), np.asarray(ao)


@pytest.mark.parametrize("ref_step", [_jax_pallas_step, _jax_unfused_step],
                         ids=["pallas_interpret", "unfused_windowed"])
@pytest.mark.parametrize("d,scale,seed,weight", [
    (3, 1.5, 0, 0.13), (6, 1.5, 0, 0.13), (4, 8.0, 3, 0.2)])
def test_plain_step_matches_jax(ref_step, d, scale, seed, weight):
    link, flow, neighbor, acc = _setup(seed=seed, scale=scale)
    fr, ar = ref_step(link, flow, neighbor, acc, weight, d)
    fo, ao = _port_step(link, flow, neighbor, acc, weight, d)
    np.testing.assert_allclose(fo, fr, atol=FLOW_ATOL, rtol=0)
    np.testing.assert_allclose(ao, ar, atol=ACC_ATOL, rtol=0)


@pytest.mark.parametrize("scale", [1.5, 8.0])
def test_unbounded_step_matches_exact_gather(scale):
    # D = None: the JAX package's unfused step samples with the exact gather
    link, flow, neighbor, acc = _setup(seed=5, scale=scale)
    fr, ar = _jax_unfused_step(link, flow, neighbor, acc, 0.17, None)
    fo, ao = _port_step(link, flow, neighbor, acc, 0.17, None)
    np.testing.assert_allclose(fo, fr, atol=FLOW_ATOL, rtol=0)
    np.testing.assert_allclose(ao, ar, atol=ACC_ATOL, rtol=0)


@pytest.mark.parametrize("d", [4, None])
def test_wrapper_offsets_equal_sliced_stacks(d):
    # compose_tap reads the whole stacks at batch offsets, updates flow and
    # acc in place, and counts no launch on the CPU
    r = np.random.default_rng(8)
    n, h, w = 3, 16, 20
    link = torch.from_numpy((r.normal(size=(n + 5, 2, h, w)) * 0.8).astype(np.float32))
    nb = torch.from_numpy((r.normal(size=(n + 6, h, w)) * 40).astype(np.float32))
    flow = torch.from_numpy((r.normal(size=(n, 2, h, w)) * 3).astype(np.float32))
    acc = torch.from_numpy(r.normal(size=(n, h, w)).astype(np.float32))
    fr, ar = compose_tap_plain(link[4:4 + n], flow, nb[5:5 + n], acc,
                               float(np.float32(0.21)), d)
    before = dict(K.LAUNCHES)
    f2, a2 = compose_tap(link, flow, nb, acc, 0.21, d, 4, 5)
    assert K.LAUNCHES == before
    assert f2 is flow and a2 is acc
    torch.testing.assert_close(flow, fr, atol=0, rtol=0)
    torch.testing.assert_close(acc, ar, atol=0, rtol=0)


def test_wrapper_checks_offsets_and_shapes():
    link = torch.zeros(5, 2, 8, 8)
    nb = torch.zeros(6, 8, 8)
    flow = torch.zeros(3, 2, 8, 8)
    acc = torch.zeros(3, 8, 8)
    for ls, ns in ((3, 0), (-1, 0), (0, 4)):
        with pytest.raises(ValueError, match="out of range"):
            compose_tap(link, flow, nb, acc, 0.1, 4, ls, ns)
    with pytest.raises(ValueError, match="expected"):
        compose_tap(link[:, :1], flow, nb, acc, 0.1, 4, 0, 0)
    with pytest.raises(ValueError, match="expected"):
        compose_tap(link, flow, nb, acc[:, :4], 0.1, 4, 0, 0)


def test_adjacent_only_kernel_equals_solve():
    # sigma 0.3: ks2 == 1, every tap is adjacent, and composition reduces
    # to the very solve of solve mode (as tests/test_compose.py)
    taps = get_gaussian_kernel(0.3)
    assert len(taps) // 2 == 1
    vol = torch.from_numpy(make_blob_volume(8, 32, 32, seed=0))
    padded = pad_stack(vol, 1, from_reference(JFilterConfig()).boundary)
    solve = of_pass_padded(padded, taps, FlowConfig(levels=0))
    comp = of_pass_padded(padded, taps, FlowConfig(levels=0, tap_mode="compose"))
    torch.testing.assert_close(comp, solve, atol=1e-4, rtol=0)


def _jax_cfg(boundary, slab_size=None, **flow):
    flow = {"max_displacement": 4, **flow}
    return JFilterConfig(
        sigma=(1.0, 1.0, 1.0), boundary=boundary, slab_size=slab_size,
        flow=JFlowConfig(levels=2, min_size=8, tap_mode="compose", **flow))


@pytest.fixture(scope="module")
def vol():
    return make_blob_volume(10, 48, 40)


@pytest.mark.parametrize("boundary,flow", [
    (JBoundary.WRAP, {}),
    (JBoundary.MEAN, {"symmetric_adjacent": True}),
    (JBoundary.REPLICATE, {"max_displacement": None}),
], ids=["wrap", "mean-symmetric", "replicate-unbounded"])
def test_denoise_compose_matches_jax(vol, boundary, flow):
    # Compose mode is sensitive to rounding where adjacent flows are
    # ill-posed: on a 32^3 blob volume the JAX package's own jitted and
    # eager passes agree at only ~60 dB.  This volume keeps both packages
    # far above the bar (74-84 dB measured).
    jc = _jax_cfg(boundary, **flow)
    ref = np.asarray(j_denoise(vol, jc))
    out = denoise(torch.from_numpy(vol), from_reference(jc))
    assert out.dtype == torch.float32 and out.shape == vol.shape
    value = psnr(out.numpy(), ref)
    print(f"compose denoise {boundary.value} {flow}: PSNR {value:.2f} dB vs JAX")
    assert value >= PSNR_BAR, value


def test_compose_slabs_equal_whole_axis(vol):
    sub = torch.from_numpy(vol[:, :24, :20])
    whole = denoise(sub, from_reference(_jax_cfg(JBoundary.MEAN)))
    slabbed = denoise(sub, from_reference(_jax_cfg(JBoundary.MEAN, slab_size=3)))
    torch.testing.assert_close(slabbed, whole, atol=0, rtol=0)


def test_cli_compose_round_trip_cpu(vol, tmp_path):
    src = tmp_path / "in.mrc"
    dst = tmp_path / "out.mrc"
    write_mrc(src, vol)
    rc = cli.main(["-i", str(src), "-o", str(dst), "-s", "1", "1", "1",
                   "-l", "2", "--max_displacement", "4", "--tap_flow",
                   "compose", "--symmetric_adjacent", "--device", "cpu"])
    assert rc == 0
    data, _ = read_mrc(dst)
    assert data.dtype == np.float32 and data.shape == vol.shape
    cfg = FilterConfig(sigma=(1.0, 1.0, 1.0), flow=FlowConfig(
        levels=2, max_displacement=4, tap_mode="compose",
        symmetric_adjacent=True))
    ref = denoise(vol, cfg, device="cpu").numpy()
    np.testing.assert_array_equal(data, ref)

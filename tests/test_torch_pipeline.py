"""The port's pipeline against the JAX package's, on the CPU, end to end:
denoise in the three boundary modes, the -n Gaussian path, wrap pads
longer than the axis, slabs, the device an array input runs on, and a CLI
MRC round trip on ``--device cpu``.
Agreement bar: PSNR >= 55 dB (the end-to-end bar of tests/test_filter.py).
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
from flowdenoising_tpu.core.axis_filter import pad_stack as j_pad_stack
from flowdenoising_tpu.core.pipeline import denoise as j_denoise
from flowdenoising_tpu.core.pipeline import gaussian_denoise as j_gaussian_denoise

from flowdenoising_tpu_torch import cli
from flowdenoising_tpu_torch.config import Boundary, from_reference
from flowdenoising_tpu_torch.core.axis_filter import pad_stack
from flowdenoising_tpu_torch.core.pipeline import denoise, gaussian_denoise
from flowdenoising_tpu_torch.io.mrc import read_mrc, write_mrc

torch.set_num_threads(1)

PSNR_BAR = 55.0


def _jax_cfg(boundary, slab_size=None):
    return JFilterConfig(sigma=(1.0, 1.0, 1.0), boundary=boundary,
                         flow=JFlowConfig(levels=2, min_size=8, max_displacement=4),
                         slab_size=slab_size)


@pytest.fixture(scope="module")
def vol():
    return make_blob_volume(10, 48, 40)


@pytest.mark.parametrize("boundary", list(JBoundary))
def test_denoise_matches_jax(vol, boundary):
    jc = _jax_cfg(boundary)
    ref = np.asarray(j_denoise(vol, jc))
    out = denoise(torch.from_numpy(vol), from_reference(jc))
    assert out.dtype == torch.float32 and out.shape == vol.shape
    value = psnr(out.numpy(), ref)
    print(f"denoise {boundary.value}: PSNR {value:.2f} dB vs JAX")
    assert value >= PSNR_BAR, value


@pytest.mark.parametrize("boundary", list(JBoundary))
def test_gaussian_denoise_matches_jax(vol, boundary):
    ref = np.asarray(j_gaussian_denoise(vol, (2.0, 1.0, 1.5), boundary))
    out = gaussian_denoise(torch.from_numpy(vol), (2.0, 1.0, 1.5),
                           Boundary(boundary.value)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("boundary", list(JBoundary))
def test_pad_longer_than_axis(boundary):
    r = np.random.default_rng(0)
    short = r.normal(size=(4, 6, 5)).astype(np.float32)
    ref = np.asarray(j_pad_stack(jnp.asarray(short), 9, boundary, 0.25))
    out = pad_stack(torch.from_numpy(short), 9, Boundary(boundary.value), 0.25)
    np.testing.assert_array_equal(out.numpy(), ref)
    # a whole -n pass over the short axis (sigma=2 -> pad 8 > 4 slices)
    ref = np.asarray(j_gaussian_denoise(short, (2.0, 0.5, 0.5), boundary))
    out = gaussian_denoise(torch.from_numpy(short), (2.0, 0.5, 0.5),
                           Boundary(boundary.value)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max())


def test_slabs_equal_whole_axis(vol):
    cfg = from_reference(_jax_cfg(JBoundary.MEAN))
    whole = denoise(torch.from_numpy(vol[:, :24, :20]), cfg)
    cfg_slab = from_reference(_jax_cfg(JBoundary.MEAN, slab_size=3))
    slabbed = denoise(torch.from_numpy(vol[:, :24, :20]), cfg_slab)
    torch.testing.assert_close(slabbed, whole, atol=0, rtol=0)


@pytest.mark.parametrize("fn", [denoise, gaussian_denoise])
def test_array_input_defaults_to_cuda(vol, fn):
    # an array goes to CUDA unless the caller asks for the CPU; with no CUDA
    # device that raises instead of running on the CPU
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test checks a host without it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fn(vol)


@pytest.mark.parametrize("use_flow", [True, False])
def test_array_input_on_cpu_equals_tensor_input(vol, use_flow):
    cfg = from_reference(_jax_cfg(JBoundary.WRAP))
    cfg = dataclasses.replace(cfg, use_flow=use_flow)
    sub = vol[:, :24, :20]
    from_array = denoise(sub, cfg, device="cpu")
    assert from_array.device.type == "cpu"
    torch.testing.assert_close(from_array, denoise(torch.from_numpy(sub), cfg),
                               atol=0, rtol=0)


def test_cli_mrc_round_trip_cpu(vol, tmp_path):
    src = tmp_path / "in.mrc"
    dst = tmp_path / "out.mrc"
    write_mrc(src, vol, voxel_size=(1.5, 1.5, 2.0))
    rc = cli.main(["-i", str(src), "-o", str(dst), "-s", "1", "1", "1",
                   "-l", "2", "-w", "5", "--max_displacement", "4",
                   "--boundary", "replicate", "--device", "cpu"])
    assert rc == 0
    data, hdr = read_mrc(dst)
    assert data.dtype == np.float32 and data.shape == vol.shape
    assert np.allclose(hdr.voxel_size, (1.5, 1.5, 2.0))
    cfg = from_reference(JFilterConfig(
        sigma=(1.0, 1.0, 1.0), boundary=JBoundary.REPLICATE,
        flow=JFlowConfig(levels=2, winsize=5, max_displacement=4)))
    ref = denoise(torch.from_numpy(vol), cfg).numpy()
    np.testing.assert_array_equal(data, ref)

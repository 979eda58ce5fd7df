"""The port's noise estimate and ``--flow_presmooth auto`` policy against
the JAX package's (exactly equal: both are the same NumPy code), and the
presmoothed flow denoise against JAX's ``denoise`` at PSNR >= 55 dB (the
end-to-end bar of tests/test_filter.py)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_blob_volume
from ref_pipeline import psnr
from flowdenoising_tpu.config import FilterConfig as JFilterConfig
from flowdenoising_tpu.config import FlowConfig as JFlowConfig
from flowdenoising_tpu.core import noise as JN
from flowdenoising_tpu.core.axis_filter import _estimation_stack as j_estimation_stack
from flowdenoising_tpu.core.pipeline import denoise as j_denoise

from flowdenoising_tpu_torch.config import FlowConfig, from_reference
from flowdenoising_tpu_torch.core import noise as N
from flowdenoising_tpu_torch.core.axis_filter import _estimation_stack
from flowdenoising_tpu_torch.core.pipeline import denoise

torch.set_num_threads(1)


def _volumes():
    """tests/test_noise.py's volumes: clean, noisy at three sigmas, and the
    two engineered around the decision threshold."""
    clean = make_blob_volume(8, 64, 64, seed=3)
    rng = np.random.default_rng(0)
    vols = [clean] + [clean + rng.normal(scale=s, size=clean.shape).astype(np.float32)
                      for s in (5.0, 20.0, 50.0)]
    clean4 = make_blob_volume(8, 64, 64, seed=4)
    rng = np.random.default_rng(7)
    s = float(clean4.std())
    vols += [clean4 + rng.normal(scale=f * s, size=clean4.shape).astype(np.float32)
             for f in (0.38, 0.55, 0.8)]
    return vols


@pytest.mark.parametrize("i", range(7))
def test_noise_estimate_and_policy_equal_jax(i):
    vol = _volumes()[i]
    assert N.estimate_noise(vol) == JN.estimate_noise(vol)
    assert N._noise_and_spread(vol, 3) == JN._noise_and_spread(vol, 3)
    jcfg = JFilterConfig()
    got = N.resolve_auto_presmooth(vol, from_reference(jcfg))
    want = JN.resolve_auto_presmooth(vol, jcfg)
    assert got.flow.presmooth == want.flow.presmooth
    assert got == from_reference(want)
    assert (N._REL_THRESHOLD, N._AUTO_SIGMA) == (JN._REL_THRESHOLD, JN._AUTO_SIGMA)


@pytest.mark.parametrize("sigma", [0.7, 1.5, 3.0])
def test_estimation_stack_matches_jax(sigma):
    r = np.random.default_rng(1)
    padded = r.normal(size=(5, 20, 23)).astype(np.float32) * 50
    ref = np.asarray(j_estimation_stack(jnp.asarray(padded),
                                        JFlowConfig(presmooth=sigma)))
    out = _estimation_stack(torch.from_numpy(padded), FlowConfig(presmooth=sigma))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3, rtol=1e-5)
    raw = torch.from_numpy(padded)
    assert _estimation_stack(raw, FlowConfig()) is raw


@pytest.mark.parametrize("tap_mode", ["solve", "compose"])
def test_presmoothed_denoise_matches_jax(tap_mode):
    vol = make_blob_volume(10, 48, 40)
    vol = vol + np.random.default_rng(2).normal(0, 30, vol.shape).astype(np.float32)
    jc = JFilterConfig(sigma=(1.0, 1.0, 1.0),
                       flow=JFlowConfig(levels=2, min_size=8, max_displacement=4,
                                        presmooth=1.5, tap_mode=tap_mode))
    ref = np.asarray(j_denoise(vol, jc))
    out = denoise(torch.from_numpy(vol), from_reference(jc)).numpy()
    value = psnr(out, ref)
    print(f"presmoothed {tap_mode} denoise: PSNR {value:.2f} dB vs JAX")
    assert value >= 55.0, value
    # presmooth changes the flows, so the output differs from the
    # unsmoothed run's
    unsmoothed = dataclasses.replace(jc.flow, presmooth=0.0)
    plain = denoise(torch.from_numpy(vol), from_reference(
        dataclasses.replace(jc, flow=unsmoothed))).numpy()
    assert not np.array_equal(out, plain)

"""The port's tensor operations against the JAX package's, on the CPU.

Host-side weight matrices and sizes must match exactly; float32 tensor
results agree within atol = 1e-4 * max|ref| (the two frameworks sum in
different orders).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flowdenoising_tpu import kernels as JK
from flowdenoising_tpu.config import FlowConfig as JFlowConfig
from flowdenoising_tpu.ops import blur as JB
from flowdenoising_tpu.ops import farneback as JF
from flowdenoising_tpu.ops import resize as JR

from flowdenoising_tpu_torch import kernels as TK
from flowdenoising_tpu_torch.config import from_reference
from flowdenoising_tpu_torch.ops import blur as TB
from flowdenoising_tpu_torch.ops import farneback as TF
from flowdenoising_tpu_torch.ops import resize as TR

torch.set_num_threads(1)


def _close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref,
                               atol=1e-4 * float(np.abs(ref).max()), rtol=0)


def _images(shape, seed=0, scale=50.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("n_in,n_out", [(40, 20), (37, 19), (20, 40), (9, 5), (16, 16)])
def test_resize_matrices_exact(n_in, n_out):
    np.testing.assert_array_equal(TR.linear_resize_matrix(n_in, n_out),
                                  JR.linear_resize_matrix(n_in, n_out))
    np.testing.assert_array_equal(TR.area_resize_matrix(n_in, n_out),
                                  JR.area_resize_matrix(n_in, n_out))


@pytest.mark.parametrize("h,w,levels", [(256, 256, 3), (48, 40, 2), (37, 51, 3)])
def test_pyramid_sizes_and_levels_exact(h, w, levels):
    assert TR.pyramid_sizes(h, w, levels, 0.5) == JR.pyramid_sizes(h, w, levels, 0.5)
    jc = JFlowConfig(levels=levels, min_size=8)
    assert from_reference(jc).clamped_levels(h, w) == jc.clamped_levels(h, w)
    assert TR.cv_round(2.5) == JR.cv_round(2.5) == 2


@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.0, 3.3])
def test_gaussian_kernel_exact(sigma):
    np.testing.assert_array_equal(TK.get_gaussian_kernel(sigma),
                                  JK.get_gaussian_kernel(sigma))


@pytest.mark.parametrize("kind,out_hw", [("linear", (12, 10)), ("linear", (48, 50)),
                                         ("area", (12, 10)), ("area", (7, 9))])
def test_resize(kind, out_hw):
    img = _images((3, 24, 20))
    t_fn = TR.resize_linear if kind == "linear" else TR.resize_area
    j_fn = JR.resize_linear if kind == "linear" else JR.resize_area
    _close(t_fn(torch.from_numpy(img), out_hw), j_fn(jnp.asarray(img), out_hw))


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (9, 1.5), (19, 3.5)])
def test_gaussian_blur(ksize, sigma):
    img = _images((2, 17, 23), seed=1)
    _close(TB.gaussian_blur(torch.from_numpy(img), ksize, sigma),
           JB.gaussian_blur(jnp.asarray(img), ksize, sigma))


@pytest.mark.parametrize("winsize", [4, 5, 7])
def test_box_blur_sum(winsize):
    img = _images((2, 5, 13, 11), seed=2)
    _close(TB.box_blur_sum(torch.from_numpy(img), winsize),
           JB.box_blur_sum(jnp.asarray(img), winsize))


def test_poly_expand_channel_first():
    img = _images((3, 20, 28), seed=3)
    _close(TF.poly_expand(torch.from_numpy(img), channel_first=True),
           JF.poly_expand(jnp.asarray(img), channel_first=True))


def test_poly_expand_default_channels_last():
    img = _images((3, 20, 28), seed=3)
    _close(TF.poly_expand(torch.from_numpy(img)),
           JF.poly_expand(jnp.asarray(img)))


def test_image_and_polyexp_pyramid():
    img = _images((2, 40, 36), seed=4)
    jc = JFlowConfig(levels=2, min_size=8)
    tc = from_reference(jc)
    t_levels = TF.image_pyramid(torch.from_numpy(img), tc)
    j_levels = JF.image_pyramid(jnp.asarray(img), jc)
    assert len(t_levels) == len(j_levels) == 3
    for t, j in zip(t_levels, j_levels):
        _close(t, j)
    for t, j in zip(TF.polyexp_pyramid(torch.from_numpy(img), tc),
                    JF.polyexp_pyramid(jnp.asarray(img), jc, channel_first=True)):
        _close(t, j)


@pytest.mark.parametrize("h,w", [(6, 7), (12, 30)])
def test_border_scale_map_exact(h, w):
    np.testing.assert_array_equal(TF._border_scale_map(h, w),
                                  JF._border_scale_map(h, w))


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_level_displacement(level):
    for d in (None, 4, 8, 13):
        jc = JFlowConfig(max_displacement=d)
        assert (TF._level_displacement(from_reference(jc), level)
                == JF._level_displacement(jc, level))

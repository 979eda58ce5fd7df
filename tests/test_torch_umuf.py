"""K-umuf's plain version (the port's ``umuf_iterate`` on CPU tensors:
``iters`` x update_flow(update_matrices(...))) against the JAX package on
the CPU -- the fused Pallas kernel in interpret mode, the split XLA
iteration that JAX runs on tiny levels, and the split composition for the
hazards (even winsize, planes narrower than the border bands, no bound).
atol 5e-4, rtol 1e-4 (the bar of tests/test_pallas_umuf.py).

The CUDA kernel is held against this plain version on the card by
``chip_smoke.py`` and by tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flowdenoising_tpu.config import FlowConfig as JFlowConfig
from flowdenoising_tpu.ops import farneback as JF
from flowdenoising_tpu.ops.pallas import umuf as JU

from flowdenoising_tpu_torch.ops import cuda as K
from flowdenoising_tpu_torch.ops.cuda.umuf import umuf_iterate

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


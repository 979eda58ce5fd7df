"""K-uf's plain version (the port's ``update_flow_plain``, which the
wrapper ``update_flow`` runs on CPU tensors) against the JAX package's
Pallas kernel B5 in interpret mode on the CPU, at the winsizes of
tests/test_pallas_uf.py and an even one (a (winsize+1)^2 window scaled by
1/winsize^2, as OpenCV does).  atol 1e-4, rtol 1e-4 (the bar of
tests/test_pallas_uf.py).

The CUDA kernel is held against this plain version on the card by
``chip_smoke.py`` and by tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flowdenoising_tpu.ops import farneback as JF
from flowdenoising_tpu.ops.pallas.update_flow import update_flow_pallas

from flowdenoising_tpu_torch.ops import cuda as K
from flowdenoising_tpu_torch.ops import farneback as F

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


def _m(shape, seed=0):
    r = np.random.default_rng(seed)
    return r.normal(size=shape + (5,)).astype(np.float32) * 10


def _port(m, winsize):
    cf = torch.from_numpy(np.ascontiguousarray(np.moveaxis(m, -1, -3)))
    return np.moveaxis(F.update_flow(cf, winsize).numpy(), -3, -1)


@pytest.mark.parametrize("winsize,shape", [
    (5, (2, 24, 40)), (15, (1, 32, 32)), (4, (2, 20, 22))])
def test_plain_matches_pallas_interpret(winsize, shape):
    m = _m(shape)
    ref = np.asarray(update_flow_pallas(jnp.asarray(m), winsize, interpret=True))
    np.testing.assert_allclose(_port(m, winsize), ref, **TOL)


def test_plain_matches_xla_on_a_plane_smaller_than_the_window():
    m = _m((2, 5, 6), seed=1)
    ref = np.asarray(JF.update_flow(jnp.asarray(m), 15, sampler="xla"))
    np.testing.assert_allclose(_port(m, 15), ref, **TOL)


def test_cpu_wrapper_counts_no_launch_and_checks_shapes():
    m = torch.from_numpy(np.moveaxis(_m((1, 8, 8)), -1, -3).copy())
    before = K.LAUNCHES["uf"]
    assert torch.equal(F.update_flow(m, 5), F.update_flow_plain(m, 5))
    assert K.LAUNCHES["uf"] == before
    with pytest.raises(ValueError):
        F.update_flow(m[:, :4], 5)

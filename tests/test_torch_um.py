"""K-um's plain version (the port's ``update_matrices_plain``, which the
wrapper ``update_matrices`` runs on CPU tensors) against the JAX package on
the CPU: the Pallas kernel B4 in interpret mode and the XLA composition
(``sampler="windowed"``), on the cases of tests/test_pallas_um.py, plus
the unbounded form.  atol 5e-4, rtol 1e-4 (the bar of
tests/test_pallas_um.py).

The CUDA kernel is held against this plain version on the card by
``chip_smoke.py`` and by tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flowdenoising_tpu.ops import farneback as JF
from flowdenoising_tpu.ops.pallas.update_matrices import update_matrices_pallas

from flowdenoising_tpu_torch.ops import cuda as K
from flowdenoising_tpu_torch.ops import farneback as F

torch.set_num_threads(1)

TOL = dict(atol=5e-4, rtol=1e-4)


def _setup(b=2, h=24, w=40, seed=0, flow_scale=1.5):
    """tests/test_pallas_um.py's operands (channels-last JAX arrays)."""
    r = np.random.default_rng(seed)
    img0 = jnp.asarray(r.normal(size=(b, h, w)).astype(np.float32) * 40)
    img1 = jnp.asarray(r.normal(size=(b, h, w)).astype(np.float32) * 40)
    flow = jnp.asarray((r.normal(size=(b, h, w, 2)) * flow_scale).astype(np.float32))
    return JF.poly_expand(img0), JF.poly_expand(img1), flow


def _cf(x):
    """Channels-last array -> channel-first CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, -3)))


def _port(r0, r1, flow, d):
    out = F.update_matrices(_cf(r0), _cf(r1), _cf(flow), d)
    return np.moveaxis(out.numpy(), -3, -1)


# (seed, flow scale, D): tests/test_pallas_um.py's three cases -- flow
# within the bound, flow far beyond it, zero flow
CASES = [(0, 1.5, 4), (3, 6.0, 3), (4, 0.0, 2)]


@pytest.mark.parametrize("seed,scale,d", CASES)
def test_plain_matches_pallas_interpret(seed, scale, d):
    r0, r1, flow = _setup(seed=seed, flow_scale=scale)
    ref = np.asarray(update_matrices_pallas(r0, r1, flow, d, interpret=True))
    np.testing.assert_allclose(_port(r0, r1, flow, d), ref, **TOL)


@pytest.mark.parametrize("seed,scale,d", CASES)
def test_plain_matches_xla_windowed(seed, scale, d):
    r0, r1, flow = _setup(seed=seed, flow_scale=scale)
    ref = np.asarray(JF.update_matrices(r0, r1, flow, d, sampler="windowed"))
    np.testing.assert_allclose(_port(r0, r1, flow, d), ref, **TOL)


def test_plain_unbounded_matches_xla():
    # no bound: exact sampling, flows reaching far outside the plane
    r0, r1, flow = _setup(seed=5, flow_scale=8.0)
    ref = np.asarray(JF.update_matrices(r0, r1, flow, None))
    np.testing.assert_allclose(_port(r0, r1, flow, None), ref, **TOL)


def test_cpu_wrapper_counts_no_launch_and_checks_shapes():
    r0, r1, flow = _setup(b=1, h=8, w=8)
    before = K.LAUNCHES["um"]
    out = F.update_matrices(_cf(r0), _cf(r1), _cf(flow), 2)
    assert K.LAUNCHES["um"] == before
    assert torch.equal(out, F.update_matrices_plain(_cf(r0), _cf(r1), _cf(flow), 2))
    with pytest.raises(ValueError):
        F.update_matrices(_cf(r0), _cf(r1)[:, :4], _cf(flow), 2)

"""K-sample's plain version (the port's ``displace_sample`` on a CPU tensor)
against the JAX package's samplers, on the CPU: the Pallas kernel in
interpret mode, the windowed XLA form, and, for no bound, the exact gather.
atol 2e-4 on data of scale ~50 (the bar of tests/test_pallas_sample.py).

The CUDA kernel itself is held against this plain version on the card by
``chip_smoke.py`` and by tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flowdenoising_tpu.ops.pallas.sample import bilinear_displace_pallas
from flowdenoising_tpu.ops.warp import (
    bilinear_displace_windowed, bilinear_sample as j_bilinear_sample)

from flowdenoising_tpu_torch.ops import cuda as K
from flowdenoising_tpu_torch.ops.cuda.sample import check_shapes
from flowdenoising_tpu_torch.ops.warp import displace_sample, warp_slices

torch.set_num_threads(1)

ATOL = 2e-4


def _case(b, c, h, w, scale, d, seed):
    """Source planes of scale ~50; flows N(0, scale) plus a band of pixels
    pushed beyond +-d."""
    r = np.random.default_rng(seed)
    shape = (b, h, w) if c is None else (b, c, h, w)
    src = (r.normal(size=shape) * 50).astype(np.float32)
    u = (r.normal(size=(b, h, w)) * scale).astype(np.float32)
    v = (r.normal(size=(b, h, w)) * scale).astype(np.float32)
    u[:, : h // 4] += 3 * d
    v[:, :, : w // 4] -= 3 * d
    return src, u, v


def _port(src, u, v, d):
    out = displace_sample(torch.from_numpy(src), torch.from_numpy(u),
                          torch.from_numpy(v), d)
    return out.numpy()


@pytest.mark.parametrize("b,c,h,w,scale,d", [
    (2, None, 24, 32, 1.5, 4),
    (1, None, 16, 17, 3.0, 2),
    (2, 5, 16, 23, 2.0, 3),
    (1, 5, 9, 13, 4.0, 8),
])
def test_plain_matches_pallas_interpret(b, c, h, w, scale, d):
    src, u, v = _case(b, c, h, w, scale, d, seed=b * 100 + h)
    ref = np.asarray(bilinear_displace_pallas(
        jnp.asarray(src), jnp.asarray(u), jnp.asarray(v), d, interpret=True))
    np.testing.assert_allclose(_port(src, u, v, d), ref, atol=ATOL)


@pytest.mark.parametrize("c,d", [(None, 4), (5, 3)])
def test_plain_matches_windowed(c, d):
    src, u, v = _case(2, c, 20, 31, 2.5, d, seed=7)
    uj, vj = jnp.asarray(u), jnp.asarray(v)
    if c is not None:
        uj, vj = uj[:, None], vj[:, None]
    ref = np.asarray(bilinear_displace_windowed(jnp.asarray(src), uj, vj, d))
    np.testing.assert_allclose(_port(src, u, v, d), ref, atol=ATOL)


@pytest.mark.parametrize("c", [None, 5])
def test_unbounded_matches_exact_gather(c):
    src, u, v = _case(2, c, 18, 21, 6.0, 8, seed=11)
    gx = np.arange(21, dtype=np.float32)
    gy = np.arange(18, dtype=np.float32)[:, None]
    fx, fy = jnp.asarray(u + gx), jnp.asarray(v + gy)
    if c is not None:
        fx, fy = fx[:, None], fy[:, None]
    ref = np.asarray(j_bilinear_sample(jnp.asarray(src), fx, fy))
    np.testing.assert_allclose(_port(src, u, v, None), ref, atol=ATOL)


def test_warp_slices_channels_last():
    src, u, v = _case(2, None, 16, 20, 1.5, 4, seed=13)
    flow = np.stack([u, v], axis=-1)
    out = warp_slices(torch.from_numpy(src), torch.from_numpy(flow), 4).numpy()
    np.testing.assert_array_equal(out, _port(src, u, v, 4))


def test_cpu_wrapper_counts_no_launch_and_checks_shapes():
    src, u, v = _case(1, None, 8, 8, 1.0, 2, seed=0)
    before = K.LAUNCHES["sample"]
    _port(src, u, v, 2)
    assert K.LAUNCHES["sample"] == before
    with pytest.raises(ValueError):
        check_shapes(torch.from_numpy(src), torch.from_numpy(u)[0],
                     torch.from_numpy(v)[0])


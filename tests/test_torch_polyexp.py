"""The float32 expansion pyramid's route and its plain chain, on the CPU.

``ops.farneback.polyexp_pyramid`` builds a CUDA float32 stack's pyramid in
the kernels K-polyexp and K-pyr-blur (``ops/cuda/polyexp.py``,
``csrc/polyexp.cu``) and every other stack's in the plain chain of
``ops/blur.py: corr1d``, which is the kernels' plain version.  Here:

- a CPU stack and a bfloat16 one take the plain chain, which launches no
  kernel and copies its index vectors (``fdt.drain.blur_index``) as before;
- the route's predicate on devices and dtypes (``ops.device.use_kernel``
  with ``float32``): a CUDA float32 stack takes the kernels whatever the
  configuration, and a stack on another device neither;
- the level loop, which runs each level's operations in the kernels' order
  (their plain versions on CPU tensors), equals the plain pyramid
  (``image_pyramid``, then ``poly_expand`` a level) bit for bit, narrow
  planes and pads wider than the axis included;
- the plain pyramid against the JAX package's at narrow planes;
- the border index map the kernels compute, against numpy's.

The kernels themselves are held to the plain chain bit for bit on the card
by ``tests/test_torch_cuda.py``.
"""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flowdenoising_tpu.config import FlowConfig as JFlowConfig
from flowdenoising_tpu.ops import farneback as JF

from flowdenoising_tpu_torch.config import FlowConfig, from_reference
from flowdenoising_tpu_torch.ops import cuda as K
from flowdenoising_tpu_torch.ops import farneback as F
from flowdenoising_tpu_torch.ops.blur import pyr_blur
from flowdenoising_tpu_torch.ops.device import use_kernel
from flowdenoising_tpu_torch.utils import tracing

torch.set_num_threads(1)

# corr1d calls a pyramid level: the smoothing's two, poly_expand's nine
BLUR_INDEX_A_LEVEL = 11


def _stack(shape, seed=0):
    r = np.random.default_rng(seed)
    return torch.from_numpy((r.normal(size=shape) * 50 + 100)
                            .astype(np.float32))


def _plain(img, cfg):
    return [F.poly_expand(i, cfg.poly_n, cfg.poly_sigma, channel_first=True)
            for i in F.image_pyramid(img, cfg)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_and_bf16_stacks_take_the_plain_chain(dtype):
    from torch.profiler import ProfilerActivity, profile

    img = _stack((3, 40, 36)).to(dtype)
    cfg = FlowConfig(levels=2, min_size=8, dtype=str(dtype).split(".")[-1])
    before = dict(K.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = F.polyexp_pyramid(img, cfg)
    drains = sum(1 for e in prof.events()
                 if e.name == tracing.DRAIN_PREFIX + "blur_index")
    assert not use_kernel(img, "polyexp_pyramid", float32=True)
    assert K.LAUNCHES == before
    assert drains == BLUR_INDEX_A_LEVEL * len(out) == 33
    for o, r in zip(out, _plain(img, cfg)):
        assert o.dtype == dtype and o.is_contiguous() and torch.equal(o, r)


def _stack_on(device, dtype, shape=(4, 256, 256)):
    """A stand-in for a stack on ``device``: the predicate reads only the
    device and the dtype."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                 shape=torch.Size(shape))


@pytest.mark.parametrize("device,dtype,takes", [
    ("cuda", torch.float32, True),
    ("cuda", torch.bfloat16, False),
    ("cuda", torch.float16, False),
    ("cuda", torch.float64, False),
    ("cpu", torch.float32, False),
    ("meta", torch.float32, False),
])
def test_the_route_takes_a_cuda_float32_stack(device, dtype, takes):
    stack = _stack_on(device, dtype)
    if device == "meta":       # neither the kernels nor the plain chain
        with pytest.raises(ValueError, match="no kernel"):
            use_kernel(stack, "polyexp_pyramid", float32=True)
    else:
        assert use_kernel(stack, "polyexp_pyramid", float32=True) is takes


@pytest.mark.parametrize("fields", [
    {"levels": 8, "min_size": 1},      # pre-blurs of 319 and 639 taps
    {"poly_n": 3, "poly_sigma": 0.9},
    {"poly_n": 7, "poly_sigma": 1.5},
])
def test_the_kernels_level_loop_takes_any_configuration(fields):
    """Long pre-blurs and every poly_n, which the card runs through device
    memory where the fused kernels stop, give the plain pyramid's levels."""
    img = _stack((2, 300, 300), seed=3)
    cfg = FlowConfig(**fields)
    out = F.polyexp_pyramid(img, cfg)
    ref = _plain(img, cfg)
    assert len(out) == len(ref) == cfg.clamped_levels(300, 300) + 1
    for o, r in zip(out, ref):
        assert o.is_contiguous() and torch.equal(o, r)


@pytest.mark.parametrize("shape", [(2, 1, 1), (1, 3, 5), (3, 8, 1030),
                                   (2, 6, 40), (17, 40, 61)])
@pytest.mark.parametrize("poly_sigma", [1.2, 1.5])
def test_the_kernels_level_loop_is_the_plain_pyramid(shape, poly_sigma):
    img = _stack(shape, seed=shape[-1])
    for levels in range(4):
        cfg = FlowConfig(levels=levels, min_size=1, poly_sigma=poly_sigma)
        before = dict(K.LAUNCHES)
        out = F.polyexp_pyramid(img, cfg)
        ref = _plain(img, cfg)
        assert K.LAUNCHES == before      # CPU tensors: the plain versions
        assert len(out) == len(ref) == cfg.clamped_levels(*shape[1:]) + 1
        for o, r in zip(out, ref):
            assert o.is_contiguous() and torch.equal(o, r)


def test_the_wrappers_take_no_other_device():
    img = torch.zeros(2, 8, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        F.expand_level(img, 5, 1.2)
    with pytest.raises(ValueError, match="no kernel"):
        pyr_blur(img, np.ones(3) / 3)


@pytest.mark.parametrize("h,w,levels", [(8, 1030, 2), (8, 1030, 3),
                                        (6, 40, 2), (6, 40, 3)])
def test_plain_pyramid_matches_jax_on_narrow_planes(h, w, levels):
    img = _stack((2, h, w), seed=h * w).numpy()
    jc = JFlowConfig(levels=levels, min_size=1)
    out = F.polyexp_pyramid(torch.from_numpy(img), from_reference(jc))
    ref = JF.polyexp_pyramid(jnp.asarray(img), jc, channel_first=True)
    assert len(out) == len(ref) == jc.clamped_levels(h, w) + 1
    for o, r in zip(out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=0,
                                   atol=1e-4 * float(np.abs(r).max()))


def _reflect101(i, n):
    """csrc/polyexp.cu: reflect101, the kernels' reflect-101 index."""
    if 0 <= i < n:
        return i
    if n == 1:
        return 0
    p = 2 * (n - 1)
    m = i % p
    return m if m < n else p - m


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 33])
def test_the_kernels_border_indices_are_numpys(n):
    """Pads as wide as a 639-tap blur's, on axes narrower than them."""
    for r in (1, 4, 9, 117, 319):
        i = np.arange(-r, n + r)
        assert [_reflect101(int(k), n) for k in i] == list(
            np.pad(np.arange(n), (r, r), mode="reflect"))
        assert list(np.clip(i, 0, n - 1)) == list(
            np.pad(np.arange(n), (r, r), mode="edge"))

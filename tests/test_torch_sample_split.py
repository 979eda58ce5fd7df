"""The public samplers on a bf16 source with no bound, and K-sample-split
on the CPU.

With no bound the JAX package samples a bf16 source with its exact gather
in bf16 arithmetic (``flowdenoising_tpu/ops/warp.py: displace_sample``):
bf16 pixel coordinates, every operation rounded to bf16 with bf16 flows,
and a bf16 result.  The port's ``displace_sample`` and ``warp_slices`` take
that route to ``displace_sample_xla`` (K-sample-split on the card) and
equal JAX's bit for bit, on planes 64 and 300 wide, with bf16 and float32
flows and with a channel axis; sampling a float32 copy instead, as
``displace_sample_plain`` does, differs by tens of grey levels there.

The kernel (``csrc/sample.cu: sample_split_kernel``) cannot run here.  Its
per-element arithmetic, bf16.cuh's split tap and the pass's tap FMA, is
emulated in float32 with every bf16 rounding written out
(``tests/split_tap.py``) and held bit for bit to its plain version
``sample_split_plain`` on the planes of ``tests/test_torch_bf16_nobound.py``
(64 x 64, 40 x 261, 128 x 512) and on one taller than 256; on the card
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the kernel to it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_blob_volume
from flowdenoising_tpu.ops import warp as JW
from split_tap import BF16, Tap, rb, split_sample, split_tap

from flowdenoising_tpu_torch.ops import cuda as K
from flowdenoising_tpu_torch.ops.blur import rounded
from flowdenoising_tpu_torch.ops.warp import (
    displace_sample, displace_sample_plain, displace_sample_xla, sample_split,
    sample_split_plain, warp_slices)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _inputs(w, channels, seed):
    """A (3, [2,] 40, w) source of scale 50 and flows (3, 40, w) N(0, 3)
    with a band pushed 40 px past the right edge, float32."""
    r = np.random.default_rng(seed)
    src = r.normal(size=(3,) + ((2,) if channels else ()) + (40, w)) * 50
    u, v = r.normal(size=(2, 3, 40, w)) * 3
    u[:, :, : w // 5] += 40
    return src.astype(np.float32), u.astype(np.float32), v.astype(np.float32)


@pytest.mark.parametrize("entry", ["displace_sample", "warp_slices"])
@pytest.mark.parametrize("channels", [False, True], ids=["planes", "channels"])
@pytest.mark.parametrize("flow_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("w", [64, 300])
def test_bf16_nobound_samplers_match_jax(w, flow_dtype, channels, entry):
    src, u, v = _inputs(w, channels, seed=w)
    sj = jnp.asarray(src).astype(jnp.bfloat16)
    uj, vj = (jnp.asarray(a).astype(flow_dtype) for a in (u, v))
    st = torch.from_numpy(src).to(BF16)
    ut, vt = (torch.from_numpy(a).to(getattr(torch, flow_dtype)) for a in (u, v))
    before = dict(K.LAUNCHES)
    if entry == "displace_sample":
        ref = JW.displace_sample(sj, uj, vj, None)
        out = displace_sample(st, ut, vt, None)
    else:
        ref = JW.warp_slices(sj, jnp.stack([uj, vj], -1), None)
        out = warp_slices(st, torch.stack([ut, vt], -1))
    assert K.LAUNCHES == before          # a CPU tensor: the plain version
    # bf16 with bf16 flows, float32 with float32 flows, as JAX promotes
    assert str(out.dtype) == f"torch.{jnp.dtype(ref.dtype).name}" == f"torch.{flow_dtype}"
    want = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_array_equal(out.float().numpy(), want)
    # a float32 copy of the source samples another function
    assert not np.array_equal(displace_sample_plain(st, ut, vt, None).numpy(),
                              want)


def test_bounded_bf16_source_keeps_the_float32_sampling():
    # with a bound the TPU path samples bf16 texels in float32 (K-sample's
    # plain version on a widened copy), as before
    src, u, v = (torch.from_numpy(a) for a in _inputs(64, False, seed=1))
    out = displace_sample(src.to(BF16), u, v, 8)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, displace_sample_plain(src.to(BF16), u, v, 8),
                               atol=0, rtol=0)


def _blob_planes(n, h, w, seed):
    return torch.from_numpy(make_blob_volume(n, h, w, seed=seed)).to(BF16)


# the planes of tests/test_torch_bf16_nobound.py and one taller than 256
# (bf16 pixel coordinates past 256 round to even in y too)
PLANES = {"64x64": (6, 64, 64, 2), "40x261": (6, 40, 261, 5),
          "128x512": (4, 128, 512, 6), "300x20": (3, 300, 20, 8)}


def _flows(b, h, w, seed, scale):
    """Flows N(0, scale) (b, 2, h, w) with a band pushed 40 px past the
    right edge and one past the top."""
    f = np.random.default_rng(seed).normal(size=(b, 2, h, w)) * scale
    f[:, 0, :, : w // 5] += 40
    f[:, 1, : h // 4] -= 40
    return torch.from_numpy(f.astype(np.float32))


def emulated_sample_split(src, u, v, acc=None, weight=None):
    """csrc/sample.cu: sample_split_kernel at every element: bf16.cuh's
    split tap with the flow's dtype, then the FMA acc = bf16(acc + bf16(s *
    w)), or the sample stored in bf16 (bf16 flow) or float32."""
    bf = u.dtype == BF16
    tap = split_tap(u.float(), v.float(), bf)
    if src.ndim == 4:
        b, c = src.shape[:2]
        tap = Tap(*(t.repeat_interleave(c, 0) for t in tap))
        s = split_sample(src.float().flatten(0, 1), tap, bf).unflatten(0, (b, c))
    else:
        s = split_sample(src.float(), tap, bf)
    if acc is not None:
        return rb(acc.float() + rb(s * weight)).to(BF16)
    return s.to(BF16) if bf else s


@pytest.mark.parametrize("scale", [3.0, 600.0])
@pytest.mark.parametrize("flow_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("plane", sorted(PLANES))
def test_emulated_kernel_equals_plain(plane, flow_dtype, scale):
    n, h, w, seed = PLANES[plane]
    src = _blob_planes(n, h, w, seed)
    flow = _flows(n, h, w, seed, scale).to(getattr(torch, flow_dtype))
    u, v = flow[:, 0], flow[:, 1]
    ref = sample_split_plain(src, u, v)
    assert ref.dtype == flow.dtype
    got = emulated_sample_split(src, u, v)
    assert got.dtype == ref.dtype
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    # the tap FMA into a bf16 accumulator, as the split pass runs it
    acc = (src * rounded(0.3, BF16)).flip(0).contiguous()
    weight = rounded(0.0918, BF16)
    want = sample_split_plain(src, u, v, acc.clone(), weight)
    assert want.dtype == BF16
    torch.testing.assert_close(emulated_sample_split(src, u, v, acc, weight),
                               want, atol=0, rtol=0)


@pytest.mark.parametrize("flow_dtype", ["bfloat16", "float32"])
def test_emulated_kernel_with_channels(flow_dtype):
    # (B, C, H, W) with one flow for the C planes, as the public samplers
    # fold a channel axis
    src = _blob_planes(6, 40, 261, 5).reshape(3, 2, 40, 261)
    flow = _flows(3, 40, 261, 4, 3.0).to(getattr(torch, flow_dtype))
    ref = sample_split_plain(src, flow[:, 0], flow[:, 1])
    torch.testing.assert_close(emulated_sample_split(src, flow[:, 0], flow[:, 1]),
                               ref, atol=0, rtol=0)


def test_the_flow_dtypes_round_apart():
    # a kernel that widened a bf16 flow, or rounded a float32 one, would
    # differ from the plain version
    src = _blob_planes(6, 40, 261, 5)
    flow = _flows(6, 40, 261, 1, 3.0).to(BF16)
    bf = emulated_sample_split(src, flow[:, 0], flow[:, 1])
    f32 = emulated_sample_split(src, flow[:, 0].float(), flow[:, 1].float())
    assert not torch.equal(bf.float(), f32)


def test_plain_is_the_exact_gather_then_the_pass_fma():
    src = _blob_planes(6, 64, 64, 2)
    flow = _flows(6, 64, 64, 3, 3.0).to(BF16)
    acc = (src * rounded(0.25, BF16)).contiguous()
    weight = rounded(0.1, BF16)
    want = acc.clone().add_(
        (displace_sample_xla(src, flow[:, 0], flow[:, 1]) * weight).to(BF16))
    got = sample_split_plain(src, flow[:, 0], flow[:, 1], acc, weight)
    assert got is acc
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_cpu_wrapper_counts_no_launch_and_refuses_bad_inputs():
    src = _blob_planes(6, 40, 261, 5)
    flow = _flows(6, 40, 261, 2, 3.0).to(BF16)
    u, v = flow[:, 0], flow[:, 1]
    before = dict(K.LAUNCHES)
    torch.testing.assert_close(sample_split(src, u, v),
                               sample_split_plain(src, u, v), atol=0, rtol=0)
    acc = src.clone()
    assert sample_split(src, u, v, acc, 0.5) is acc
    assert K.LAUNCHES == before          # a CPU tensor: the plain version
    with pytest.raises(ValueError, match="together"):
        sample_split(src, u, v, acc)
    with pytest.raises(ValueError, match="shape"):
        sample_split(src, u, v, acc[:, :4], 0.5)
    with pytest.raises(ValueError):
        sample_split(src[:, :4], u, v)
    with pytest.raises(ValueError):
        sample_split(src, u[:-1], v)
    meta = src.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        sample_split(meta, u.to("meta"), v.to("meta"))
    assert K.LAUNCHES == before


def test_public_samplers_route_to_sample_split(monkeypatch):
    # a bf16 source with no bound goes to K-sample-split's plain version
    # (on the card its kernel), every other call to K-sample's
    from flowdenoising_tpu_torch.ops import warp as W
    calls = []
    for name in ("sample_split", "displace_sample"):
        fn = getattr(W, name + "_plain")
        monkeypatch.setattr(W, name + "_plain", lambda *a, _fn=fn, _n=name,
                            **k: calls.append(_n) or _fn(*a, **k))
    src, u, v = (torch.from_numpy(a) for a in _inputs(64, True, seed=2))
    u, v = u.unsqueeze(1), v.unsqueeze(1)
    displace_sample(src.to(BF16), u, v, None, device=CPU)
    displace_sample(src.to(BF16), u, v, 8, device=CPU)
    displace_sample(src, u, v, None, device=CPU)
    warp_slices(src.to(BF16), torch.stack([u, v], -1), device=CPU)
    assert calls == ["sample_split", "displace_sample", "displace_sample",
                     "sample_split"]

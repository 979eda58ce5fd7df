"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; they skip on a host without a CUDA device (the kernels
have no CPU mode).  The file imports neither JAX nor the test suite's
conftest, so it runs on a machine with the card and no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are the JAX package's own kernel bars: sampling atol 2e-4 on
data of scale ~50, Farneback iterations and K-um atol 5e-4 / rtol 1e-4,
K-uf atol 1e-4 / rtol 1e-4, compose tap flow atol 1e-5 / accumulator atol
1e-4, end to end PSNR >= 55 dB.  K-umuf, the packed forms (bf16
sources), the bf16 carry rounding and the split route's forms
(K-umuf-split, K-sample-split, K-compose-run-split) are held to their plain
versions at atol 0.
"""

import numpy as np
import pytest
import torch

from flowdenoising_tpu_torch.config import FilterConfig, FlowConfig
from flowdenoising_tpu_torch.core.pipeline import denoise
from flowdenoising_tpu_torch.ops import cuda as K
from flowdenoising_tpu_torch.ops import farneback as F
from flowdenoising_tpu_torch.ops.compose import (
    compose_chain_plain, compose_run_plain, compose_tap_plain)
from flowdenoising_tpu_torch.ops.cuda.compose import (
    compose_run, compose_run_split, compose_tap)
from flowdenoising_tpu_torch.ops.cuda.uf import update_flow
from flowdenoising_tpu_torch.ops.cuda.um import update_matrices
from flowdenoising_tpu_torch.ops.cuda.umuf import plan_strip, umuf_iterate
from flowdenoising_tpu_torch.ops.cuda.umuf_split import (
    plan_split, umuf_split_iterate)
from flowdenoising_tpu_torch.ops.resize import resize_area, resize_linear
from flowdenoising_tpu_torch.ops.cuda.sample import (
    displace_sample, sample_split)
from flowdenoising_tpu_torch.ops.warp import (
    displace_sample_plain, sample_split_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


@pytest.mark.parametrize("b,c,h,w,d", [
    (3, None, 64, 80, 8), (2, 5, 33, 47, 3), (4, None, 19, 130, None),
    (1, 1, 256, 256, 8),
])
def test_sample_kernel_matches_plain(dev, b, c, h, w, d):
    r = np.random.default_rng(b * h + w)
    shape = (b, h, w) if c is None else (b, c, h, w)
    src = _t(r.normal(size=shape) * 50, dev)
    # flow channels as views of a channel-first flow (batch stride 2*H*W)
    flow = r.normal(size=(b, 2, h, w)) * 3
    flow[:, 0, : h // 4] += 3 * (d or 8)
    flow = _t(flow, dev)
    before = K.LAUNCHES["sample"]
    out = displace_sample(src, flow[:, 0], flow[:, 1], d)
    assert K.LAUNCHES["sample"] == before + 1
    ref = displace_sample_plain(src, flow[:, 0], flow[:, 1], d)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=0)


# The cells' pyramid levels (EPFL CA1 Z 768x1024, Y 165x1024, X 165x768;
# CZII Z 630x630, Y and X 184x630; 3 levels, d_k 9, 5, 3 at D 8), the
# probe's two with the clamp off, and odd shapes, winsizes and launches
UMUF_CASES = [
    (2, 768, 1024, 5, 9, None), (2, 384, 512, 5, 5, None), (3, 192, 256, 5, 3, None),
    (3, 165, 1024, 5, 9, None), (3, 83, 512, 5, 5, None), (4, 42, 256, 5, 3, None),
    (3, 165, 768, 5, 9, None), (3, 83, 384, 5, 5, None), (4, 42, 192, 5, 3, None),
    (2, 630, 630, 5, 9, None), (3, 315, 315, 5, 5, None), (4, 158, 158, 5, 3, None),
    (3, 184, 630, 5, 9, None), (3, 92, 315, 5, 5, None), (4, 46, 158, 5, 3, None),
    (8, 128, 128, 5, None, None), (8, 64, 256, 5, None, None),
    (2, 64, 64, 5, 9, None), (3, 37, 70, 7, 3, None), (2, 8, 9, 5, 2, None),
    (2, 20, 22, 4, 3, None), (1, 48, 40, 15, 5, None), (2, 32, 32, 5, None, None),
    (1, 3, 3, 5, 2, None), (2, 100, 130, 15, 9, None), (2, 100, 130, 15, 9, 3),
    (2, 100, 130, 5, 9, 1), (2, 100, 130, 5, 9, 2), (2, 5, 300, 9, 5, None),
    (2, 300, 5, 3, 5, None), (1, 70, 90, 59, 5, None), (1, 70, 90, 61, 5, None),
    (1, 60, 200, 91, 5, None), (2, 45, 70, 1, 3, None), (2, 90, 100, 9, 5, 3),
]


@pytest.mark.parametrize("b,h,w,winsize,d,per_launch", UMUF_CASES)
def test_umuf_kernel_matches_plain(dev, b, h, w, winsize, d, per_launch):
    r = np.random.default_rng(h * w + winsize)
    rr = F.poly_expand(_t(r.normal(size=(2, b, h, w)) * 40, dev),
                       channel_first=True).contiguous()
    flow = r.normal(size=(b, 2, h, w)) * 2
    flow[:, 0, : h // 4] += 2 * (d or 8) + 3    # a band beyond +-d
    flow = _t(flow, dev)
    plan = plan_strip(h, w, winsize, 3, per_launch)
    assert plan.smem == K.entry("fdt_umuf_strip_smem")(
        w, winsize, plan.per_launch, plan.strip_x)
    before = dict(K.LAUNCHES)
    out = umuf_iterate(rr[0], rr[1], flow, 3, d, winsize, per_launch)
    assert K.LAUNCHES == {**before, "umuf": before["umuf"] + len(plan.launches)}
    ref = F.umuf_iterate_plain(rr[0], rr[1], flow, 3, d, winsize)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_umuf_kernel_is_named_for_the_tap_solve_layer(dev):
    # the benchmark puts the tap solve's device time where the kernel's
    # symbol matches this pattern (benchmarks/trace.py, rule 2): both r1
    # dtypes' launches must, and nothing else of the call may
    from torch.profiler import ProfilerActivity, profile

    from benchmarks.trace import KERNELS, from_profiler
    pattern = next(p for p, layer in KERNELS if layer == "tap solve")
    r = np.random.default_rng(5)
    rr = F.poly_expand(_t(r.normal(size=(2, 2, 64, 80)) * 40, dev),
                       channel_first=True).contiguous()
    flow = _t(r.normal(size=(2, 2, 64, 80)), dev)
    r1b = rr[1].to(torch.bfloat16)
    umuf_iterate(rr[0], rr[1], flow, 3, 5, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        umuf_iterate(rr[0], rr[1], flow, 3, 5, 5)
        umuf_iterate(rr[0], r1b, flow, 3, 5, 5)
        torch.cuda.synchronize()
    kernels = [e.name for e in from_profiler(prof) if e.device]
    named = [n for n in kernels if pattern.search(n)]
    assert len(named) == 2, kernels
    assert all("umuf" not in n for n in kernels if n not in named)


@pytest.mark.parametrize("flow_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,h,w,winsize,per_launch", [
    (2, 64, 64, 5, None), (3, 40, 261, 5, None), (2, 8, 1030, 5, None),
    (2, 37, 70, 7, 1), (2, 37, 70, 7, 2), (2, 20, 22, 4, None),
    (1, 3, 3, 5, None), (2, 100, 130, 15, None), (2, 100, 130, 15, 3),
    (1, 300, 40, 5, 3), (1, 96, 96, 61, None), (8, 256, 256, 5, None),
])
def test_umuf_split_kernel_matches_plain(dev, b, h, w, winsize, per_launch,
                                         flow_dtype):
    # K-umuf-split: bf16 expansions, a bf16 or float32 flow with bands 40 px
    # past two edges (no bound); bit for bit split_iterate_plain; winsize 61
    # takes one block an SM (plan_split)
    r = np.random.default_rng(h * w + winsize)
    imgs = _t(r.normal(size=(2, b, h, w)) * 40, dev).to(torch.bfloat16)
    rr = F.poly_expand(imgs, channel_first=True).contiguous()
    flow = r.normal(size=(b, 2, h, w)) * 2
    flow[:, 0, : h // 4] += 40
    flow[:, 1, :, : w // 3] -= 40
    flow = _t(flow, dev).to(getattr(torch, flow_dtype))
    plan = plan_split(h, w, winsize, 3, per_launch)
    assert plan.smem == K.entry("fdt_umuf_smem")(
        h, w, winsize, plan.per_launch, plan.tile_y, plan.tile_x)
    before = dict(K.LAUNCHES)
    out = umuf_split_iterate(rr[0], rr[1], flow, 3, winsize, per_launch)
    assert K.LAUNCHES == {**before,
                          "umuf_split": before["umuf_split"] + len(plan.launches)}
    ref = F.split_iterate_plain(rr[0], rr[1], flow, 3, winsize)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.parametrize("b,h,w,d,scale", [
    (2, 64, 64, 9, 2.0), (3, 37, 70, 3, 6.0), (2, 8, 9, 2, 1.0),
    (1, 3, 3, 2, 1.0), (2, 33, 47, None, 4.0), (8, 256, 256, 9, 1.5),
])
def test_um_kernel_matches_plain(dev, b, h, w, d, scale):
    r = np.random.default_rng(h * w + b)
    rr = F.poly_expand(_t(r.normal(size=(2, b, h, w)) * 40, dev),
                       channel_first=True).contiguous()
    flow = r.normal(size=(b, 2, h, w)) * scale
    flow[:, 0, : h // 4] += 3 * (d or 8)
    flow = _t(flow, dev)
    before = K.LAUNCHES["um"]
    out = update_matrices(rr[0], rr[1], flow, d)
    assert K.LAUNCHES["um"] == before + 1
    ref = F.update_matrices_plain(rr[0], rr[1], flow, d)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("b,h,w,winsize", [
    (2, 64, 64, 5), (3, 37, 70, 7), (2, 20, 22, 4), (1, 32, 32, 15),
    (2, 5, 6, 15), (8, 256, 256, 5),
])
def test_uf_kernel_matches_plain(dev, b, h, w, winsize):
    m = _t(np.random.default_rng(h + w + winsize).normal(size=(b, 5, h, w)) * 10,
           dev)
    before = K.LAUNCHES["uf"]
    out = update_flow(m, winsize)
    assert K.LAUNCHES["uf"] == before + 1
    ref = F.update_flow_plain(m, winsize)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n,h,w,d", [
    (3, 64, 80, 8), (2, 33, 47, None), (4, 19, 130, 3), (2, 256, 256, 8),
])
def test_compose_kernel_matches_plain(dev, n, h, w, d):
    r = np.random.default_rng(n * h + w)
    link = _t(r.normal(size=(n + 5, 2, h, w)) * 0.6, dev)
    nb = _t(r.normal(size=(n + 7, h, w)) * 50, dev)
    flow = r.normal(size=(n, 2, h, w)) * 3
    flow[:, 0, : h // 4] += 3 * (d or 8)
    flow = _t(flow, dev)
    acc = _t(r.normal(size=(n, h, w)), dev)
    fr, ar = compose_tap_plain(link[4:4 + n], flow, nb[6:6 + n], acc,
                               float(np.float32(0.13)), d)
    before = K.LAUNCHES["compose"]
    f2, a2 = compose_tap(link, flow, nb, acc, 0.13, d, 4, 6)
    assert K.LAUNCHES["compose"] == before + 1
    assert f2 is flow and a2 is acc
    torch.cuda.synchronize()
    torch.testing.assert_close(flow, fr, atol=1e-5, rtol=0)
    torch.testing.assert_close(acc, ar, atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,h,w,winsize,d,ramp_bf16", [
    (2, 64, 64, 5, 5, False), (3, 37, 70, 7, 3, False), (2, 32, 32, 5, 2, True),
    (1, 3, 3, 5, 2, True), (2, 100, 130, 15, 9, False), (4, 256, 256, 5, 9, False),
    # the levels the bf16 paths run packed at 256^3 and 512^3 (d_k 9, 5, 3,
    # 2) and the adjacent bound's level 0 (d 5)
    (8, 128, 128, 5, 5, False), (8, 64, 64, 5, 3, False), (2, 512, 512, 5, 9, False),
    (4, 256, 256, 5, 5, False), (8, 128, 128, 5, 3, False), (8, 64, 64, 5, 2, False),
    # the auto probe's largest bound at level 0 (D 48)
    (2, 256, 256, 5, 49, False),
    # the cells' level shapes (d_k 9, 5, 3)
    (2, 768, 1024, 5, 9, False), (3, 165, 768, 5, 5, False), (4, 42, 256, 5, 3, False),
    (2, 630, 630, 5, 9, False), (3, 92, 315, 5, 5, False), (4, 46, 158, 5, 3, False),
])
def test_umuf_bf16_kernel_matches_plain(dev, b, h, w, winsize, d, ramp_bf16):
    # K-umuf-bf16: r1 in bfloat16, counted apart from the float32 form, on
    # the float32 form's plan, whose shared memory is the planner's formula
    r = np.random.default_rng(h * w + winsize + 1)
    rr = F.poly_expand(_t(r.normal(size=(2, b, h, w)) * 40, dev),
                       channel_first=True).contiguous()
    r1 = rr[1].to(torch.bfloat16)
    flow = r.normal(size=(b, 2, h, w)) * 2
    flow[:, 0, : h // 4] += 2 * d + 3          # a band beyond +-d
    flow = _t(flow, dev)
    plan = plan_strip(h, w, winsize, 3)
    assert plan.smem == K.entry("fdt_umuf_strip_smem")(
        w, winsize, plan.per_launch, plan.strip_x)
    before = dict(K.LAUNCHES)
    out = umuf_iterate(rr[0], r1, flow, 3, d, winsize, ramp_bf16=ramp_bf16)
    assert K.LAUNCHES == {**before,
                          "umuf_bf16": before["umuf_bf16"] + len(plan.launches)}
    ref = F.umuf_iterate_plain(rr[0], r1, flow, 3, d, winsize, ramp_bf16)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.parametrize("b,h,w,d", [(2, 64, 64, 9), (3, 37, 70, None),
                                     (8, 256, 256, 9)])
def test_um_bf16_kernel_matches_plain(dev, b, h, w, d):
    r = np.random.default_rng(h * w + b + 1)
    rr = F.poly_expand(_t(r.normal(size=(2, b, h, w)) * 40, dev),
                       channel_first=True).contiguous()
    r1 = rr[1].to(torch.bfloat16)
    flow = r.normal(size=(b, 2, h, w)) * 1.5
    flow[:, 0, : h // 4] += 3 * (d or 8)
    flow = _t(flow, dev)
    before = dict(K.LAUNCHES)
    out = update_matrices(rr[0], r1, flow, d)
    assert K.LAUNCHES["um_bf16"] == before["um_bf16"] + 1
    assert K.LAUNCHES["um"] == before["um"]
    ref = F.update_matrices_plain(rr[0], r1, flow, d)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,d,round_carry", [
    (3, 64, 80, 8, True), (2, 33, 47, None, True), (2, 256, 256, 8, False),
    (2, 256, 256, 8, True)])
def test_compose_forms_match_plain(dev, src, n, h, w, d, round_carry):
    # K-compose with bf16 sources (the packed form) and/or the bf16 carry
    dtype = getattr(torch, src)
    r = np.random.default_rng(n * h + w + 1)
    link = _t(r.normal(size=(n + 5, 2, h, w)) * 0.6, dev).to(dtype)
    nb = _t(r.normal(size=(n + 7, h, w)) * 50, dev).to(dtype)
    flow = r.normal(size=(n, 2, h, w)) * 3
    flow[:, 0, : h // 4] += 3 * (d or 8)
    flow = _t(flow, dev)
    acc = _t(r.normal(size=(n, h, w)) * 20, dev)
    fr, ar = compose_tap_plain(link[4:4 + n], flow, nb[6:6 + n], acc,
                               float(np.float32(0.13)), d, round_carry)
    form = "compose_bf16" if src == "bfloat16" else "compose"
    before = K.LAUNCHES[form]
    compose_tap(link, flow, nb, acc, 0.13, d, 4, 6, round_carry=round_carry)
    assert K.LAUNCHES[form] == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(flow, fr, atol=0, rtol=0)
    torch.testing.assert_close(acc, ar, atol=0, rtol=0)


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,ks2,h,w,d,round_carry,symmetric", [
    (3, 3, 64, 80, 8, False, False), (2, 2, 33, 47, None, True, False),
    (2, 8, 256, 256, 8, True, True), (4, 1, 19, 130, 4, False, True),
    (1, 40, 24, 24, 8, True, False)])
def test_compose_run_kernel_matches_plain(dev, src, n, ks2, h, w, d,
                                          round_carry, symmetric):
    # K-compose-run and its bf16 form: one launch for the whole pass, equal
    # to the chain of plain steps at atol 0, with the symmetric sign and
    # ks2 40 (sigma 10)
    dtype = getattr(torch, src)
    r = np.random.default_rng(n * h + w + ks2)
    fwd = _t(r.normal(size=(n + 2 * ks2 - 1, 2, h, w)) * 0.6, dev).to(dtype)
    bwd = None if symmetric else _t(
        r.normal(size=(n + 2 * ks2 - 1, 2, h, w)) * 0.6, dev).to(dtype)
    nb = _t(r.normal(size=(n + 2 * ks2, h, w)) * 50, dev).to(dtype)
    acc = _t(r.normal(size=(n, h, w)) * 20, dev)
    weights = [float(np.float32(x)) for x in r.uniform(0.01, 0.2, 2 * ks2)]
    ref = compose_run_plain(fwd, bwd, nb, acc, weights, d, round_carry)
    form = "compose_run_bf16" if src == "bfloat16" else "compose_run"
    before = dict(K.LAUNCHES)
    out = compose_run(fwd, bwd, nb, acc, weights, d, round_carry)
    assert out is acc
    assert K.LAUNCHES == {**before, form: before[form] + 1}
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_compose_run_refuses_what_it_does_not_take(dev):
    f = torch.zeros(5, 2, 8, 8, device=dev)
    nb = torch.zeros(6, 8, 8, device=dev)
    acc = torch.zeros(2, 8, 8, device=dev)
    w = [0.1] * 4
    with pytest.raises(ValueError):
        compose_run(f, f.to(torch.bfloat16), nb, acc, w, 4)
    with pytest.raises(ValueError):
        compose_run(f.to(torch.bfloat16), None, nb, acc, w, 4)
    with pytest.raises(ValueError):
        compose_run(f, None, nb, acc.double(), w, 4)
    with pytest.raises(ValueError):
        compose_run(f.transpose(2, 3), None, nb, acc, w, 4)
    with pytest.raises(ValueError):
        compose_run(f, None, nb.cpu(), acc, w, 4)


@pytest.mark.parametrize("fields", [
    {"tap_mode": "compose"},
    {"tap_mode": "compose", "symmetric_adjacent": True},
    {"tap_mode": "compose", "symmetric_adjacent": True, "dtype": "bfloat16",
     "precision": "bfloat16"}], ids=["compose", "symmetric", "fast"])
def test_compose_denoise_card_equals_cpu(dev, fields):
    # the compose passes through K-compose-run on the card and its plain
    # version on the CPU: the same bits, 3 launches for 3 passes
    r = np.random.default_rng(1)
    z = np.arange(12)[:, None, None]
    y = np.arange(40)[None, :, None]
    x = np.arange(36)[None, None, :]
    vol = (100 * np.sin(0.3 * (x + 0.5 * z)) * np.cos(0.25 * (y - 0.3 * z))
           + r.normal(0, 10, (12, 40, 36))).astype(np.float32)
    cfg = FilterConfig(flow=FlowConfig(**fields))
    K.reset_launches()
    on_card = denoise(vol, cfg).cpu().numpy()
    form = "compose_run_bf16" if "precision" in fields else "compose_run"
    assert K.LAUNCHES[form] == 3
    assert K.LAUNCHES["compose"] == K.LAUNCHES["compose_bf16"] == 0
    on_cpu = denoise(vol, cfg, device="cpu").numpy()
    np.testing.assert_array_equal(on_card, on_cpu)


@pytest.mark.parametrize("precision", ["high", "medium"])
def test_resize_keeps_ieee_float32_under_tf32(dev, precision):
    # "high" and "medium" turn on TF32 products on the card; the resize
    # einsums stay IEEE float32 and leave the setting as they found it
    r = np.random.default_rng(3)
    img = _t(r.normal(size=(4, 2, 256, 256)) * 3, dev)
    w = _t(r.random((128, 256)), dev)
    ref = [resize_linear(img, (128, 128)), resize_area(img, (64, 64))]
    product = w @ img[0, 0]
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        # unpinned, this setting moves a float32 product
        assert not torch.equal(w @ img[0, 0], product)
        out = [resize_linear(img, (128, 128)), resize_area(img, (64, 64))]
        assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision(saved)
    for o, rr in zip(out, ref):
        torch.testing.assert_close(o, rr, atol=0, rtol=0)


def test_wrappers_refuse_what_they_do_not_take(dev):
    src = torch.zeros(2, 8, 8, device=dev)
    uv = torch.zeros(2, 8, 8, device=dev)
    with pytest.raises(ValueError):
        displace_sample(src.double(), uv, uv, 2)
    with pytest.raises(ValueError):
        displace_sample(src.transpose(1, 2), uv, uv, 2)
    r = torch.zeros(2, 5, 8, 8, device=dev)
    f = torch.zeros(2, 2, 8, 8, device=dev)
    with pytest.raises(ValueError):
        umuf_iterate(r, r, f.transpose(2, 3), 1, 2, 5)
    with pytest.raises(ValueError):
        umuf_iterate(r, r.cpu(), f, 1, 2, 5)
    # a window halo too wide for a block on a 256^2 plane (the strip planner
    # takes winsizes to 101; an 8^2 plane's stages are the plane, and any
    # winsize fits it)
    rw = torch.zeros(1, 5, 256, 256, device=dev)
    fw = torch.zeros(1, 2, 256, 256, device=dev)
    before = K.LAUNCHES["umuf"]
    with pytest.raises(ValueError, match="halo"):
        umuf_iterate(rw, rw, fw, 3, 2, 103)
    assert K.LAUNCHES["umuf"] == before
    with pytest.raises(ValueError):
        compose_tap(f, f, src, src.double(), 0.5, 2, 0, 0)
    with pytest.raises(ValueError):
        compose_tap(f, f.transpose(2, 3), src, src, 0.5, 2, 0, 0)
    with pytest.raises(ValueError):
        compose_tap(f.cpu(), f, src, src, 0.5, 2, 0, 0)
    with pytest.raises(ValueError):
        update_matrices(r, r.cpu(), f, 2)
    with pytest.raises(ValueError):
        update_matrices(r, r, f.transpose(2, 3), 2)
    with pytest.raises(ValueError):
        update_flow(r.double(), 5)
    with pytest.raises(ValueError, match="halo"):
        update_flow(r, 101)
    # the packed forms take r1 (and link with nb) in bf16, nothing else
    with pytest.raises(ValueError):
        umuf_iterate(r.to(torch.bfloat16), r, f, 1, 2, 5)
    with pytest.raises(ValueError):
        update_matrices(r, r.half(), f, 2)
    with pytest.raises(ValueError):
        compose_tap(f.to(torch.bfloat16), f, src, src, 0.5, 2, 0, 0)
    # K-umuf-split takes bf16 r0 and r1 and a bf16 or float32 flow, all
    # contiguous on the card, and K-uf's winsizes (to 85)
    rb = r.to(torch.bfloat16)
    before = K.LAUNCHES["umuf_split"]
    with pytest.raises(ValueError):
        umuf_split_iterate(r, rb, f, 1, 5)
    with pytest.raises(ValueError):
        umuf_split_iterate(rb, rb, f.double(), 1, 5)
    with pytest.raises(ValueError):
        umuf_split_iterate(rb, rb.cpu(), f, 1, 5)
    with pytest.raises(ValueError):
        umuf_split_iterate(rb, rb, f.transpose(2, 3), 1, 5)
    with pytest.raises(ValueError, match="halo"):
        umuf_split_iterate(rw.to(torch.bfloat16), rw.to(torch.bfloat16), fw, 1,
                           87)
    assert K.LAUNCHES["umuf_split"] == before


@pytest.mark.parametrize("tap_mode,presmooth,bf16", [
    ("solve", 0.0, False), ("compose", 0.0, False), ("solve", 1.5, False),
    ("solve", 0.0, True), ("compose", 0.0, True)])
def test_denoise_card_matches_cpu(dev, tap_mode, presmooth, bf16):
    r = np.random.default_rng(0)
    z = np.arange(12)[:, None, None]
    y = np.arange(40)[None, :, None]
    x = np.arange(36)[None, None, :]
    vol = (100 * np.sin(0.3 * (x + 0.5 * z)) * np.cos(0.25 * (y - 0.3 * z))
           + r.normal(0, 10, (12, 40, 36))).astype(np.float32)
    fast = dict(dtype="bfloat16", precision="bfloat16",
                symmetric_adjacent=tap_mode == "compose") if bf16 else {}
    cfg = FilterConfig(flow=FlowConfig(tap_mode=tap_mode, presmooth=presmooth,
                                       **fast))
    on_card = denoise(vol, cfg).cpu().numpy()
    on_cpu = denoise(vol, cfg, device="cpu").numpy()
    mse = np.mean((on_card.astype(np.float64) - on_cpu) ** 2)
    peak = on_cpu.max() - on_cpu.min()
    assert 10 * np.log10(peak * peak / max(mse, 1e-30)) >= 55


@pytest.mark.parametrize("fields", [
    {}, {"tap_mode": "compose", "symmetric_adjacent": True,
         "precision": "bfloat16"}], ids=["solve_bf16_nobound", "fast_nobound"])
def test_bf16_nobound_denoise_on_the_card(dev, fields):
    # the split route: K-umuf-split at every level of every solve as its
    # planner plans it (8 taps a pass in solve mode, one adjacent solve in
    # symmetric compose; 2 levels in the Z pass, 1 in the Y and X passes'
    # 12 x 64 planes; 3 iterations, one launch a level), a K-sample-split a
    # tap in solve mode, a K-compose-run-split a pass in compose mode, a
    # K-resize for each Z solve's float32 flow upsample (the bf16 seeds keep
    # the dense products), no K-uf and no other kernel; the card equals the
    # CPU bit for bit
    cfg = FilterConfig(sigma=(1.0, 1.0, 1.0), flow=FlowConfig(
        dtype="bfloat16", max_displacement=None, levels=1, **fields))
    vol = _blob_like((12, 64, 64), 2)
    K.reset_launches()
    on_card = denoise(vol, cfg).cpu().numpy()
    want = dict.fromkeys(K.LAUNCHES, 0)
    levels = [(64, 64), (32, 32), (12, 64), (12, 64)]
    want["umuf_split"] = (1 if fields else 8) * sum(
        len(plan_split(h, w, 5, 3).launches) for h, w in levels)
    assert want["umuf_split"] == (1 if fields else 8) * 4
    want["compose_run_split" if fields else "sample_split"] = 3 if fields else 24
    want["resize"] = 1 if fields else 8
    assert K.LAUNCHES == want
    np.testing.assert_array_equal(on_card, denoise(vol, cfg, device="cpu").numpy())


def _split_planes(b, h, w, seed, scale=3.0, dev=None):
    """A bf16 blob-like stack (b, h, w) and flows N(0, scale) (b, 2, h, w)
    with a band pushed 40 px past the right edge and one past the top."""
    src = torch.from_numpy(_blob_like((b, h, w), seed)).to(dev).to(torch.bfloat16)
    f = np.random.default_rng(seed).normal(size=(b, 2, h, w)) * scale
    f[:, 0, :, : w // 5] += 40
    f[:, 1, : h // 4] -= 40
    return src, _t(f, dev)


@pytest.mark.parametrize("flow_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,c,h,w,scale", [
    (3, None, 64, 80, 3.0), (2, 3, 33, 47, 3.0), (4, None, 40, 261, 3.0),
    (3, None, 8, 1030, 600.0), (2, None, 300, 20, 3.0), (8, None, 256, 256, 3.0),
])
def test_sample_split_kernel_matches_plain(dev, b, c, h, w, scale, flow_dtype):
    src, flow = _split_planes(b * (c or 1), h, w, b + w, scale, dev)
    src = src if c is None else src.reshape(b, c, h, w)
    flow = flow[:b].to(getattr(torch, flow_dtype))
    u, v = flow[:, 0], flow[:, 1]
    before = K.LAUNCHES["sample_split"]
    out = sample_split(src, u, v)
    ref = sample_split_plain(src, u, v)
    acc = (src * 0.3125).flip(0).contiguous()
    acc_ref = sample_split_plain(src, u, v, acc.clone(), 0.09375)
    assert sample_split(src, u, v, acc, 0.09375) is acc
    assert K.LAUNCHES["sample_split"] == before + 2
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype == flow.dtype
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    torch.testing.assert_close(acc, acc_ref, atol=0, rtol=0)


@pytest.mark.parametrize("n,ks2,h,w,symmetric", [
    (3, 2, 64, 80, False), (2, 8, 40, 261, True), (2, 8, 8, 1030, False),
    (2, 12, 37, 70, True), (16, 8, 256, 256, True),
])
def test_compose_run_split_kernel_matches_plain(dev, n, ks2, h, w, symmetric):
    nb, links = _split_planes(n + 2 * ks2, h, w, n + w, 1.5, dev)
    fwd = links[:-1].to(torch.bfloat16)
    bwd = None if symmetric else links[1:].flip(0).contiguous().to(torch.bfloat16)
    acc = nb[ks2:ks2 + n] * 0.25
    weights = [float(torch.tensor(0.3 / (j + 1)).to(torch.bfloat16))
               for j in range(2 * ks2)]
    ref = compose_chain_plain(fwd, bwd, nb, acc.clone(), weights)
    before = K.LAUNCHES["compose_run_split"]
    out = compose_run_split(fwd, bwd, nb, acc, weights)
    assert K.LAUNCHES["compose_run_split"] == before + 1
    torch.cuda.synchronize()
    assert out is acc and out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_split_forms_refuse_what_they_do_not_take(dev):
    # K-sample-split: a bf16 source, bf16 or float32 flows of one dtype, a
    # bf16 accumulator; K-compose-run-split: everything bf16 and contiguous
    src, flow = _split_planes(2, 8, 8, 1, dev=dev)
    u, v = flow[:, 0], flow[:, 1]
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError):
        sample_split(src.float(), u, v)
    with pytest.raises(ValueError):
        sample_split(src, u.double(), v.double())
    with pytest.raises(ValueError):
        sample_split(src, u.to(torch.bfloat16), v)
    with pytest.raises(ValueError):
        sample_split(src, u, v, src.float(), 0.5)
    with pytest.raises(ValueError):
        sample_split(src.transpose(1, 2), u, v)
    with pytest.raises(ValueError):
        sample_split(src, u.cpu(), v.cpu())
    links = flow.to(torch.bfloat16)[:1]
    nb = src
    acc = src[:0]
    with pytest.raises(ValueError):
        compose_run_split(links.float(), None, nb, acc, [0.5, 0.5])
    with pytest.raises(ValueError):
        compose_run_split(links, None, nb, acc.float(), [0.5, 0.5])
    with pytest.raises(ValueError):
        compose_run_split(links, None, nb.transpose(1, 2), acc, [0.5, 0.5])
    assert K.LAUNCHES == before


def _blob_like(shape, seed):
    r = np.random.default_rng(seed)
    z, y, x = (np.arange(s).reshape([-1 if a == i else 1 for a in range(3)])
               for i, s in enumerate(shape))
    return (100 * np.sin(0.3 * (x + 0.5 * z)) * np.cos(0.25 * (y - 0.3 * z))
            + r.normal(0, 10, shape)).astype(np.float32)


@pytest.mark.parametrize("boundary,overlap", [
    ("wrap", True), ("mean", True), ("replicate", False)])
def test_streamed_solve_equals_whole_axis(dev, tmp_path, boundary, overlap):
    # windows of 7 planes (a shifted tail on every axis) through the side
    # stream and pinned buffers, against the in-memory whole axis
    from flowdenoising_tpu_torch.config import Boundary
    from flowdenoising_tpu_torch.core.stream import denoise_streamed
    vol = _blob_like((20, 40, 36), 3)
    cfg = FilterConfig(sigma=(1.0, 1.0, 1.0), boundary=Boundary(boundary),
                       flow=FlowConfig(levels=2, max_displacement=4))
    whole = denoise(vol, cfg).cpu().numpy()
    before = dict(K.LAUNCHES)
    out = denoise_streamed(vol, cfg, slab_size=7, tmp_dir=str(tmp_path),
                           overlap=overlap)
    windows = sum(-(-n // 7) for n in vol.shape)
    assert K.LAUNCHES["sample"] - before["sample"] == 8 * windows
    np.testing.assert_array_equal(out, whole)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("to_host", [True, False])
def test_denoise_many_on_the_card(dev, to_host):
    from flowdenoising_tpu_torch.core.pipeline import denoise_many
    cfg = FilterConfig(sigma=(1.0, 1.0, 1.0),
                       flow=FlowConfig(levels=2, max_displacement=4))
    vols = [_blob_like((12, 40, 36), s) for s in range(4)]
    held = torch.from_numpy(vols[1]).to(dev)
    outs = denoise_many([vols[0], held, *vols[2:]], cfg, window=2,
                        to_host=to_host)
    assert torch.equal(held.cpu(), torch.from_numpy(vols[1]))
    for v, out in zip(vols, outs):
        assert isinstance(out, np.ndarray) == to_host
        got = out if to_host else out.cpu().numpy()
        np.testing.assert_array_equal(got, denoise(v, cfg).cpu().numpy())


def test_resize_gives_a_plane_the_same_bits_in_any_batch(dev):
    # the level-0 flow upsampling of a 512x1024 pass: with the batch folded
    # into a matrix dimension, the planes at the end of 2048 came out other
    # than in a window of them
    r = np.random.default_rng(5)
    flow = _t(r.normal(size=(1024, 2, 256, 512)) * 2, dev)
    whole = resize_linear(flow, (512, 1024))
    for a in (0, 871):
        torch.testing.assert_close(resize_linear(flow[a:a + 153], (512, 1024)),
                                   whole[a:a + 153], atol=0, rtol=0)


def _plain_pyramid(img, cfg):
    return [F.poly_expand(i, cfg.poly_n, cfg.poly_sigma, channel_first=True)
            for i in F.image_pyramid(img, cfg)]


@pytest.mark.parametrize("b", [1, 17])
@pytest.mark.parametrize("h,w", [(1, 1), (3, 5), (8, 1030), (40, 261),
                                 (96, 80), (184, 630), (165, 1024)])
def test_polyexp_pyramid_kernels_equal_the_plain_pyramid(dev, b, h, w):
    # levels 0-3 with min_size 1, so that narrow planes have levels too and
    # planes narrower than the 19-tap blur and the 11-tap expansion reflect
    # and replicate past their width
    r = np.random.default_rng(h * w + b)
    x = _t(r.normal(size=(b, h, w)) * 50 + 100, dev)
    for levels in range(4):
        cfg = FlowConfig(levels=levels, min_size=1)
        n = cfg.clamped_levels(h, w) + 1
        before = dict(K.LAUNCHES)
        out = F.polyexp_pyramid(x, cfg)
        assert K.LAUNCHES == {**before, "polyexp": before["polyexp"] + n,
                              "pyr_blur": before["pyr_blur"] + n - 1,
                              "resize": before["resize"] + n - 1}
        ref = _plain_pyramid(x, cfg)
        torch.cuda.synchronize()
        assert len(out) == len(ref) == n
        for o, rf in zip(out, ref):
            assert o.is_contiguous() and torch.equal(o, rf), (levels, o.shape)


def test_polyexp_kernels_take_leading_dims_and_poly_sigma(dev):
    r = np.random.default_rng(7)
    x = _t(r.normal(size=(2, 3, 70, 45)) * 50, dev)
    cfg = FlowConfig(levels=2, min_size=8, poly_sigma=1.5)
    before = K.LAUNCHES["polyexp"]
    out = F.polyexp_pyramid(x, cfg)
    assert K.LAUNCHES["polyexp"] == before + 3
    for o, rf in zip(out, _plain_pyramid(x, cfg)):
        assert o.shape[:3] == (2, 3, 5) and torch.equal(o, rf)


@pytest.mark.parametrize("poly_n", [1, 2, 3, 7, 300])
def test_polyexp_kernels_take_any_poly_n(dev, poly_n):
    # every n but 5 runs through device memory; 300 is 601 taps, two chunks
    # of correlation launches, wider than the planes
    r = np.random.default_rng(poly_n)
    x = _t(r.normal(size=(3, 70, 45)) * 50 + 100, dev)
    cfg = FlowConfig(levels=2, min_size=8, poly_n=poly_n,
                     poly_sigma=0.3 * poly_n + 0.5)
    before = dict(K.LAUNCHES)
    out = F.polyexp_pyramid(x, cfg)
    assert K.LAUNCHES == {**before, "polyexp": before["polyexp"] + 3,
                          "pyr_blur": before["pyr_blur"] + 2,
                          "resize": before["resize"] + 2}
    for o, rf in zip(out, _plain_pyramid(x, cfg)):
        assert o.is_contiguous() and torch.equal(o, rf)


def test_polyexp_kernels_take_pyramids_past_the_tile_blur(dev):
    # levels 7 and 8 pre-blur with 319 and 639 taps: through device memory
    x = _t(np.random.default_rng(8).normal(size=(2, 300, 300)) * 50, dev)
    cfg = FlowConfig(levels=8, min_size=1)
    before = dict(K.LAUNCHES)
    out = F.polyexp_pyramid(x, cfg)
    assert K.LAUNCHES == {**before, "polyexp": before["polyexp"] + 9,
                          "pyr_blur": before["pyr_blur"] + 8,
                          "resize": before["resize"] + 8}
    ref = _plain_pyramid(x, cfg)
    assert len(out) == len(ref) == 9
    for o, rf in zip(out, ref):
        assert torch.equal(o, rf), o.shape


@pytest.mark.parametrize("ntaps", [1, 3, 19, 155, 235, 237, 319, 1025])
def test_pyr_blur_kernel_equals_plain(dev, ntaps):
    # 155 taps: a block above 48 KB of shared memory; 235: the smallest tile;
    # from 237 through device memory, 1025 in three chunks a pass
    from flowdenoising_tpu_torch.ops.blur import _sep_correlate
    from flowdenoising_tpu_torch.ops.cuda.polyexp import pyr_blur
    taps = np.exp(-np.linspace(-2, 2, ntaps) ** 2)
    taps /= taps.sum()
    x = _t(np.random.default_rng(ntaps).normal(size=(3, 37, 300)) * 50, dev)
    before = K.LAUNCHES["pyr_blur"]
    out = pyr_blur(x, taps)
    assert K.LAUNCHES["pyr_blur"] == before + 1
    assert torch.equal(out, _sep_correlate(x, taps, taps, "reflect"))


def test_bf16_pyramid_takes_the_plain_chain_on_the_card(dev):
    x = _t(np.random.default_rng(3).normal(size=(4, 64, 64)) * 50,
           dev).to(torch.bfloat16)
    cfg = FlowConfig(dtype="bfloat16")
    before = dict(K.LAUNCHES)
    out = F.polyexp_pyramid(x, cfg)
    assert K.LAUNCHES == before
    for o, rf in zip(out, _plain_pyramid(x, cfg)):
        assert o.dtype == torch.bfloat16 and torch.equal(o, rf)


def test_polyexp_wrappers_refuse_what_they_do_not_take(dev):
    from flowdenoising_tpu_torch.ops.cuda.polyexp import expand_level, pyr_blur
    x = torch.zeros(2, 16, 16, device=dev)
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError):
        expand_level(x.to(torch.bfloat16), 5, F.poly_exp_constants(5, 1.2))
    with pytest.raises(ValueError):
        expand_level(x, 0, F.poly_exp_constants(0, 1.2))   # no Gram matrix
    with pytest.raises(ValueError):
        expand_level(x, 5, F.poly_exp_constants(5, 1.2), blur=np.ones(5) / 5)
    with pytest.raises(ValueError):
        pyr_blur(x.double(), np.ones(3) / 3)
    with pytest.raises(ValueError):
        pyr_blur(x, np.ones(4) / 4)
    assert K.LAUNCHES == before

"""K-resize (``csrc/resize.cu``) against the dense products it replaced, on
the card.

Marked ``cuda``; they skip on a host without a CUDA device (the kernel has
no CPU mode).  The file imports neither JAX nor the test suite's conftest,
so it runs on a machine with the card and no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_resize_kernel.py

Every resize of the benchmark's passes and of the auto probe's device
planes, at the passes' batch sizes, is held to ``_apply_separable``'s
cuBLAS products on the same card bit for bit: the pyramid's image
downsamples from full resolution (2, 4 and 8x), the (B, 2, h, w) flow
upsamples from the level above, and the seed flow's area resize to the
coarsest level.
"""

import numpy as np
import pytest
import torch

from flowdenoising_tpu_torch.config import FlowConfig
from flowdenoising_tpu_torch.ops import cuda as K
from flowdenoising_tpu_torch.ops import resize as R

pytestmark = pytest.mark.cuda

# (planes of a pass, batch): the Z, Y and X passes of 165x768x1024 and of
# 184x630x630, and the probe's buckets
PASSES = (((768, 1024), 165), ((165, 1024), 768), ((165, 768), 1024),
          ((630, 630), 184), ((184, 630), 630), ((128, 128), 24),
          ((64, 256), 24))


def _cases():
    cfg = FlowConfig()
    out = []
    for (h, w), b in PASSES:
        sizes = R.pyramid_sizes(h, w, cfg.clamped_levels(h, w), cfg.pyr_scale)
        for k in range(1, len(sizes)):
            out.append(("linear", (b, h, w), sizes[k]))
            out.append(("linear", (b, 2) + sizes[k], sizes[k - 1]))
        out.append(("area", (b, 2, h, w), sizes[-1]))
    return out


CASES = _cases()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("kind,shape,out_hw", CASES,
                         ids=[f"{k}-{'x'.join(map(str, s))}-to-{o[0]}x{o[1]}"
                              for k, s, o in CASES])
def test_the_kernel_gives_the_dense_products_bits(dev, kind, shape, out_hw):
    r = np.random.default_rng(sum(shape) + out_hw[0])
    scale = 60.0 if len(shape) == 3 else 3.0    # an image, a flow
    x = torch.from_numpy((r.normal(size=shape) * scale + (
        100 if len(shape) == 3 else 0)).astype(np.float32)).to(dev)
    fn = R.resize_linear if kind == "linear" else R.resize_area
    m = R._MATRICES[kind]
    before = K.LAUNCHES["resize"]
    out = fn(x, out_hw)
    assert K.LAUNCHES["resize"] == before + 1
    ref = R._apply_separable(x, m(shape[-2], out_hw[0]), m(shape[-1], out_hw[1]))
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == torch.float32
    diff = int((_bits(out) != _bits(ref)).sum())
    assert diff == 0, (f"{diff} values differ; max abs diff "
                       f"{float((out - ref).abs().max())}")


def _names(fn, device: bool) -> list[str]:
    """The names of the host events (``device`` false) or of the device
    events of a profiled ``fn()``, those that start within it: the call is
    marked by a range, so records the profiler kept from before it are
    left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("test.call"):
            fn()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    mark = [e for e in events if e.name() == "test.call"
            and e.device_type() != DeviceType.CUDA]
    assert len(mark) == 1
    start, end = mark[0].start_ns(), mark[0].end_ns()
    return [e.name() for e in events
            if (e.device_type() == DeviceType.CUDA) == device
            and start <= e.start_ns() <= end and e.name() != "test.call"]


def test_a_resize_is_one_kernel_and_no_product(dev, monkeypatch):
    x = torch.randn((24, 2, 96, 128), device=dev)
    ref = R._apply_separable(x, R.linear_resize_matrix(96, 192),
                             R.linear_resize_matrix(128, 256))

    def refuse(*args, **kwargs):
        raise AssertionError("a dense product ran")

    monkeypatch.setattr(torch, "bmm", refuse)
    R.resize_linear(x, (192, 256))
    before = K.LAUNCHES["resize"]
    kernels = _names(lambda: R.resize_linear(x, (192, 256)), device=True)
    assert K.LAUNCHES["resize"] == before + 1
    # (the profiler mirrors the host range fdt.resize on the device too)
    assert len([n for n in kernels if "resize" in n and "kernel" in n]) == 1, kernels
    assert not any(k in n.lower() for n in kernels
                   for k in ("gemm", "cutlass", "xmma", "nvjet")), kernels
    host = _names(lambda: R.resize_linear(x, (192, 256)), device=False)
    assert host.count("fdt.resize") == 1, host
    assert torch.equal(_bits(R.resize_linear(x, (192, 256))), _bits(ref))


def test_a_shape_copies_its_tables_once(dev):
    x = torch.randn((3, 2, 77, 61), device=dev)
    first = _names(lambda: R.resize_area(x, (19, 23)), device=False)
    assert first.count("fdt.drain.resize_matrix") == 2
    again = _names(lambda: R.resize_area(x, (19, 23)), device=False)
    assert again.count("fdt.drain.resize_matrix") == 0
    assert again.count("fdt.resize") == 1


def test_a_bf16_tensor_keeps_the_dense_products(dev):
    x = torch.randn((4, 2, 64, 80), device=dev).to(torch.bfloat16)
    before = K.LAUNCHES["resize"]
    out = R.resize_linear(x, (128, 160))
    ref = R._apply_separable(x, R.linear_resize_matrix(64, 128),
                             R.linear_resize_matrix(80, 160))
    assert K.LAUNCHES["resize"] == before
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)


def _sequential(x: torch.Tensor, kind: str, out_hw) -> torch.Tensor:
    """The two products as sequential multiply-adds: each sum starts at 0
    and adds each source index's product in ascending order, rows first,
    every step rounded to float32 once (the products are exact in float64),
    on x's device and independent of any library's order of the sums."""
    m = R._MATRICES[kind]

    def weights(n_in, n_out):
        return torch.from_numpy(m(n_in, n_out).astype(np.float32)).to(
            x.device, torch.float64)

    wr = weights(x.shape[-2], out_hw[0])
    wc = weights(x.shape[-1], out_hw[1])
    xd = x.double()
    t = torch.zeros(x.shape[:-2] + (out_hw[0], x.shape[-1]),
                    dtype=torch.float32, device=x.device)
    for k in range(x.shape[-2]):
        t = (t.double() + wr[:, k, None] * xd[..., k:k + 1, :]).float()
    td = t.double()
    out = torch.zeros(x.shape[:-2] + tuple(out_hw), dtype=torch.float32,
                      device=x.device)
    for k in range(x.shape[-1]):
        out = (out.double() + td[..., :, k:k + 1] * wc[:, k]).float()
    return out


# (kind, a view of a (6, 3, 50, 2100) stack, output size): a non-contiguous
# view, a single plane, one output row or column, an axis kept, ratios that
# are not whole, wide area taps.  cuBLAS does not sum every one of these in
# order (on a single plane of 50 x 2100 to 7 x 40, 168 of its 280 values
# came out 1 ulp away), so they are held to the sequential sums.
ODD = (("linear", np.s_[:, 1, :, :300], (100, 599)),
       ("linear", np.s_[0, 0, :, :600], (37, 1000)),
       ("area", np.s_[0, 0], (7, 40)),
       ("area", np.s_[0, 0, :, :300], (7, 40)),
       ("area", np.s_[:, :, :9, :64], (1, 1)),
       ("linear", np.s_[:2, :, :1, :10], (5, 1)),
       ("linear", np.s_[..., :200], (50, 77)),
       ("area", np.s_[..., :600], (25, 30)))


@pytest.mark.parametrize("kind,view,out_hw", ODD,
                         ids=[f"{k}-{i}" for i, (k, _, _) in enumerate(ODD)])
def test_views_and_odd_shapes_give_the_sequential_sums(dev, kind, view,
                                                       out_hw):
    r = np.random.default_rng(11)
    x = torch.from_numpy(r.normal(size=(6, 3, 50, 2100)).astype(
        np.float32)).to(dev)[view]
    fn = R.resize_linear if kind == "linear" else R.resize_area
    out = fn(x, out_hw)
    ref = _sequential(x, kind, out_hw)
    diff = int((_bits(out) != _bits(ref)).sum())
    assert diff == 0, (tuple(x.shape), diff, float((out - ref).abs().max()))


def test_the_sequential_sums_are_the_dense_products_at_a_cell_shape(dev):
    """The reference above is the dense products wherever cuBLAS sums in
    order: the probe bucket's flow upsample at 24 planes."""
    x = torch.from_numpy(np.random.default_rng(12).normal(
        size=(24, 2, 32, 32)).astype(np.float32) * 3).to(dev)
    m = R.linear_resize_matrix
    assert torch.equal(_bits(_sequential(x, "linear", (64, 64))), _bits(
        R._apply_separable(x, m(32, 64), m(32, 64))))

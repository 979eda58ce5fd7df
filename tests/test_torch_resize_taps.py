"""K-resize's tap tables (``ops/resize.py: tap_table``) and its route.

Each table, scattered back to a dense matrix, is the weight matrix the
dense products multiply by (``linear_resize_matrix`` /
``area_resize_matrix`` cast to float32), exactly: at every axis size the
benchmark's pyramids, flow resizes and the auto probe's device planes use,
and at the edges (one output, one input, up and down, ratios that are not
whole, area upscaling that falls back to linear).  A CPU or bfloat16
tensor keeps the dense products; the kernel itself runs only on the card
(``tests/test_torch_resize_kernel.py``).
"""

import math

import numpy as np
import pytest
import torch

from flowdenoising_tpu_torch.config import FlowConfig
from flowdenoising_tpu_torch.ops import cuda as K
from flowdenoising_tpu_torch.ops import resize as R
from flowdenoising_tpu_torch.ops.cuda import resize as KR
from flowdenoising_tpu_torch.ops.device import use_kernel

# the planes of the benchmark's passes (165x768x1024, 184x630x630) and the
# auto probe's buckets
PLANES = ((768, 1024), (165, 1024), (165, 768), (630, 630), (184, 630),
          (128, 128), (64, 256))


def _cell_axes() -> list[tuple[str, int, int]]:
    """(kind, n_in, n_out) of every resize on those planes: each level's
    image from full resolution and each flow from the level above
    (linear), the seed flow from full resolution to the coarsest level
    (area)."""
    cfg = FlowConfig()
    axes = set()
    for h, w in PLANES:
        sizes = R.pyramid_sizes(h, w, cfg.clamped_levels(h, w), cfg.pyr_scale)
        for a in range(2):
            for k in range(1, len(sizes)):
                axes.add(("linear", sizes[0][a], sizes[k][a]))
                axes.add(("linear", sizes[k][a], sizes[k - 1][a]))
            axes.add(("area", sizes[0][a], sizes[-1][a]))
    return sorted(axes)


CELL_AXES = _cell_axes()
EDGES = [(kind, n_in, n_out) for kind in ("linear", "area")
         for n_in, n_out in ((1, 1), (1, 7), (9, 1), (630, 1), (5, 5), (2, 3),
                             (3, 2), (7, 3), (100, 33), (33, 100), (79, 158),
                             (158, 79), (41, 82), (1024, 96), (96, 1024))]


def _dense(start: np.ndarray, weights: np.ndarray, n_in: int) -> np.ndarray:
    out = np.zeros((len(start), n_in), np.float32)
    cols = start[:, None].astype(np.int64) + np.arange(weights.shape[1])
    np.put_along_axis(out, cols, weights, axis=1)
    return out


def test_the_cells_axes_are_the_ones_named():
    """The derivation reaches the pyramids the cells run."""
    for chain in ((768, 384, 192, 96), (165, 82, 41), (630, 315, 158, 79)):
        for big, small in zip(chain, chain[1:]):
            assert ("linear", chain[0], small) in CELL_AXES
            assert ("linear", small, big) in CELL_AXES
        assert ("area", chain[0], chain[-1]) in CELL_AXES


@pytest.mark.parametrize("kind,n_in,n_out", CELL_AXES + EDGES)
def test_a_tap_table_is_the_dense_matrix_in_float32(kind, n_in, n_out):
    start, weights = R.tap_table(kind, n_in, n_out)
    matrix = R._MATRICES[kind](n_in, n_out)
    assert start.dtype == np.int32 and weights.dtype == np.float32
    assert start.shape == (n_out,) and weights.shape[0] == n_out
    # the kernel reads each run inside the axis
    taps = weights.shape[1]
    assert start.min() >= 0 and start.max() + taps <= n_in
    # bit for bit, zeros included
    np.testing.assert_array_equal(
        _dense(start, weights, n_in).view(np.uint32),
        matrix.astype(np.float32).view(np.uint32))


@pytest.mark.parametrize("kind,n_in,n_out", CELL_AXES + EDGES)
def test_a_tap_table_is_as_wide_as_its_kind_needs(kind, n_in, n_out):
    taps = R.tap_table(kind, n_in, n_out)[1].shape[1]
    if n_in == n_out:
        assert taps == 1
    elif kind == "linear" or n_out > n_in:
        assert taps <= 2
    else:
        assert taps <= math.ceil(n_in / n_out) + 1


def test_area_upscaling_takes_the_linear_taps():
    for n_in, n_out in ((1, 7), (33, 100), (96, 1024)):
        for got, want in zip(R.tap_table("area", n_in, n_out),
                             R.tap_table("linear", n_in, n_out)):
            np.testing.assert_array_equal(got, want)


def test_a_tap_table_is_cached_and_read_only():
    a = R.tap_table("linear", 384, 768)
    assert R.tap_table("linear", 384, 768) is a
    with pytest.raises(ValueError):
        a[1][0, 0] = 2.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_cpu_tensor_takes_the_dense_products(dtype, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("K-resize launched for a CPU tensor")

    monkeypatch.setattr(KR, "resize", refuse)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, 2, 40, 36)).astype(np.float32)).to(dtype)
    before = K.LAUNCHES["resize"]
    for fn, kind, hw in ((R.resize_linear, "linear", (20, 18)),
                         (R.resize_area, "area", (5, 9))):
        m = R._MATRICES[kind]
        assert not use_kernel(x, "resize", float32=True)
        assert torch.equal(fn(x, hw), R._apply_separable(
            x, m(40, hw[0]), m(36, hw[1])))
    assert K.LAUNCHES["resize"] == before


def test_the_route_reads_device_and_dtype():
    x = torch.zeros((2, 8, 8))
    assert not use_kernel(x, "resize", float32=True)
    assert not use_kernel(x.to(torch.bfloat16), "resize", float32=True)
    table = R.device_table("linear", 8, 4, x.device)
    with pytest.raises(ValueError, match="on the card"):
        KR.resize(x, (4, 4), table, table)

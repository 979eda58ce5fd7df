"""The port's disk-streamed denoise (``core/stream.py``) on the CPU: its
window gathering against the JAX package's at atol 0, the stream against
the port's in-memory pipeline at atol 0 (every boundary, the Gaussian and
the solve pass, a slab that does not divide the axis, the overlap off),
memmap input, ``out=``/progress, the scratch directory, the slice
against JAX's ``denoise_streamed`` (the Gaussian at
``tests/test_torch_pipeline.py``'s tolerance, solve at >= 55 dB, the
repo's end-to-end bar) and the CLI's ``--stream`` against its in-memory run.
"""

import numpy as np
import pytest
import torch

from conftest import make_blob_volume
from ref_pipeline import psnr
from flowdenoising_tpu.config import Boundary as JBoundary
from flowdenoising_tpu.config import FilterConfig as JFilterConfig
from flowdenoising_tpu.config import FlowConfig as JFlowConfig
from flowdenoising_tpu.core.stream import _boundary_window as j_boundary_window
from flowdenoising_tpu.core.stream import denoise_streamed as j_denoise_streamed

from flowdenoising_tpu_torch import cli
from flowdenoising_tpu_torch.config import (
    Boundary, FilterConfig, FlowConfig, from_reference)
from flowdenoising_tpu_torch.core.pipeline import denoise
from flowdenoising_tpu_torch.core.stream import _boundary_window, denoise_streamed
from flowdenoising_tpu_torch.io.mrc import read_mrc, write_mrc
from flowdenoising_tpu_torch.io.tiff import read_tiff, write_tiff

torch.set_num_threads(1)


def _vol(shape=(12, 24, 20), seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float32) * 40 + 100


def _cfg(boundary, use_flow, slab_size=None):
    return FilterConfig(sigma=(1.0, 1.0, 1.0), boundary=boundary,
                        use_flow=use_flow, slab_size=slab_size,
                        flow=FlowConfig(levels=1, winsize=5, max_displacement=4))


@pytest.mark.parametrize("boundary", list(Boundary))
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("lo,hi", [(-3, 4), (2, 9), (-2, 8), (-9, 14)])
def test_boundary_window_matches_jax(boundary, axis, lo, hi):
    # ranges before the start, past the end, past both ends, and wider
    # than every axis (wrapping more than once)
    src = np.arange(5 * 6 * 7, dtype=np.float32).reshape(5, 6, 7) * 0.5 - 3
    ref = j_boundary_window(src, axis, lo, hi, JBoundary(boundary.value), 0.25)
    out = _boundary_window(src, axis, lo, hi, boundary, np.float32(0.25))
    assert out.dtype == np.float32 and out.flags.c_contiguous
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("boundary", list(Boundary))
def test_boundary_window_int16_memmap_matches_jax(tmp_path, boundary):
    vol = _vol((6, 8, 9), seed=4).astype(np.int16)
    mm = np.memmap(tmp_path / "v.i16", dtype=np.int16, mode="w+", shape=vol.shape)
    mm[...] = vol
    mm.flush()
    src = np.memmap(tmp_path / "v.i16", dtype=np.int16, mode="r", shape=vol.shape)
    for axis in range(3):
        ref = j_boundary_window(src, axis, -4, src.shape[axis] + 3,
                                JBoundary(boundary.value), 101.5)
        out = _boundary_window(src, axis, -4, src.shape[axis] + 3, boundary,
                               np.float32(101.5))
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("boundary", list(Boundary))
@pytest.mark.parametrize("use_flow", [False, True])
def test_streamed_equals_in_memory(tmp_path, boundary, use_flow):
    # slab 5 divides none of 12, 24, 20: every pass ends in a shifted tail
    vol = _vol()
    cfg = _cfg(boundary, use_flow)
    ref = denoise(vol, cfg, device="cpu").numpy()
    out = denoise_streamed(vol, cfg, slab_size=5, tmp_dir=str(tmp_path),
                           device="cpu")
    np.testing.assert_array_equal(out, ref)
    assert list(tmp_path.iterdir()) == []


def test_overlap_off_gives_the_same_bits(tmp_path):
    vol = _vol()
    cfg = _cfg(Boundary.MEAN, True)
    on = denoise_streamed(vol, cfg, slab_size=5, tmp_dir=str(tmp_path),
                          device="cpu")
    off = denoise_streamed(vol, cfg, slab_size=5, tmp_dir=str(tmp_path),
                           device="cpu", overlap=False)
    np.testing.assert_array_equal(on, off)


def test_streamed_from_int16_memmap(tmp_path):
    vol = _vol((9, 18, 22), seed=7).astype(np.int16)
    mm = np.memmap(tmp_path / "in.i16", dtype=np.int16, mode="w+", shape=vol.shape)
    mm[...] = vol
    mm.flush()
    src = np.memmap(tmp_path / "in.i16", dtype=np.int16, mode="r", shape=vol.shape)
    cfg = _cfg(Boundary.WRAP, False)
    ref = denoise(vol.astype(np.float32), cfg, device="cpu").numpy()
    out = denoise_streamed(src, cfg, slab_size=4, tmp_dir=str(tmp_path),
                           device="cpu")
    np.testing.assert_array_equal(out, ref)


def test_out_array_progress_and_scratch(tmp_path):
    vol = _vol((8, 16, 16), seed=9)
    cfg = FilterConfig(sigma=(0.5, 0.5, 0.5), use_flow=False)
    dst = np.zeros_like(vol)
    calls, passes, scratch = [], [], []

    def on_pass(i, v):
        passes.append(i)
        scratch.extend(p for p in tmp_path.iterdir())

    out = denoise_streamed(vol, cfg, slab_size=3, tmp_dir=str(tmp_path),
                           out=dst, progress=lambda d, t: calls.append((d, t)),
                           on_pass=on_pass, device="cpu")
    assert out is dst
    assert passes == [0, 1, 2]
    # one call a window, output planes counted once (the tail's recomputed
    # planes are not counted again)
    assert [d for d, _ in calls] == [3, 6, 8, 11, 14, 17, 20, 23, 24, 27, 30,
                                     33, 36, 39, 40]
    assert calls[-1] == (sum(vol.shape), sum(vol.shape))
    assert scratch and list(tmp_path.iterdir()) == []
    np.testing.assert_array_equal(dst, denoise(vol, cfg, device="cpu").numpy())


def test_scratch_removed_when_the_run_fails(tmp_path):
    def boom(i, v):
        raise RuntimeError("stop")

    with pytest.raises(RuntimeError, match="stop"):
        denoise_streamed(_vol((8, 16, 16)), _cfg(Boundary.WRAP, False),
                         slab_size=3, tmp_dir=str(tmp_path), on_pass=boom,
                         device="cpu")
    assert list(tmp_path.iterdir()) == []


def test_default_device_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test checks a host without it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        denoise_streamed(_vol((8, 16, 16)), _cfg(Boundary.WRAP, False))


@pytest.mark.parametrize("boundary", list(JBoundary))
def test_gaussian_stream_matches_jax(tmp_path, boundary):
    vol = make_blob_volume(10, 24, 20, seed=5)
    jc = JFilterConfig(sigma=(2.0, 1.0, 1.5), boundary=boundary, use_flow=False)
    ref = np.asarray(j_denoise_streamed(vol, jc, slab_size=4,
                                        tmp_dir=str(tmp_path)))
    out = denoise_streamed(vol, from_reference(jc), slab_size=4,
                           tmp_dir=str(tmp_path), device="cpu")
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max())


def test_solve_stream_matches_jax(tmp_path):
    vol = make_blob_volume(12, 24, 20, seed=3)
    jc = JFilterConfig(sigma=(1.0, 1.0, 1.0), boundary=JBoundary.WRAP,
                       flow=JFlowConfig(levels=1, winsize=5, max_displacement=4))
    ref = np.asarray(j_denoise_streamed(vol, jc, slab_size=5,
                                        tmp_dir=str(tmp_path)))
    out = denoise_streamed(vol, from_reference(jc), slab_size=5,
                           tmp_dir=str(tmp_path), device="cpu")
    value = psnr(out, ref)
    print(f"streamed solve: PSNR {value:.2f} dB vs JAX")
    assert value >= 55.0, value


@pytest.mark.parametrize("fmt", ["mrc", "tif"])
def test_cli_stream_equals_cli_in_memory(tmp_path, fmt):
    vol = make_blob_volume(8, 24, 20, seed=11)
    src = tmp_path / f"in.{fmt}"
    if fmt == "mrc":
        write_mrc(src, vol)
    else:
        write_tiff(src, (vol * 100).astype(np.int16))
    args = ["-i", str(src), "-s", "1", "1", "1", "-l", "1",
            "--max_displacement", "4", "--boundary", "mean", "--device", "cpu"]
    assert cli.main([*args, "-o", str(tmp_path / f"mem.{fmt}")]) == 0
    assert cli.main([*args, "--stream", "--slab_size", "3",
                     "-o", str(tmp_path / f"str.{fmt}")]) == 0
    if fmt == "mrc":
        mem, _ = read_mrc(tmp_path / "mem.mrc")
        got, _ = read_mrc(tmp_path / "str.mrc")
    else:
        mem, got = read_tiff(tmp_path / "mem.tif"), read_tiff(tmp_path / "str.tif")
    np.testing.assert_array_equal(got, mem)

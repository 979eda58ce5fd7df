"""The port's sharded pipeline (``parallel/mesh.py``) on meshes of CPU
shards: every sharded output equals the port's single-device
``denoise``/``gaussian_denoise``/``denoise_streamed`` bit for bit (the halo
and the reshard only move planes, and a plane's result depends only on its
window), and the Gaussian and the uneven Gaussian also match the JAX
package's ``denoise_sharded`` on its 8-device virtual CPU mesh at
``tests/test_sharding.py``'s bar (atol 2e-3), the flow path at the port's
55 dB against JAX (``slow``: JAX's sharded flow program compiles for
about a minute here).
"""

import numpy as np
import pytest
import torch

from conftest import make_blob_volume
from ref_pipeline import psnr
from flowdenoising_tpu.config import Boundary as JBoundary
from flowdenoising_tpu.config import FilterConfig as JFilterConfig
from flowdenoising_tpu.config import FlowConfig as JFlowConfig
from flowdenoising_tpu.parallel import mesh as jmesh

from flowdenoising_tpu_torch import cli
from flowdenoising_tpu_torch.config import (
    Boundary, FilterConfig, FlowConfig, from_reference)
from flowdenoising_tpu_torch.core import memory
from flowdenoising_tpu_torch.core.pipeline import denoise, gaussian_denoise
from flowdenoising_tpu_torch.core.stream import denoise_streamed
from flowdenoising_tpu_torch.io.mrc import read_mrc, write_mrc
from flowdenoising_tpu_torch.parallel import mesh
from flowdenoising_tpu_torch.parallel.mesh import (
    LocalShards, denoise_sharded, halo_exchange, make_mesh,
    sharded_window_pass, usable_device_count)

torch.set_num_threads(1)

CPU8 = make_mesh(8, device="cpu")


def _of(boundary=Boundary.WRAP, sigma=(0.5, 0.5, 0.5), **flow):
    flow = {"levels": 0, "winsize": 5, **flow}
    return FilterConfig(sigma=sigma, boundary=boundary, flow=FlowConfig(**flow))


def _sharded(vol, cfg, **kw):
    return denoise_sharded(vol, cfg, n_devices=8, device="cpu", **kw).numpy()


def _single(vol, cfg):
    return denoise(vol, cfg, device="cpu").numpy()


@pytest.mark.parametrize("n_dev", range(1, 9))
def test_usable_device_count_and_pass_extent_match_jax(n_dev):
    for shape in [(16, 24, 16), (12, 24, 16), (7, 11, 13), (3, 16, 16),
                  (10, 24, 16), (1, 5, 9)]:
        for halo in range(0, 9):
            assert (usable_device_count(shape, halo, n_dev)
                    == jmesh.usable_device_count(shape, halo, n_dev))
    for n in range(1, 40):
        for ks2 in range(0, 9):
            assert (mesh._pass_extent(n, ks2, n_dev)
                    == jmesh._pass_extent(n, ks2, n_dev))


def test_usable_device_count_cases():
    # the JAX package's own cases (tests/test_sharding.py)
    assert usable_device_count((16, 24, 16), 2, 8) == 8
    assert usable_device_count((7, 11, 13), 2, 8) == 8
    assert usable_device_count((3, 16, 16), 3, 8) == 4


def test_make_mesh():
    assert CPU8 == [torch.device("cpu")] * 8
    assert make_mesh(device="cpu") == [torch.device("cpu")]
    devs = ["cpu", "cpu", "cpu"]
    assert make_mesh(2, devices=devs) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(2)


@pytest.mark.parametrize("boundary", list(Boundary))
def test_halo_exchange_ghost_planes(boundary):
    vol = torch.arange(12 * 2 * 3, dtype=torch.float32).reshape(12, 2, 3)
    shards = LocalShards(make_mesh(4, device="cpu"))
    blocks = {t: vol[3 * t:3 * t + 3] for t in range(4)}
    out = halo_exchange(shards, blocks, 2, boundary, 7.5)
    for t in range(4):
        assert out[t].shape == (7, 2, 3)
        torch.testing.assert_close(out[t][2:5], blocks[t], rtol=0, atol=0)
        lo, hi = 3 * t - 2, 3 * t + 5
        if boundary is Boundary.WRAP or 0 < t < 3:
            want = vol[torch.arange(lo, hi) % 12]
        elif boundary is Boundary.REPLICATE:
            want = vol[torch.arange(lo, hi).clamp(0, 11)]
        else:
            idx = torch.arange(lo, hi)
            want = vol[idx.clamp(0, 11)].clone()
            want[(idx < 0) | (idx > 11)] = 7.5
        torch.testing.assert_close(out[t], want, rtol=0, atol=0)


def test_halo_wider_than_a_shard_is_refused():
    shards = LocalShards(make_mesh(2, device="cpu"))
    blocks = {t: torch.zeros(2, 3, 3) for t in range(2)}
    with pytest.raises(ValueError, match="fewer than the halo"):
        halo_exchange(shards, blocks, 3, Boundary.WRAP, None)


@pytest.mark.parametrize("boundary", list(Boundary))
@pytest.mark.parametrize("shape", [(16, 24, 16), (10, 21, 13)])
def test_gaussian_sharded_matches_single_and_jax(boundary, shape):
    # (10, 21, 13): no axis divisible by 8, every pass boundary-extended
    vol = make_blob_volume(*shape, seed=7)
    sigma = (0.5, 0.5, 0.5)
    cfg = FilterConfig(sigma=sigma, boundary=boundary, use_flow=False)
    out = _sharded(vol, cfg)
    np.testing.assert_array_equal(
        out, gaussian_denoise(vol, sigma, boundary, device="cpu").numpy())
    jc = JFilterConfig(sigma=sigma, boundary=JBoundary(boundary.value),
                       use_flow=False)
    ref = np.asarray(jmesh.denoise_sharded(vol, jc, n_devices=8))
    np.testing.assert_allclose(out, ref, atol=2e-3)


def test_gaussian_mixed_divisibility():
    # Z divisible by 8, Y/X not: both kinds of pass in one run
    vol = make_blob_volume(16, 21, 13, seed=11)
    cfg = FilterConfig(sigma=(0.5, 0.5, 0.5), use_flow=False)
    np.testing.assert_array_equal(_sharded(vol, cfg), _single(vol, cfg))


@pytest.mark.parametrize("boundary", [Boundary.WRAP, Boundary.MEAN])
def test_of_sharded_matches_single(boundary):
    vol = make_blob_volume(16, 24, 16, seed=8)
    cfg = _of(boundary)
    np.testing.assert_array_equal(_sharded(vol, cfg), _single(vol, cfg))


@pytest.mark.slow
def test_of_sharded_matches_jax():
    # The bar is the port's against the JAX package end to end (55 dB,
    # tests/test_filter.py's): here JAX's sharded output equals its single
    # device's bit for bit, and the port's sharded output its own single
    # device's, so what is left is the two packages' float32 difference
    # (max 5.55e-3 on data of range ~1000), above the 5e-3 that
    # tests/test_sharding.py holds JAX's sharded path to against JAX.
    vol = make_blob_volume(16, 24, 16, seed=8)
    jc = JFilterConfig(sigma=(0.5, 0.5, 0.5), boundary=JBoundary.WRAP,
                       flow=JFlowConfig(levels=0, winsize=5))
    ref = np.asarray(jmesh.denoise_sharded(vol, jc, n_devices=8))
    assert psnr(_sharded(vol, from_reference(jc)), ref) >= 55.0


@pytest.mark.parametrize("boundary", [Boundary.WRAP, Boundary.MEAN])
def test_divisible_axis_narrower_than_the_halo(boundary):
    # 10 planes over the usable 5 shards divide into 2-plane shards, under
    # the Z halo ks2 4: the pass must take the boundary-extended path
    vol = make_blob_volume(10, 24, 16, seed=11)
    cfg = _of(boundary, sigma=(1.0, 0.5, 0.5))
    assert usable_device_count(vol.shape, 4, 8) == 5
    assert mesh._pass_extent(10, 4, 5) == 20
    np.testing.assert_array_equal(_sharded(vol, cfg), _single(vol, cfg))


@pytest.mark.parametrize("boundary", [Boundary.WRAP, Boundary.MEAN,
                                      Boundary.REPLICATE])
def test_of_uneven_axes(boundary):
    vol = make_blob_volume(11, 19, 17, seed=10)
    cfg = _of(boundary)
    out = denoise_sharded(vol, cfg, mesh=CPU8).numpy()
    np.testing.assert_array_equal(out, _single(vol, cfg))


@pytest.mark.parametrize("boundary", [Boundary.WRAP, Boundary.MEAN])
def test_slabs_forced_inside_the_shards(boundary, monkeypatch):
    vol = make_blob_volume(32, 24, 16, seed=15)
    cfg = _of(boundary, sigma=(1.0, 0.5, 0.5))
    ref = _single(vol, cfg)
    # a budget under which the 4-plane Z shards run in windows of 2 planes
    monkeypatch.setattr(memory, "SLAB_FLOOR", 2)
    budget = memory.window_peak_bytes(cfg, 4, 24, 16, 4, 2)
    monkeypatch.setattr(memory, "device_budget", lambda device: budget)
    assert memory.pass_slab(cfg, 4, 24, 16, 4, budget) == 2
    slabs = []
    run = mesh.slabbed_padded_pass

    def recording(fn, padded, taps, n, slab):
        slabs.append((n, slab))
        return run(fn, padded, taps, n, slab)

    monkeypatch.setattr(mesh, "slabbed_padded_pass", recording)
    np.testing.assert_array_equal(_sharded(vol, cfg), ref)
    assert (4, 2) in slabs


def test_explicit_slab_size_per_shard():
    vol = make_blob_volume(32, 24, 16, seed=16)
    cfg = FilterConfig(sigma=(1.0, 0.5, 0.5), flow=FlowConfig(levels=0, winsize=5),
                       slab_size=2)
    np.testing.assert_array_equal(
        _sharded(vol, cfg), denoise(vol, FilterConfig(
            sigma=cfg.sigma, flow=cfg.flow), device="cpu").numpy())


@pytest.mark.parametrize("flow", [
    {"tap_mode": "compose"},
    {"levels": 1, "min_size": 8, "tap_mode": "compose", "symmetric_adjacent": True},
    {"precision": "bfloat16"},
    {"tap_mode": "compose", "symmetric_adjacent": True, "dtype": "bfloat16",
     "precision": "bfloat16"},
], ids=["compose", "symmetric", "bf16", "fast"])
def test_tap_modes_and_bf16(flow):
    vol = make_blob_volume(16, 24, 16, seed=12)
    cfg = _of(**flow)
    np.testing.assert_array_equal(_sharded(vol, cfg), _single(vol, cfg))


def test_real_pyramid():
    vol = make_blob_volume(16, 48, 40, seed=13)
    cfg = _of(levels=3, min_size=6)
    assert cfg.flow.clamped_levels(48, 40) >= 2
    np.testing.assert_array_equal(_sharded(vol, cfg), _single(vol, cfg))


def test_tensor_input_and_its_mean():
    # a tensor's MEAN fill is its own float32 mean, as in denoise
    vol = torch.from_numpy(make_blob_volume(16, 24, 16, seed=17))
    cfg = FilterConfig(sigma=(0.5, 0.5, 0.5), boundary=Boundary.MEAN,
                       use_flow=False)
    out = denoise_sharded(vol, cfg, mesh=CPU8)
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    torch.testing.assert_close(out, denoise(vol, cfg), rtol=0, atol=0)


def test_on_pass_and_resume():
    vol = make_blob_volume(16, 24, 16, seed=16)
    cfg = _of(Boundary.MEAN)
    seen = []
    full = _sharded(vol, cfg, on_pass=lambda i, v: seen.append((i, v.numpy().copy())))
    assert [i for i, _ in seen] == [0, 1, 2]
    np.testing.assert_array_equal(seen[-1][1], full)
    single = []
    denoise(vol, cfg, device="cpu",
            on_pass=lambda i, v: single.append(v.contiguous().numpy().copy()))
    for (_, v), w in zip(seen, single):
        np.testing.assert_array_equal(v, w)
    # resumed from the pass-1 volume with the input's mean
    from flowdenoising_tpu_torch.core.pipeline import volume_mean
    resumed = _sharded(seen[1][1], cfg, start_pass=2, mean_val=volume_mean(vol))
    np.testing.assert_array_equal(resumed, full)
    np.testing.assert_array_equal(_sharded(full, cfg, start_pass=3), full)


@pytest.mark.parametrize("flags", [["-n"], ["-l", "0", "-w", "5"],
                                   ["-n", "--boundary", "mean", "--stream",
                                    "--slab_size", "5"]],
                         ids=["gaussian", "of", "stream"])
def test_cli_devices_equals_one_device(tmp_path, flags):
    vol = make_blob_volume(12, 24, 16, seed=19)
    src = tmp_path / "in.mrc"
    write_mrc(src, vol)
    base = ["-i", str(src), "-s", "0.5", "0.5", "0.5", "--device", "cpu",
            "--max_displacement", "4", *flags]
    assert cli.main([*base, "-o", str(tmp_path / "one.mrc")]) == 0
    assert cli.main([*base, "--devices", "4", "-o", str(tmp_path / "four.mrc")]) == 0
    one, _ = read_mrc(tmp_path / "one.mrc")
    four, _ = read_mrc(tmp_path / "four.mrc")
    np.testing.assert_array_equal(four, one)


def test_cli_devices_with_a_named_card_is_refused(tmp_path, monkeypatch):
    # --devices takes the first cards; a named one would be ignored
    src = tmp_path / "in.mrc"
    write_mrc(src, np.zeros((4, 8, 8), np.float32))
    monkeypatch.setattr(cli, "_device", torch.device)
    with pytest.raises(SystemExit, match="shards over the first cards"):
        cli.main(["-i", str(src), "-o", str(tmp_path / "o.mrc"), "-n",
                  "--device", "cuda:1", "--devices", "2"])


def test_cli_devices_resumes_a_checkpoint(tmp_path, monkeypatch):
    from flowdenoising_tpu_torch.utils import checkpoint

    vol = make_blob_volume(12, 24, 16, seed=20)
    src = tmp_path / "in.mrc"
    write_mrc(src, vol)
    args = ["-i", str(src), "-s", "0.5", "0.5", "0.5", "--device", "cpu",
            "-l", "0", "-w", "5", "--max_displacement", "4", "--boundary",
            "mean", "--devices", "8"]
    assert cli.main([*args, "-o", str(tmp_path / "ref.mrc")]) == 0
    save = checkpoint.CheckpointManager.save_pass

    class Stop(Exception):
        pass

    def stop_after_pass_0(self, i, v):
        save(self, i, v)
        raise Stop

    ck = ["--checkpoint_dir", str(tmp_path / "ck"), "-o", str(tmp_path / "out.mrc")]
    monkeypatch.setattr(checkpoint.CheckpointManager, "save_pass", stop_after_pass_0)
    with pytest.raises(Stop):
        cli.main([*args, *ck])
    monkeypatch.setattr(checkpoint.CheckpointManager, "save_pass", save)
    assert cli.main([*args, *ck]) == 0
    np.testing.assert_array_equal(read_mrc(tmp_path / "out.mrc")[0],
                                  read_mrc(tmp_path / "ref.mrc")[0])


def _stream_vol(shape=(24, 32, 40), seed=11):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 40 + 100).astype(np.float32)


@pytest.mark.parametrize("use_flow", [False, True])
@pytest.mark.parametrize("boundary", list(Boundary))
def test_sharded_stream_matches_single_stream(tmp_path, use_flow, boundary):
    vol = _stream_vol()
    cfg = FilterConfig(sigma=(1.0, 1.0, 1.0), boundary=boundary,
                       use_flow=use_flow,
                       flow=FlowConfig(levels=1, winsize=5, max_displacement=4))
    single = denoise_streamed(vol, cfg, slab_size=6, tmp_dir=str(tmp_path),
                              device="cpu")
    out = denoise_streamed(vol, cfg, slab_size=6, tmp_dir=str(tmp_path),
                           mesh=make_mesh(4, device="cpu"))
    np.testing.assert_array_equal(out, single)
    np.testing.assert_array_equal(out, _single(vol, cfg))


def test_sharded_stream_from_memmap(tmp_path):
    vol = _stream_vol((20, 24, 32), seed=13).astype(np.int16)
    mm = np.memmap(tmp_path / "in.i16", dtype=np.int16, mode="w+", shape=vol.shape)
    mm[...] = vol
    mm.flush()
    src = np.memmap(tmp_path / "in.i16", dtype=np.int16, mode="r", shape=vol.shape)
    cfg = FilterConfig(sigma=(1.0, 1.0, 1.0), boundary=Boundary.REPLICATE,
                       use_flow=False)
    single = denoise_streamed(src, cfg, slab_size=6, tmp_dir=str(tmp_path),
                              device="cpu")
    out = denoise_streamed(src, cfg, slab_size=6, tmp_dir=str(tmp_path),
                           n_devices=2, device="cpu")
    np.testing.assert_array_equal(out, single)


def test_window_pass_drops_shards_narrower_than_the_halo():
    # 2 output planes + 2 * ks2 4 context planes over 8 shards would give
    # 2-plane shards: the pass keeps the prefix of the mesh that covers
    # the halo (2 shards of 5 planes)
    vol = torch.from_numpy(_stream_vol((10, 12, 14)))
    taps = np.ones(9) / 9
    cfg = FilterConfig(use_flow=False)
    out = sharded_window_pass(vol, taps, cfg, CPU8)
    from flowdenoising_tpu_torch.core.axis_filter import gaussian_pass_padded
    torch.testing.assert_close(out, gaussian_pass_padded(vol, taps), rtol=0, atol=0)

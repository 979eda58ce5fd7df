"""The port's shard-wise ingest (``parallel/ingest.py``): the ranks' Z
ranges cover the volume in order, each rank reads its own planes of an MRC
file (the JAX package's ``load_sharded`` reads the same volume), an uneven
Z falls back to the whole volume, and the shards feed the sharded denoise
to the single-device result bit for bit."""

import numpy as np
import pytest
import torch

from conftest import make_blob_volume
from flowdenoising_tpu.parallel.ingest import load_sharded as j_load_sharded
from flowdenoising_tpu.parallel.mesh import make_mesh as j_make_mesh

from flowdenoising_tpu_torch.config import FilterConfig
from flowdenoising_tpu_torch.core.pipeline import gaussian_denoise
from flowdenoising_tpu_torch.io.mrc import write_mrc
from flowdenoising_tpu_torch.parallel.ingest import load_sharded, local_z_range
from flowdenoising_tpu_torch.parallel.mesh import denoise_sharded, make_mesh

torch.set_num_threads(1)


@pytest.mark.parametrize("world", range(1, 9))
def test_local_z_ranges_cover_the_volume(world):
    for n_z in range(1, 40):
        ranges = [local_z_range(n_z, world, r) for r in range(world)]
        assert ranges[0][0] == 0 and ranges[-1][1] == n_z
        for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
            assert lo <= hi == lo2
        per = -(-n_z // world)
        assert all(hi - lo <= per for lo, hi in ranges)


@pytest.mark.parametrize("world", [1, 2, 8])
def test_load_sharded_round_trip(tmp_path, world):
    vol = make_blob_volume(16, 24, 16, seed=1)
    path = tmp_path / "v.mrc"
    write_mrc(path, vol.astype(np.int16))
    parts = []
    for rank in range(world):
        local, (lo, hi) = load_sharded(path, world, rank)
        assert (lo, hi) == local_z_range(16, world, rank)
        assert local.dtype == np.float32 and local.shape == (hi - lo, 24, 16)
        parts.append(local)
    got = np.concatenate(parts)
    np.testing.assert_array_equal(got, vol.astype(np.int16).astype(np.float32))
    # the JAX package's read of the same file
    np.testing.assert_array_equal(got, np.asarray(j_load_sharded(path, j_make_mesh(8))))


def test_load_sharded_uneven_falls_back_to_the_whole_volume(tmp_path):
    vol = make_blob_volume(10, 24, 16, seed=3)
    path = tmp_path / "v.mrc"
    write_mrc(path, vol)
    for rank in range(8):
        local, (lo, hi) = load_sharded(path, 8, rank)
        assert (lo, hi) == (0, 10)
        np.testing.assert_array_equal(local, vol)
    np.testing.assert_array_equal(np.asarray(j_load_sharded(path, j_make_mesh(8))), vol)


def test_load_sharded_feeds_the_sharded_denoise(tmp_path):
    vol = make_blob_volume(16, 24, 16, seed=2)
    path = tmp_path / "v.mrc"
    write_mrc(path, vol)
    local = np.concatenate([load_sharded(path, 8, r)[0] for r in range(8)])
    cfg = FilterConfig(sigma=(0.5,) * 3, use_flow=False)
    out = denoise_sharded(local, cfg, mesh=make_mesh(8, device="cpu"))
    ref = gaussian_denoise(vol, cfg.sigma, cfg.boundary, device="cpu")
    torch.testing.assert_close(out, ref, rtol=0, atol=0)

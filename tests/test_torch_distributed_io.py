"""The port's shard-wise output and reductions (``parallel/distributed.py``)
over the shards of one process: ``write_mrc_sharded`` writes the file
``write_mrc`` writes (the data bit for bit, the header statistics to 1e-5
relative), the global statistics, ``sharded_mean`` equal to
``volume_mean`` bit for bit whatever the shards' Z ranges, and the refusal
of a volume too small for the process count.  Across processes:
``tests/test_torch_multiprocess.py``."""

import numpy as np
import pytest
import torch

from flowdenoising_tpu.parallel.distributed import sharded_stats as j_sharded_stats

from flowdenoising_tpu_torch.core.pipeline import volume_mean
from flowdenoising_tpu_torch.io.mrc import read_mrc, write_mrc
from flowdenoising_tpu_torch.parallel.distributed import (
    check_world_size, sharded_mean, sharded_stats, write_mrc_sharded)
from flowdenoising_tpu_torch.parallel.ingest import local_z_range
from flowdenoising_tpu_torch.parallel.mesh import LocalShards, make_mesh

torch.set_num_threads(1)


def _vol(z=16, y=8, x=24, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(z, y, x)) * 40 + 7).astype(np.float32)


def _split(vol, n):
    shards = LocalShards(make_mesh(n, device="cpu"))
    bounds = [local_z_range(vol.shape[0], n, t) for t in range(n)]
    blocks = {t: torch.from_numpy(vol[lo:hi]) for t, (lo, hi) in enumerate(bounds)}
    return shards, blocks, bounds


def _close(a, b):
    assert abs(a - b) <= 1e-5 * max(abs(b), 1e-30), (a, b)


@pytest.mark.parametrize("z,n", [(16, 8), (16, 1), (14, 8), (14, 3), (5, 8)])
def test_write_mrc_sharded_matches_write_mrc(tmp_path, z, n):
    # (5, 8): three shards hold no plane
    vol = _vol(z)
    shards, blocks, bounds = _split(vol, n)
    write_mrc(tmp_path / "ref.mrc", vol, voxel_size=(1.5, 2.0, 2.5))
    write_mrc_sharded(tmp_path / "out.mrc", shards, blocks, bounds, vol.shape,
                      voxel_size=(1.5, 2.0, 2.5))
    ref, ref_hdr = read_mrc(tmp_path / "ref.mrc")
    got, hdr = read_mrc(tmp_path / "out.mrc")
    np.testing.assert_array_equal(got, ref)
    for field in ("dmin", "dmax", "dmean", "rms"):
        _close(getattr(hdr, field), getattr(ref_hdr, field))
    assert hdr.voxel_size == ref_hdr.voxel_size
    assert (tmp_path / "out.mrc").stat().st_size == (tmp_path / "ref.mrc").stat().st_size


def test_sharded_stats_global():
    vol = _vol(seed=5)
    shards, blocks, _ = _split(vol, 8)
    mn, mx, mean, std = sharded_stats(shards, blocks)
    assert mn == vol.min() and mx == vol.max()
    _close(mean, float(vol.astype(np.float64).mean()))
    _close(std, float(vol.astype(np.float64).std()))
    # the JAX package's float32 reductions of the same volume
    import jax.numpy as jnp
    for got, want in zip((mn, mx, mean, std), j_sharded_stats(jnp.asarray(vol))):
        _close(got, want)


@pytest.mark.parametrize("z", [16, 14, 21, 3])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_sharded_mean_equals_volume_mean(tmp_path, z, n):
    # ranges that split 8-plane chunks (e.g. 14 over 2: 0-7, 7-14)
    vol = (_vol(z, seed=z) * 1000).astype(np.int16)
    mm = np.memmap(tmp_path / "v.i16", dtype=np.int16, mode="w+", shape=vol.shape)
    mm[...] = vol
    mm.flush()
    src = np.memmap(tmp_path / "v.i16", dtype=np.int16, mode="r", shape=vol.shape)
    bounds = [local_z_range(z, n, t) for t in range(n)]
    got = sharded_mean(src, LocalShards(make_mesh(n, device="cpu")), bounds)
    assert got.dtype == np.float32
    assert got.tobytes() == volume_mean(vol).tobytes()


def test_volume_too_small_for_the_process_count_is_refused():
    # 1 plane at halo 4: shards of ceil(9 / 3) = 3 planes < 4 from 3 ranks
    check_world_size((1, 16, 16), 4, 2)
    with pytest.raises(ValueError, match="too small for 3 processes"):
        check_world_size((1, 16, 16), 4, 3)

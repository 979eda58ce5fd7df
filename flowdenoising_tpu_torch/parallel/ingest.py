"""Shard-wise volume ingest for multi-process runs.

Counterpart of ``flowdenoising_tpu/parallel/ingest.py``.  The input lives
on storage every process reads, and no process needs the whole volume:
each memory-maps the file and reads only its own Z planes, so planes it
does not own are never paged in.
"""

from __future__ import annotations

import numpy as np

from flowdenoising_tpu_torch.io.volume import read_volume


def local_z_range(n_z: int, world_size: int, rank: int) -> tuple[int, int]:
    """[start, stop) of the Z planes rank ``rank`` of ``world_size`` owns:
    ceil(n_z / world_size) planes each, in rank order (the last ranks'
    ranges shorter or empty)."""
    per = -(-n_z // world_size)
    return min(n_z, rank * per), min(n_z, (rank + 1) * per)


def load_sharded(path, world_size: int, rank: int,
                 memory_map: bool = True) -> tuple[np.ndarray, tuple[int, int]]:
    """This rank's Z planes of the volume at ``path`` as float32, and their
    [start, stop) range, read through a memory map.  Where ``world_size``
    does not divide Z, the whole volume and (0, Z), as the JAX package
    reads it then."""
    vol = read_volume(path, memory_map=memory_map)
    n_z = vol.shape[0]
    if n_z % world_size:
        return np.array(vol, dtype=np.float32), (0, n_z)
    lo, hi = local_z_range(n_z, world_size, rank)
    return np.array(vol[lo:hi], dtype=np.float32), (lo, hi)

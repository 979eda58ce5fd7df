"""Sharded denoising over several devices (``mesh``) or processes
(``distributed``, with the shard-wise file I/O of ``ingest``).  The names
are the JAX package's, with the port's own signatures: a mesh is a list of
``torch.device``s, not a ``jax`` mesh."""

from flowdenoising_tpu_torch.parallel.mesh import (
    denoise_sharded, halo_exchange, make_mesh)

__all__ = ["denoise_sharded", "make_mesh", "halo_exchange"]

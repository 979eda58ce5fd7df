"""Sharded denoising over several devices (``mesh``) or processes
(``distributed``, with the shard-wise file I/O of ``ingest``)."""

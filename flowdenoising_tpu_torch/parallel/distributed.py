"""Multi-process denoising: file -> shards -> file over torch.distributed.

Counterpart of ``flowdenoising_tpu/parallel/distributed.py``.  One process
per GPU (PyTorch's idiom; the JAX package runs one process per host with
all of its devices, and the outputs are the same), each rank one shard of
the sharded pipeline (``parallel/mesh.py``):

- ingest: ``parallel.ingest.load_sharded`` reads only this rank's Z planes
  of the input MRC through a memory map;
- compute: the ring halo and the reshard between passes over the process
  group (``GroupShards``: ``batch_isend_irecv`` and ``all_to_all_single``),
  NCCL when the ranks compute on CUDA, gloo on the CPU;
- the MEAN boundary: ``sharded_mean``, equal to ``volume_mean`` of the
  whole file bit for bit;
- output: ``write_mrc_sharded``: rank 0 sizes the shared file and writes
  the header (statistics reduced over every rank), then every rank writes
  its Z planes.

CLI: ``python -m flowdenoising_tpu_torch --coordinator HOST:PORT
--num_hosts N --host_id I ...``, one process per rank.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.distributed as dist

from flowdenoising_tpu_torch.config import Boundary, FilterConfig
from flowdenoising_tpu_torch.core.pipeline import _MEAN_CHUNK
from flowdenoising_tpu_torch.io.mrc import (
    _HEADER_BYTES, build_mrc_header, read_mrc_header)
from flowdenoising_tpu_torch.io.volume import read_volume
from flowdenoising_tpu_torch.kernels import get_gaussian_kernels
from flowdenoising_tpu_torch.parallel.ingest import load_sharded, local_z_range
from flowdenoising_tpu_torch.parallel.mesh import (
    _denoise_shards, _reshard, _Sharded, usable_device_count)

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def init_distributed(coordinator: str, num_hosts: int, host_id: int,
                     device="cuda") -> torch.device:
    """Join the process group of ``num_hosts`` ranks at ``coordinator``
    (host:port, reached over TCP) as rank ``host_id``; returns the device
    this rank computes on.  CUDA: NCCL, on ``cuda:K`` where named, else
    ``cuda:(host_id mod device_count)``; raises without CUDA.  CPU: gloo."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev}: no CUDA device is available "
                               "(pass --device cpu to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", host_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device {dev}: expected cuda or cpu")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_hosts,
                            rank=host_id)
    return dev


class GroupShards:
    """One shard per rank of the default process group, this rank's on
    ``device``.  ``torch.distributed`` refuses a send to the sender's own
    rank, so what a rank would send itself is kept, not sent."""

    def __init__(self, device):
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.held = (self.rank,)
        self._device = torch.device(device)

    def device(self, t: int) -> torch.device:
        return self._device

    def shares(self, t: int) -> int:
        return 1

    def ring(self, tails: dict, heads: dict) -> tuple[dict, dict]:
        """This rank's left ghosts (the previous rank's tail) and right
        ghosts (the next rank's head), the ring closed."""
        r, n = self.rank, self.size
        tail, head = tails[r].contiguous(), heads[r].contiguous()
        if n == 1:
            return {r: tail}, {r: head}
        left, right = torch.empty_like(tail), torch.empty_like(head)
        # tags tell the two messages apart where both neighbours are one
        # rank (world size 2); NCCL matches them in this order
        ops = [dist.P2POp(dist.isend, tail, (r + 1) % n, tag=0),
               dist.P2POp(dist.isend, head, (r - 1) % n, tag=1),
               dist.P2POp(dist.irecv, left, (r - 1) % n, tag=0),
               dist.P2POp(dist.irecv, right, (r + 1) % n, tag=1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return {r: left}, {r: right}

    def exchange(self, pieces: dict, shapes: dict) -> dict:
        """``pieces[(r, t)]``, this rank's piece for every rank t, sent in
        one ``all_to_all_single``; returns ``{(s, r): piece}`` from every
        rank s, shaped by ``shapes``."""
        r = self.rank
        if self.size == 1:
            return {(r, r): pieces[(r, r)]}
        send = [pieces[(r, t)].reshape(-1) for t in range(self.size)]
        recv = [int(np.prod(shapes[(s, r)])) for s in range(self.size)]
        out = send[0].new_empty(sum(recv))
        dist.all_to_all_single(out, torch.cat(send), recv,
                               [p.numel() for p in send])
        return {(s, r): part.view(shapes[(s, r)])
                for s, part in enumerate(out.split(recv))}

    def reduce(self, parts: dict, op: str) -> np.ndarray:
        """The elementwise ``op`` ("sum", "min", "max") of every rank's
        float64 vector."""
        t = torch.as_tensor(np.asarray(parts[self.rank], np.float64),
                            device=self._device)
        dist.all_reduce(t, op=_OPS[op])
        return t.cpu().numpy()

    def barrier(self) -> None:
        if self._device.type == "cuda":
            dist.barrier(device_ids=[self._device.index])
        else:
            dist.barrier()


def sharded_mean(src, shards, bounds) -> np.float32:
    """``volume_mean`` of the (Z, Y, X) array or memmap ``src``, bit for
    bit, with each held shard reading only the ``_MEAN_CHUNK``-plane chunks
    that start in its Z range ``bounds[t]``: each chunk's float64 sum comes
    from one shard, and the sums are added in chunk order."""
    n_z = src.shape[0]
    parts = {}
    for t in shards.held:
        sums = np.zeros(-(-n_z // _MEAN_CHUNK))
        lo, hi = bounds[t]
        for c in range(-(-lo // _MEAN_CHUNK), -(-hi // _MEAN_CHUNK)):
            a = c * _MEAN_CHUNK
            sums[c] = float(np.sum(src[a:a + _MEAN_CHUNK], dtype=np.float64))
        parts[t] = sums
    total = 0.0
    for s in shards.reduce(parts, "sum"):
        total += float(s)
    return np.float32(total / max(int(np.prod(src.shape)), 1))


def sharded_stats(shards, blocks: dict) -> tuple[float, float, float, float]:
    """The global (min, max, mean, std) of the held shards' blocks, for
    the MRC header: reduced over every shard in float64."""
    wide = {t: b.to(torch.float64) for t, b in blocks.items()}
    empty = {t: b.numel() == 0 for t, b in wide.items()}
    lo = shards.reduce({t: [np.inf if empty[t] else b.min().item()]
                        for t, b in wide.items()}, "min")[0]
    hi = shards.reduce({t: [-np.inf if empty[t] else b.max().item()]
                        for t, b in wide.items()}, "max")[0]
    total, count = shards.reduce({t: [b.sum().item(), b.numel()]
                                  for t, b in wide.items()}, "sum")
    mean = total / max(count, 1)
    sq = shards.reduce({t: [((b - mean) ** 2).sum().item()]
                        for t, b in wide.items()}, "sum")[0]
    return float(lo), float(hi), float(mean), float(np.sqrt(sq / max(count, 1)))


def write_mrc_sharded(path, shards, blocks: dict, bounds, shape,
                      voxel_size=None) -> None:
    """Write a volume held as Z planes (``blocks[t]`` holds planes
    ``bounds[t]`` of the (Z, Y, X) ``shape``) as one float32 MRC file on
    storage every shard can write: the first shard's process sizes the
    file and writes the header with the global statistics, then every
    shard writes its planes through a memmap; a barrier follows each
    step."""
    nz, ny, nx = shape
    stats = sharded_stats(shards, blocks)
    if 0 in shards.held:
        with open(path, "wb") as f:
            f.write(build_mrc_header(nx, ny, nz, 2, *stats, voxel_size))
            f.truncate(_HEADER_BYTES + nz * ny * nx * 4)
    shards.barrier()
    mm = np.memmap(path, dtype="<f4", mode="r+", offset=_HEADER_BYTES,
                   shape=tuple(shape))
    for t, blk in blocks.items():
        lo, hi = bounds[t]
        mm[lo:hi] = blk.detach().to("cpu", torch.float32).numpy()
    mm.flush()
    del mm
    shards.barrier()


def check_world_size(shape, max_halo: int, world_size: int) -> None:
    """Refuse a volume whose shards would be narrower than the halo: every
    rank must take part in the collectives, so the mesh cannot shrink."""
    usable = usable_device_count(tuple(shape), max_halo, world_size)
    if usable != world_size:
        raise ValueError(f"volume {tuple(shape)} too small for {world_size} "
                         f"processes at halo {max_halo} (usable: {usable})")


def run_distributed(input_path, output_path, cfg: FilterConfig, kernels=None,
                    on_pass=None, device="cuda") -> None:
    """File-to-file denoise over the process group (``init_distributed``
    first), this rank computing on ``device``: each rank reads its Z
    planes, the sharded passes run over the group and each rank writes its
    Z planes of the one output file.  ``on_pass(i, blocks)`` after pass i
    with this rank's output planes."""
    kernels = get_gaussian_kernels(cfg.sigma) if kernels is None else kernels
    shards = GroupShards(device)
    r = shards.rank
    hdr = read_mrc_header(input_path)
    shape = hdr.shape
    check_world_size(shape, max(len(k) // 2 for k in kernels), shards.size)
    logging.info(f"distributed: rank {r} of {shards.size} on {device}, "
                 f"volume {shape}")
    bounds = [local_z_range(shape[0], shards.size, t) for t in range(shards.size)]
    local, (lo0, _) = load_sharded(input_path, shards.size, r)
    lo, hi = bounds[r]
    block = torch.from_numpy(local[lo - lo0:hi - lo0]).to(device)
    del local
    mean_val = None
    if cfg.boundary is Boundary.MEAN:
        mean_val = sharded_mean(read_volume(input_path, memory_map=True),
                                shards, bounds)
    report = None
    if on_pass is not None:
        def report(i, st):
            on_pass(i, st.blocks)
    state = _denoise_shards(shards, _Sharded(0, bounds, {r: block}), kernels,
                            cfg, mean_val, 0, report)
    del block
    # back to Z planes, so each rank's part of the file is contiguous
    rows = _reshard(shards, state, 0, [np.arange(*b) for b in bounds], None)
    del state
    write_mrc_sharded(output_path, shards, rows, bounds, shape, hdr.voxel_size)

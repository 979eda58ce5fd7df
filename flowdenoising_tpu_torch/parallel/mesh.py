"""Slice-sharded denoising over several devices or processes.

Counterpart of ``flowdenoising_tpu/parallel/mesh.py``.  A *mesh* is an
ordered list of ``torch.device``s, one per shard; a device named more than
once runs its shards in turn (how one card, or the CPU, runs a
multi-shard mesh).  The volume is split along the filtered axis of each
pass:

- each shard's planes (and only ``ks2`` ghost planes a side from its ring
  neighbours, ``halo_exchange``) go through the single-device pass
  (``core/pipeline.py: slabbed_padded_pass``), in windows that
  ``core/memory.py`` sizes for the shard;
- between passes the filtered axis changes (Z -> Y -> X), and every shard
  sends each other shard the planes of its new range (``_reshard``, an
  all-to-all).

An axis that the shard count does not divide, or whose shards would be
narrower than the halo, is filtered as a boundary-extended stack: ks2
planes a side filled per the boundary mode, the last plane repeated up to
a multiple of the shard count, the ring closed (WRAP) and the ks2 outputs a
side that read across its seam cropped (``_pass_extent``).

The halo and the reshard are written once, against ``LocalShards`` (the
shards of one process, moved between devices with ``Tensor.to``) and
``parallel.distributed.GroupShards`` (one shard per rank of a
``torch.distributed`` process group).  A plane's result depends only on
its own window, so every sharded output equals the single-device one bit
for bit; the MEAN boundary pads with the one float32 ``volume_mean`` of
the input, as every path does.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from flowdenoising_tpu_torch.config import Boundary, FilterConfig
from flowdenoising_tpu_torch.core import memory
from flowdenoising_tpu_torch.core.axis_filter import (
    gaussian_pass_padded, of_pass_padded)
from flowdenoising_tpu_torch.core.pipeline import (
    _PASS_LAYOUTS, _as_volume, _mean, slabbed_padded_pass)
from flowdenoising_tpu_torch.kernels import get_gaussian_kernels
from flowdenoising_tpu_torch.ops.device import require_device
from flowdenoising_tpu_torch.parallel.ingest import local_z_range


def make_mesh(n_devices: int | None = None, devices=None,
              device="cuda") -> list[torch.device]:
    """The mesh of the first ``n_devices`` of ``devices``; by default the
    CUDA cards (as the JAX package takes ``jax.devices()[:n]``, so asking
    for more cards than the host has gives all of them), or with
    ``device="cpu"`` ``n_devices`` shards of the CPU.  Raises for CUDA when
    there is none."""
    if devices is None:
        device = require_device(device)
        if device.type == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [device] * (n_devices or 1)
    devices = [torch.device(d) for d in devices]
    return devices if n_devices is None else devices[:n_devices]


def usable_device_count(shape: tuple[int, int, int], max_halo: int,
                        n_devices: int) -> int:
    """Largest device count <= n_devices whose per-device shard stays at
    least one halo wide on every axis (the padded extent of
    ``_pass_extent`` included)."""
    d = n_devices
    while d > 1:
        if all(-(-(s + 2 * max_halo) // d) >= max_halo for s in shape):
            return d
        d -= 1
    return 1


def _pass_extent(n: int, ks2: int, n_dev: int) -> int:
    """Sharded extent for a pass over ``n`` output planes: ``n`` where the
    axis divides into shards at least ks2 wide (the ring halo comes from
    the immediate neighbours only), else the boundary-extended stack of
    n + 2*ks2 planes aligned up to a multiple of the shard count."""
    if n % n_dev == 0 and n // n_dev >= ks2:
        return n
    return n_dev * (-(-(n + 2 * ks2) // n_dev))


def _sources(n: int, ks2: int, ext: int, boundary: Boundary) -> np.ndarray:
    """The plane of the axis (0..n-1) each of a pass's ``ext`` planes
    holds, -1 for the MEAN fill: the axis itself, or the boundary-extended
    stack (``pad_stack``'s padding, then the last padded plane repeated)."""
    if ext == n:
        return np.arange(n)
    i = np.minimum(np.arange(ext) - ks2, n + ks2 - 1)
    if boundary is Boundary.WRAP:
        return i % n
    if boundary is Boundary.REPLICATE:
        return np.clip(i, 0, n - 1)
    return np.where((i >= 0) & (i < n), i, -1)


class LocalShards:
    """Every shard in this process, shard t on ``devices[t]``."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.held = tuple(range(self.size))

    def device(self, t: int) -> torch.device:
        return self.devices[t]

    def shares(self, t: int) -> int:
        """Shards that run in turn on shard t's device."""
        return self.devices.count(self.devices[t])

    def ring(self, tails: dict, heads: dict) -> tuple[dict, dict]:
        """Each shard's left ghosts (the previous shard's tail) and right
        ghosts (the next shard's head), the ring closed."""
        n = self.size
        return ({t: tails[(t - 1) % n].to(self.devices[t]) for t in self.held},
                {t: heads[(t + 1) % n].to(self.devices[t]) for t in self.held})

    def exchange(self, pieces: dict, shapes: dict) -> dict:
        """``pieces[(s, t)]`` sent from shard s to shard t, as received on
        t's device (``shapes`` serves the process group)."""
        return {(s, t): p.to(self.devices[t]) for (s, t), p in pieces.items()}

    def reduce(self, parts: dict, op: str) -> np.ndarray:
        """The elementwise ``op`` ("sum", "min", "max") of every shard's
        float64 vector."""
        fn = {"sum": np.add, "min": np.minimum, "max": np.maximum}[op]
        return functools.reduce(fn, (np.asarray(parts[t], np.float64)
                                     for t in self.held))

    def barrier(self) -> None:
        pass


@dataclasses.dataclass
class _Sharded:
    """A volume split along ``axis``: shard t holds planes
    ``bounds[t]`` = [lo, hi) of it, in canonical (Z, Y, X) order, as
    ``blocks[t]`` for the shards held here."""
    axis: int
    bounds: list
    blocks: dict


def _reshard(shards, state: _Sharded, a: int, targets: list,
             mean_val) -> dict:
    """Each held shard t's planes ``targets[t]`` (plane indices along axis
    ``a``, -1 for the MEAN fill; one array for every shard of the mesh) in
    pass layout ``_PASS_LAYOUTS[a]``, from ``state``: every shard sends
    every other the planes it owns, in one exchange."""
    layout = _PASS_LAYOUTS[a]
    b = state.axis
    full = _full_shape(state)
    pieces, shapes, places = {}, {}, {}
    for t, want in enumerate(targets):
        for s, (lo, hi) in enumerate(state.bounds):
            if s not in state.blocks and t not in shards.held:
                continue
            if b == a:
                pos = np.flatnonzero((want >= lo) & (want < hi))
                idx = want[pos] - lo
            else:
                pos = np.flatnonzero(want >= 0)
                idx = want[pos]
            if s in state.blocks:
                blk = state.blocks[s]
                pieces[(s, t)] = blk.index_select(
                    a, torch.as_tensor(idx, device=blk.device)
                ).permute(layout).contiguous()
            if t in shards.held:
                places[(s, t)] = pos
                dims = list(full)
                dims[b] = hi - lo
                dims[a] = len(pos)
                shapes[(s, t)] = tuple(dims[ax] for ax in layout)
    got = shards.exchange(pieces, shapes)
    out = {}
    for t in shards.held:
        want = targets[t]
        dev = shards.device(t)
        dims = list(full)
        dims[a] = len(want)
        win = torch.empty(tuple(dims[ax] for ax in layout), dtype=torch.float32,
                          device=dev)
        fill = np.flatnonzero(want < 0)
        if len(fill):
            win.index_fill_(0, torch.as_tensor(fill, device=dev),
                            torch.as_tensor(mean_val, dtype=torch.float32,
                                            device=dev))
        for s, (lo, hi) in enumerate(state.bounds):
            dst = win if b == a else win.narrow(layout.index(b), lo, hi - lo)
            dst.index_copy_(0, torch.as_tensor(places[(s, t)], device=dev),
                            got[(s, t)])
        out[t] = win
    return out


def _full_shape(state: _Sharded) -> tuple[int, int, int]:
    """The whole volume's (Z, Y, X) shape."""
    dims = list(state.blocks[next(iter(state.blocks))].shape)
    dims[state.axis] = state.bounds[-1][1]
    return tuple(dims)


def halo_exchange(shards, blocks: dict, halo: int, boundary: Boundary,
                  mean_val) -> dict:
    """Each held shard's (n, H, W) block with ``halo`` ghost planes a
    side: (n + 2*halo, H, W).  The left ghosts are the previous shard's
    last planes, the right ghosts the next shard's first; the ring wraps
    (WRAP), and for the other boundaries the first shard's left and the
    last shard's right ghosts are the edge plane (REPLICATE) or the mean
    (MEAN)."""
    if halo == 0:
        return dict(blocks)
    for t, blk in blocks.items():
        if blk.shape[0] < halo:
            raise ValueError(f"shard {t} holds {blk.shape[0]} planes, fewer "
                             f"than the halo {halo}: use fewer devices")
    lefts, rights = shards.ring({t: b[-halo:] for t, b in blocks.items()},
                                {t: b[:halo] for t, b in blocks.items()})
    out = {}
    for t, blk in blocks.items():
        left, right = lefts[t], rights[t]
        if boundary is not Boundary.WRAP:
            if boundary is Boundary.REPLICATE:
                lfill, rfill = blk[:1], blk[-1:]
            else:  # MEAN
                lfill = rfill = torch.as_tensor(mean_val, dtype=blk.dtype,
                                                device=blk.device)
            if t == 0:
                left = lfill.expand(left.shape)
            if t == shards.size - 1:
                right = rfill.expand(right.shape)
        out[t] = torch.cat([left, blk, right], dim=0)
    return out


def _padded_pass_fn(cfg: FilterConfig):
    if not cfg.use_flow:
        return gaussian_pass_padded

    def padded_pass(window, taps):
        return of_pass_padded(window, taps, cfg.flow)
    return padded_pass


def _sharded_pass(shards, blocks: dict, taps, boundary: Boundary, mean_val,
                  cfg: FilterConfig) -> dict:
    """One pass over the held shards' (n, H, W) blocks in pass layout: the
    ring halo, then each shard's window through the single-device pass in
    slabs ``memory.pass_slab`` sizes from the shard's extent and its
    device's budget shared by the shards on that device; the shards of a
    device run in turn.  Returns each shard's n output planes."""
    ks2 = len(taps) // 2
    windows = halo_exchange(shards, blocks, ks2, boundary, mean_val)
    padded_pass = _padded_pass_fn(cfg)
    outs = {}
    for t in sorted(windows):
        win = windows.pop(t)
        n, h, w = win.shape[0] - 2 * ks2, win.shape[1], win.shape[2]
        budget = memory.device_budget(win.device)
        if budget is not None:
            budget //= shards.shares(t)
        slab = memory.pass_slab(cfg, n, h, w, ks2, budget)
        outs[t] = slabbed_padded_pass(padded_pass, win, taps, n, slab)
        del win
    return outs


def sharded_window_pass(window: torch.Tensor, taps, cfg: FilterConfig,
                        mesh) -> torch.Tensor:
    """One axis pass over a (out_n + 2*ks2, H, W) window whose context
    planes are already filled (``core/stream.py`` gathers them), sharded
    over ``mesh``: the window's last plane repeated up to a multiple of the
    shard count, split, the ring closed and the ks2 outputs a side
    cropped.  Returns the (out_n, H, W) outputs on the window's device,
    equal to the single-device pass bit for bit.  Shards whose part would
    be narrower than the halo are dropped (a prefix of the mesh)."""
    ks2 = len(taps) // 2
    out_n = window.shape[0] - 2 * ks2
    n_dev = len(mesh)
    while n_dev > 1 and (-(-(out_n + 2 * ks2) // n_dev)) < max(ks2, 1):
        n_dev -= 1
    shards = LocalShards(mesh[:n_dev])
    part = -(-(out_n + 2 * ks2) // n_dev)
    extra = n_dev * part - window.shape[0]
    if extra:
        tail = window[-1:].expand((extra,) + tuple(window.shape[1:]))
        window = torch.cat([window, tail], dim=0)
    blocks = {t: window[t * part:(t + 1) * part].to(shards.device(t))
              for t in shards.held}
    del window
    outs = _sharded_pass(shards, blocks, taps, Boundary.WRAP, None, cfg)
    del blocks
    dev = torch.device(mesh[0])
    return torch.cat([outs[t].to(dev) for t in shards.held])[ks2:ks2 + out_n]


def _denoise_shards(shards, state: _Sharded, kernels, cfg: FilterConfig,
                    mean_val, start_pass: int, on_pass) -> _Sharded:
    """Passes ``start_pass``.. over a sharded volume (the canonical result
    of pass ``start_pass - 1``); returns the last pass's output, split
    along its axis.  ``on_pass(i, state)`` after pass i."""
    shape = _full_shape(state)
    for i, taps in enumerate(kernels):
        if i < start_pass:
            continue
        ks2 = len(taps) // 2
        n = shape[i]
        ext = _pass_extent(n, ks2, shards.size)
        part = ext // shards.size
        src = _sources(n, ks2, ext, cfg.boundary)
        blocks = _reshard(shards, state, i, [
            src[t * part:(t + 1) * part] for t in range(shards.size)], mean_val)
        del state
        # the extended stack's seam only feeds cropped outputs: a plain ring
        boundary = cfg.boundary if ext == n else Boundary.WRAP
        outs = _sharded_pass(shards, blocks, taps, boundary, mean_val, cfg)
        del blocks
        off = 0 if ext == n else ks2
        bounds = [(min(max(t * part - off, 0), n),
                   min(max((t + 1) * part - off, 0), n))
                  for t in range(shards.size)]
        inverse = tuple(_PASS_LAYOUTS[i].index(ax) for ax in (0, 1, 2))
        state = _Sharded(i, bounds, {
            t: outs[t][bounds[t][0] + off - t * part:
                       bounds[t][1] + off - t * part].permute(inverse)
            for t in shards.held})
        del outs
        if on_pass is not None:
            on_pass(i, state)
    return state


def _gather(state: _Sharded, device) -> torch.Tensor:
    """A local sharded volume as one contiguous (Z, Y, X) tensor."""
    return torch.cat([state.blocks[t].to(device) for t in sorted(state.blocks)],
                     dim=state.axis).contiguous()


def denoise_sharded(vol, cfg: FilterConfig = FilterConfig(), kernels=None,
                    n_devices: int | None = None, mesh=None,
                    start_pass: int = 0, mean_val=None, on_pass=None,
                    device="cuda") -> torch.Tensor:
    """Slice-sharded Z -> Y -> X denoise over a mesh (``make_mesh``).

    Without ``mesh``, the first ``usable_device_count`` of ``n_devices``
    CUDA cards (default: all of them), or with ``device="cpu"`` that many
    CPU shards (default 1).  ``vol``: a (Z, Y, X) array or tensor; the
    result is a float32 tensor on the mesh's first device, equal to
    ``pipeline.denoise`` of the same input bit for bit.
    ``start_pass``/``mean_val``/``on_pass`` as for ``denoise``:
    ``on_pass(i, volume)`` gets the whole canonical volume after pass i.
    """
    kernels = get_gaussian_kernels(cfg.sigma) if kernels is None else kernels
    shape = tuple(vol.shape)
    if len(shape) != 3:
        raise ValueError(f"volume must be (Z, Y, X), got shape {shape}")
    if mesh is None:
        max_halo = max(len(k) // 2 for k in kernels)
        if n_devices is None:
            n_devices = (torch.cuda.device_count()
                         if torch.device(device).type == "cuda" else 1)
        mesh = make_mesh(usable_device_count(shape, max_halo, max(n_devices, 1)),
                         device=device)
    shards = LocalShards(mesh)
    mean_val = _mean(vol, cfg.boundary, mean_val)
    src = vol.to(torch.float32) if isinstance(vol, torch.Tensor) else np.asarray(vol)
    bounds = [local_z_range(shape[0], shards.size, t)
              for t in range(shards.size)]
    state = _Sharded(0, bounds, {
        t: _as_volume(src[lo:hi], shards.device(t)).to(shards.device(t))
        for t, (lo, hi) in enumerate(bounds)})
    del src
    dev = shards.device(0)
    report = None
    if on_pass is not None:
        def report(i, st):
            on_pass(i, _gather(st, dev))
    state = _denoise_shards(shards, state, kernels, cfg, mean_val, start_pass,
                            report)
    return _gather(state, dev)


__all__ = ["LocalShards", "denoise_sharded", "halo_exchange", "make_mesh",
           "sharded_window_pass", "usable_device_count"]

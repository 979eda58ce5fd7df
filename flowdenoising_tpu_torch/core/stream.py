"""Disk-streamed denoise for volumes larger than host RAM or the card.

Counterpart of ``flowdenoising_tpu/core/stream.py``.  The volume stays on
disk for the whole run, and each of the three passes streams windows of
the pass axis through the card:

    input memmap -> [gather window + kernel halo along the pass axis,
                     boundary context filled on the host, in the file's
                     (Z, Y, X) order] -> pinned buffer -> H2D
                 -> to pass layout on the card -> the pass the in-memory
                    pipeline runs (of_pass_padded / gaussian_pass_padded)
                 -> to (Z, Y, X) order on the card -> D2H -> pinned
                    buffer -> output memmap

The host only copies runs that are contiguous in the files; the
transposes into and out of each pass's layout run on the card.

Two float32 scratch memmaps in a temporary directory ping-pong between
passes (the reference's vol/filtered_vol swap, file-backed); the directory
is removed when the run ends, failed or not.  Host RAM holds a few
windows (plus the OS page cache); the card holds what ``core/memory.py``'s
model sizes a window by.

Every window has the same shape: the last one is anchored at ``n - slab``
and recomputes planes the window before it wrote (the shifted tail).  A
plane's result depends only on its own tap chain, so any window layout
gives the in-memory pipeline's result bit for bit; the MEAN boundary uses
the same ``volume_mean`` value.

Overlap: one worker thread gathers the next window from disk into a
pinned buffer and copies it to the card on a side stream while this
window's pass runs, and copies the previous window's output back on that
stream and writes it to disk.  CUDA events order the streams: the pass
waits for its window's copy, the copy back waits for the pass, and a
pinned buffer is refilled only after the copy that used it has finished;
``record_stream`` tells the caching allocator about each tensor used on
both streams.  ``overlap=False`` runs the same steps one after another.
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import shutil
import tempfile

import numpy as np
import torch

from flowdenoising_tpu_torch.config import Boundary, FilterConfig
from flowdenoising_tpu_torch.core import memory
from flowdenoising_tpu_torch.core.axis_filter import (
    gaussian_pass_padded, of_pass_padded)
from flowdenoising_tpu_torch.core.pipeline import _PASS_LAYOUTS, volume_mean
from flowdenoising_tpu_torch.kernels import get_gaussian_kernels
from flowdenoising_tpu_torch.ops.device import require_device
from flowdenoising_tpu_torch.parallel.mesh import make_mesh, sharded_window_pass


def _gather_into(dst: np.ndarray, src, axis: int, lo: int, hi: int,
                 boundary: Boundary, mean_val) -> None:
    """Fill ``dst`` (float32, ``src``'s layout with ``hi - lo`` slices along
    ``axis``) with slices [lo, hi) along ``axis`` of ``src``, the
    out-of-range ones per the boundary mode.  In-range runs are read as
    plain slices in ``src``'s own order, so memmap reads stay sequential
    and no host transpose is made."""
    n = src.shape[axis]
    i, k = lo, 0
    while i < hi:
        j = min(hi, 0) if i < 0 else (hi if i >= n else min(hi, n))
        sl = [slice(None)] * src.ndim
        sl[axis] = slice(k, k + j - i)
        part = dst[tuple(sl)]
        if 0 <= i < n:
            sl[axis] = slice(i, j)
            part[...] = src[tuple(sl)]
        elif boundary is Boundary.WRAP:
            part[...] = np.take(src, np.arange(i, j) % n, axis=axis)
        elif boundary is Boundary.REPLICATE:
            part[...] = np.take(src, [0 if i < 0 else n - 1], axis=axis)
        else:  # MEAN
            part[...] = mean_val
        k += j - i
        i = j


def _boundary_window(src, axis: int, lo: int, hi: int, boundary: Boundary,
                     mean_val) -> np.ndarray:
    """Slices [lo, hi) along ``axis`` of ``src``, out-of-range ones per the
    boundary mode (wrap, replicate, mean fill), as a float32 array in pass
    layout (``axis`` moved to 0)."""
    shape = list(src.shape)
    shape[axis] = hi - lo
    win = np.empty(shape, np.float32)
    _gather_into(win, src, axis, lo, hi, boundary, mean_val)
    return np.ascontiguousarray(np.moveaxis(win, axis, 0))


class _Inline:
    """The executor interface, running each task at once in the caller."""

    def submit(self, fn, *args):
        fut = concurrent.futures.Future()
        try:
            fut.set_result(fn(*args))
        except Exception as exc:  # handed to the caller by fut.result()
            fut.set_exception(exc)
        return fut

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Windows:
    """The windows of one run: pinned host buffers (two for input, two for
    output, each made at first use at the largest pass's size), the side
    stream and the events that order it against the passes."""

    def __init__(self, device: torch.device, in_elems: int, out_elems: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.copy = torch.cuda.Stream(device) if self.cuda else None
        self.sizes = {"in": in_elems, "out": out_elems}
        self.bufs = {}
        self.last_use = {}   # buffer key -> event of the copy that used it

    def buffer(self, kind: str, j: int, shape) -> torch.Tensor:
        key = (kind, j % 2)
        if key not in self.bufs:
            self.bufs[key] = torch.empty(self.sizes[kind], dtype=torch.float32,
                                         pin_memory=self.cuda)
        if key in self.last_use:
            self.last_use.pop(key).synchronize()
        return self.bufs[key][:int(np.prod(shape))].view(shape)

    def gather(self, j, src, axis, lo, hi, boundary, mean_val):
        """Window j on the device in pass layout, and the event recorded
        after its copy: gathered on the host in ``src``'s layout, moved to
        pass layout on the device (on the CPU: on the host)."""
        shape = list(src.shape)
        shape[axis] = hi - lo
        buf = self.buffer("in", j, shape)
        _gather_into(buf.numpy(), src, axis, lo, hi, boundary, mean_val)
        if not self.cuda:
            return buf.movedim(axis, 0).contiguous(), None
        with torch.cuda.device(self.device), torch.cuda.stream(self.copy):
            win = buf.to(self.device, non_blocking=True)
            win = win.movedim(axis, 0).contiguous()
            ready = torch.cuda.Event()
            ready.record(self.copy)
        self.last_use[("in", j % 2)] = ready
        return win, ready

    def write(self, j, res: torch.Tensor, done, dst, axis: int, a: int):
        """Copy window j's output (pass layout) back after its pass (event
        ``done``), moved to ``dst``'s layout on the device, and write it
        to ``dst`` at ``a`` along ``axis``."""
        if self.cuda:
            with torch.cuda.device(self.device), torch.cuda.stream(self.copy):
                self.copy.wait_event(done)
                canon = res.movedim(0, axis).contiguous()
                buf = self.buffer("out", j, tuple(canon.shape))
                buf.copy_(canon, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(self.copy)
            res.record_stream(self.copy)
            del res, canon
            copied.synchronize()
            host = buf.numpy()
        else:
            host = res.movedim(0, axis).numpy()
        sl = [slice(None)] * 3
        sl[axis] = slice(a, a + host.shape[axis])
        dst[tuple(sl)] = host


def denoise_streamed(src, cfg: FilterConfig = FilterConfig(), kernels=None, *,
                     tmp_dir: str | None = None, out: np.ndarray | None = None,
                     slab_size: int | None = None, on_pass=None,
                     progress=None, mesh=None, n_devices: int | None = None,
                     device="cuda", overlap: bool = True) -> np.ndarray:
    """Three-pass denoise (flow-compensated, or the plain Gaussian) of a
    volume that need not fit in host RAM or on the card.

    ``src``: a (Z, Y, X) array of any dtype, typically a memmap
    (``read_volume(path, memory_map=True)``); windows are converted to
    float32 as they are read.  ``out``: a float32 (Z, Y, X) array the last
    pass writes into (a memmap, for a volume larger than host RAM); an
    array in RAM is made when it is None.  ``slab_size``: output planes a
    window; by default ``memory.pass_slab`` sizes each pass's windows for
    ``device`` (CUDA unless ``device="cpu"``; raises without it).
    ``tmp_dir``: where the scratch directory goes (the system's default
    when None).  ``progress(done, total)`` is called after every window
    with output-plane counts, ``on_pass(i, array)`` after each pass.
    ``mesh`` (``parallel.mesh.make_mesh``; or ``n_devices`` above 1, the
    mesh of that many ``device``s): each window is staged on the mesh's
    first device and its pass runs sharded over the mesh
    (``sharded_window_pass``), bit for bit the single-device result; the
    auto window grows by the shard count.  Returns the output array
    (``out`` when given).
    """
    shape = tuple(src.shape)
    if len(shape) != 3:
        raise ValueError(f"volume must be (Z, Y, X), got shape {shape}")
    if mesh is None and n_devices is not None and n_devices > 1:
        mesh = make_mesh(n_devices, device=device)
    n_dev = 1 if mesh is None else len(mesh)
    device = require_device(device if mesh is None else mesh[0])
    kernels = get_gaussian_kernels(cfg.sigma) if kernels is None else kernels
    mean_val = volume_mean(src) if cfg.boundary is Boundary.MEAN else None

    def pass_fn(window, taps):
        if n_dev > 1:
            return sharded_window_pass(window, taps, cfg, mesh)
        if cfg.use_flow:
            return of_pass_padded(window, taps, cfg.flow)
        return gaussian_pass_padded(window, taps)

    # each pass's axis length, plane, halo and window size
    plans = []
    for i, taps in enumerate(kernels):
        n, h, w = (shape[ax] for ax in _PASS_LAYOUTS[i])
        ks2 = len(taps) // 2
        slab = slab_size
        if slab is None:
            slab = memory.pass_slab(cfg, n, h, w, ks2,
                                    memory.device_budget(device),
                                    streamed=True)
            if slab is not None:
                # each shard's part of a window is what the model bounds
                slab *= n_dev
        plans.append((n, h, w, ks2, min(slab or n, n)))
    windows = _Windows(device,
                       max((s + 2 * k) * h * w for n, h, w, k, s in plans),
                       max(s * h * w for n, h, w, k, s in plans))

    total = sum(shape)
    done = 0
    tdir = tempfile.mkdtemp(prefix="fdt_stream_", dir=tmp_dir)
    try:
        cur = src
        for i, (taps, (n, h, w, ks2, slab)) in enumerate(zip(kernels, plans)):
            if i < 2:
                dst = np.memmap(os.path.join(tdir, f"pass{i % 2}.f32"),
                                dtype=np.float32, mode="w+", shape=shape)
            else:
                dst = out if out is not None else np.empty(shape, np.float32)
            n_win = -(-n // slab)
            # the shifted tail: the last window starts at n - slab
            starts = [min(k * slab, n - slab) for k in range(n_win)]
            logging.info(f"streamed pass {i}: axis={i} n={n} slab={slab} "
                         f"({n_win} windows)")
            pool = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                    if overlap else _Inline())
            with pool:
                def gather(k):
                    return windows.gather(k, cur, i, starts[k] - ks2,
                                          starts[k] + slab + ks2,
                                          cfg.boundary, mean_val)

                fut_in = pool.submit(gather, 0)
                fut_out = None
                for k, a in enumerate(starts):
                    win, ready = fut_in.result()
                    fut_in = None
                    pass_done = None
                    if windows.cuda:
                        stream = torch.cuda.current_stream(device)
                        stream.wait_event(ready)
                        win.record_stream(stream)
                    res = pass_fn(win, taps)
                    del win
                    if windows.cuda:
                        pass_done = torch.cuda.Event()
                        pass_done.record(stream)
                    if k + 1 < n_win:
                        fut_in = pool.submit(gather, k + 1)
                    prev, fut_out = fut_out, pool.submit(
                        windows.write, k, res, pass_done, dst, i, a)
                    del res
                    if prev is not None:
                        prev.result()
                        done += min(slab, n - (k - 1) * slab)
                        if progress is not None:
                            progress(done, total)
                fut_out.result()
                done += n - (n_win - 1) * slab
                if progress is not None:
                    progress(done, total)
            if isinstance(dst, np.memmap):
                dst.flush()
            if on_pass is not None:
                on_pass(i, dst)
            if isinstance(cur, np.memmap) and i >= 1:
                # the scratch file pass i read is not read again
                path = cur.filename
                del cur
                os.remove(path)
            cur = dst
        return cur
    finally:
        shutil.rmtree(tdir, ignore_errors=True)

"""Three-pass Z -> Y -> X denoising pipeline.

Counterpart of ``flowdenoising_tpu/core/pipeline.py``.  Each pass filters
along axis 0 of a permuted, contiguous copy of the volume, so the in-plane
axes stay contiguous:

- Z pass: (Z, Y, X); OF planes are (Y, X).
- Y pass: (Y, Z, X); OF planes are (Z, X).
- X pass: (X, Z, Y); OF planes are (Z, Y).

The volume moves straight from one pass's layout to the next's (one
permutation per pass boundary).  The MEAN boundary pads all three passes
with one float32 value, the mean of the INPUT volume: ``volume_mean`` of
the host array where there is one (the CLI, the stream, a checkpoint's
manifest and ``denoise`` of an array all take that value), the tensor's
own float32 mean for a tensor given with no ``mean_val``.  Each pass runs
over the whole axis where ``core/memory.py``'s model says it fits the
card, else (or with an explicit ``slab_size``) over axis-0 slabs with the
kernel support's halo, with results equal to the whole-axis pass.
``start_pass``/``mean_val`` resume a run at a pass boundary (see
``utils/checkpoint.py``).

Everything runs on the device of the input tensor; any other input (a
numpy array) is taken to ``device``, CUDA unless the caller asks for the
CPU.  ``denoise_many`` denoises a stream of volumes with the next one's
copy to the card overlapping this one's passes.
"""

from __future__ import annotations

import collections
import concurrent.futures

import numpy as np
import torch

from flowdenoising_tpu_torch.config import Boundary, FilterConfig, FlowConfig
from flowdenoising_tpu_torch.core import memory
from flowdenoising_tpu_torch.core.axis_filter import (
    gaussian_pass_padded, of_pass_padded, pad_stack)
from flowdenoising_tpu_torch.kernels import get_gaussian_kernels
from flowdenoising_tpu_torch.ops.device import as_tensors, require_device
from flowdenoising_tpu_torch.utils.tracing import PASS_RANGE, span

# Canonical axes of each pass's layout, in Z, Y, X pass order.
_PASS_LAYOUTS = [(0, 1, 2), (1, 0, 2), (2, 0, 1)]
# Z planes a chunk of ``volume_mean``'s float64 sum.
_MEAN_CHUNK = 8


def volume_mean(src) -> np.float32:
    """The MEAN boundary's fill value: the mean of a (Z, Y, X) array or
    memmap of any dtype, summed in float64 over fixed chunks of Z planes
    on the host (a memmap is read once, a chunk at a time) and rounded
    once to float32."""
    total = 0.0
    for a in range(0, src.shape[0], _MEAN_CHUNK):
        total += float(np.sum(src[a:a + _MEAN_CHUNK], dtype=np.float64))
    return np.float32(total / max(int(np.prod(src.shape)), 1))


def slabbed_padded_pass(padded_pass_fn, padded: torch.Tensor, taps,
                        n: int, slab_size: int | None) -> torch.Tensor:
    """Run a pass over axis-0 slabs of an already padded stack
    (n + 2*ks2 slices); slabs are balanced in size and the last is padded
    by repeating the final slice, as in the JAX package.  Each slab's
    result is copied into one output tensor."""
    ks2 = len(taps) // 2
    if slab_size is None or slab_size >= n:
        return padded_pass_fn(padded, taps)
    n_slabs = -(-n // slab_size)
    slab = -(-n // n_slabs)
    out = None
    for s in range(0, n_slabs * slab, slab):
        window = padded[s:s + slab + 2 * ks2]
        short = slab + 2 * ks2 - window.shape[0]
        if short:
            tail = padded[-1:].expand((short,) + tuple(padded.shape[1:]))
            window = torch.cat([window, tail], dim=0)
        res = padded_pass_fn(window, taps)
        if out is None:
            out = res.new_empty((n,) + tuple(res.shape[1:]))
        out[s:s + slab] = res[:min(slab, n - s)]
    return out


def _as_volume(vol, device="cuda") -> torch.Tensor:
    """``vol`` as a float32 tensor: a tensor stays on its own device, any
    other input goes to ``device``.  Raises when that is a CUDA device and
    none is available -- never a silent fall back to the CPU."""
    vol, = as_tensors(vol, device=device)
    return vol.to(torch.float32)


def pass_slab(cfg: FilterConfig, n: int, h: int, w: int, ks2: int,
              device="cuda") -> int | None:
    """Output planes a window of one pass holds on ``device`` (None: the
    whole axis), as ``denoise`` sizes them: ``core/memory.py``'s model
    against the memory the device has free (``memory.device_budget``).
    ``cfg.slab_size`` when set; the whole axis on the CPU."""
    budget = memory.device_budget(require_device(device))
    return memory.pass_slab(cfg, n, h, w, ks2, budget)


def _mean(vol, boundary: Boundary, mean_val):
    """The MEAN fill value (None for the other boundaries): ``mean_val``
    when given, else ``volume_mean`` of an array, else the tensor's mean."""
    if boundary is not Boundary.MEAN:
        return None
    if mean_val is not None:
        return np.float32(mean_val)
    if isinstance(vol, torch.Tensor):
        return vol.to(torch.float32).mean()
    return volume_mean(np.asarray(vol))


def _run_passes(vol: torch.Tensor, kernels, cfg: FilterConfig, mean_val,
                padded_pass_fn, on_pass, start_pass: int):
    """Passes ``start_pass``.. over ``vol``, the canonical (Z, Y, X) result
    of pass ``start_pass - 1`` (the input for 0); a window per pass as
    ``memory.pass_slab`` sizes it for the card.  Each pass runs in the
    range ``fdt.pass``, ``on_pass`` after it."""
    shape = tuple(vol.shape)
    out = vol
    del vol
    layout = (0, 1, 2)
    for i, taps in enumerate(kernels):
        if i < start_pass:
            continue
        target = _PASS_LAYOUTS[i]
        with span(PASS_RANGE):
            perm = tuple(layout.index(ax) for ax in target)
            if perm != (0, 1, 2):
                out = out.permute(perm)
            layout = target
            out = out.contiguous()
            ks2 = len(taps) // 2
            n, h, w = (shape[ax] for ax in target)
            slab = memory.pass_slab(cfg, n, h, w, ks2,
                                    memory.device_budget(out.device))
            padded = pad_stack(out, ks2, cfg.boundary, mean_val)
            del out
            out = slabbed_padded_pass(padded_pass_fn, padded, taps, n, slab)
            del padded
        if on_pass is not None:
            on_pass(i, out.permute(tuple(target.index(ax) for ax in (0, 1, 2))))
    return out.permute(tuple(layout.index(ax) for ax in (0, 1, 2))).contiguous()


def gaussian_denoise(vol, sigma=(2.0, 2.0, 2.0),
                     boundary: Boundary = Boundary.WRAP,
                     slab_size: int | None = None, kernels=None,
                     start_pass: int = 0, mean_val=None,
                     on_pass=None, device="cuda") -> torch.Tensor:
    """No-OF separable 3-D Gaussian denoise (reference ``-n`` path).
    Arguments as for ``denoise``."""
    kernels = get_gaussian_kernels(sigma) if kernels is None else kernels
    cfg = FilterConfig(sigma=tuple(sigma), boundary=boundary, use_flow=False,
                       slab_size=slab_size)
    return _run_passes(_as_volume(vol, device), kernels, cfg,
                       _mean(vol, boundary, mean_val), gaussian_pass_padded,
                       on_pass, start_pass)


def denoise(vol, cfg: FilterConfig = FilterConfig(), kernels=None,
            start_pass: int = 0, mean_val=None, on_pass=None,
            owned: bool = False, device="cuda") -> torch.Tensor:
    """Full OF-compensated denoise: Z, Y, X passes of Farneback-compensated
    Gaussian accumulation (or the plain Gaussian when cfg.use_flow is
    False).

    ``vol`` is a (Z, Y, X) tensor, which is filtered on its own device, or
    an array, which is taken to ``device`` (default CUDA; raises without a
    CUDA device unless ``device="cpu"``).  Each pass runs in
    ``cfg.flow.dtype`` (the bf16 fast mode: ``dtype`` and ``precision``
    bfloat16) and returns float32, so the volume is float32 between passes
    and the result is float32 on the device the work ran on.  The caller's
    tensor is never written.

    The MEAN boundary pads every pass with ``mean_val``, the input
    volume's mean; when it is None, ``volume_mean`` of an array input or
    the float32 mean of a tensor input.  ``start_pass``/``mean_val``
    resume at a pass boundary: with ``start_pass=i`` pass ``vol`` as the
    canonical (Z, Y, X) result of pass i-1 and ``mean_val`` as the
    ORIGINAL input's mean (the reference's sequential pipeline pads every
    pass with the input mean); ``start_pass >= 3`` returns the volume and
    launches nothing.  ``on_pass(i, volume)`` is called after pass i.
    ``owned`` is the JAX package's leave to donate the caller's buffer; the
    port neither donates nor writes it, so it changes nothing here.
    """
    if not cfg.use_flow:
        return gaussian_denoise(vol, cfg.sigma, cfg.boundary, cfg.slab_size,
                                kernels, start_pass=start_pass,
                                mean_val=mean_val, on_pass=on_pass,
                                device=device)
    kernels = get_gaussian_kernels(cfg.sigma) if kernels is None else kernels

    def of_pass(padded, taps):
        return of_pass_padded(padded, taps, cfg.flow)

    return _run_passes(_as_volume(vol, device), kernels, cfg,
                       _mean(vol, cfg.boundary, mean_val), of_pass, on_pass,
                       start_pass)


def _stage(v, device: torch.device, stream) -> torch.Tensor:
    """One volume of ``denoise_many`` on ``device``, float32.  A tensor on
    the device is taken as it is (``denoise`` never writes its input);
    anything else is converted on the host, and for a CUDA device copied
    from pinned memory on ``stream``, which the call waits for."""
    if isinstance(v, torch.Tensor) and v.device == device:
        return v
    host = torch.as_tensor(np.asarray(v), dtype=torch.float32)
    if device.type != "cuda":
        return host.to(device)
    with torch.cuda.stream(stream):
        dev = host.pin_memory().to(device, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(stream)
    ready.synchronize()
    return dev


def _wait_done(done) -> None:
    """Wait for one dispatched volume of ``denoise_many``: its CUDA event,
    recorded after its last pass (None on the CPU, where the passes ran
    as they were called)."""
    if done is not None:
        done.synchronize()


def denoise_many(vols, cfg: FilterConfig = FilterConfig(), kernels=None,
                 window: int = 2, to_host: bool = False, device="cuda"):
    """Throughput mode: denoise a stream of equally shaped volumes.

    A staging thread converts each volume to float32 and copies it to
    ``device`` from pinned memory on its own CUDA stream while the passes
    of the volume before it run.  ``vols`` may be any iterable, consumed
    lazily (a generator reading volumes from disk streams end to end).  At
    most ``window`` volumes are staged or in flight on the device at once:
    before the next volume is staged, the oldest one in flight is waited
    for through a CUDA event recorded after its last pass.  A caller's
    tensor is never written.

    Returns the results in order: tensors on the device, or with
    ``to_host`` numpy arrays, each fetched (on a side stream, so the next
    volume's passes overlap it) and its device buffer freed as it leaves
    the window.  Raises without CUDA unless ``device="cpu"``; an error of
    the staging thread is raised here.
    """
    device = require_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    window = max(1, int(window))
    kernels = get_gaussian_kernels(cfg.sigma) if kernels is None else kernels
    cuda = device.type == "cuda"
    h2d = torch.cuda.Stream(device) if cuda else None
    d2h = torch.cuda.Stream(device) if cuda else None
    it = iter(vols)
    end = object()
    staged = collections.deque()     # futures of staged volumes
    pending = collections.deque()    # (index, done event) in flight
    outs = []

    def fetch(i):
        """Start copying result i to pinned host memory on the side stream."""
        if not cuda:
            outs[i] = outs[i].numpy()
            return
        res = outs[i]
        host = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
        with torch.cuda.stream(d2h):
            host.copy_(res, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(d2h)
        res.record_stream(d2h)
        outs[i] = (host, copied)

    def retire():
        i, done = pending.popleft()
        _wait_done(done)
        if to_host:
            fetch(i)

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        def fill():
            while len(staged) + len(pending) < window:
                v = next(it, end)
                if v is end:
                    return
                staged.append(pool.submit(_stage, v, device, h2d))

        fill()
        while staged:
            v = staged.popleft().result()
            if cuda:
                # allocated on the staging stream, read on this one
                v.record_stream(torch.cuda.current_stream(device))
            outs.append(denoise(v, cfg, kernels=kernels, device=device))
            del v
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(device))
            pending.append((len(outs) - 1, done))
            if not staged:
                retire()
                fill()
        while pending:
            retire()
    if to_host and cuda:
        for i, (host, copied) in enumerate(outs):
            copied.synchronize()
            outs[i] = host.numpy()
    return outs


__all__ = ["FlowConfig", "denoise", "denoise_many", "gaussian_denoise",
           "pass_slab", "volume_mean", "slabbed_padded_pass"]

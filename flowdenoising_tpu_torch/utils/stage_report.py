"""Reconstructed per-stage device time for the CLI (verbosity >= 2).

Counterpart of ``flowdenoising_tpu/utils/stage_report.py``: each hot op is
timed on its own on a small slice batch at the run's real plane sizes and
scaled by its per-pass invocation count.  The CLI logs it when the
profiler trace of the run holds no device event (a CPU run); on the card
it logs the measured report of ``utils.trace_report``.

The OFE_solve stage times the split iteration ``update_flow(
update_matrices(...))`` -- the kernels K-um and K-uf -- as the JAX
package's report does, not the fused K-umuf that the run itself uses; with
``--precision bfloat16`` and a bound, K-um's packed form (r1 in bfloat16),
as the JAX report samples packed.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from flowdenoising_tpu_torch.config import FilterConfig

_SAMPLE_SLICES = 8
_REPS = 4


def _seconds(fn, device: torch.device) -> float:
    """Wall seconds of ``fn()``: CUDA events on the card, the host clock on
    the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _time_op(step, init, *consts, device: torch.device, reps: int = _REPS):
    """Seconds per call of ``x <- step(x, *consts)``: ``reps`` chained calls
    per timing, one warm-up timing, the best of two timed ones."""
    def many():
        x = init
        for _ in range(reps):
            x = step(x, *consts)
        return x

    _seconds(many, device)
    return min(_seconds(many, device) for _ in range(2)) / reps


def device_stage_report(vol_shape: tuple[int, int, int], cfg: FilterConfig,
                        kernels, device=None) -> dict[str, float]:
    """Estimate per-stage device seconds for the full 3-pass run on
    ``device`` (default CUDA).

    Returns {"OFE_expansion": s, "OFE_solve": s, "pyramid": s, "warping": s,
    "convolution": s} and logs a table.  Stages are timed on
    ``_SAMPLE_SLICES``-slice batches and scaled linearly in slice count.
    """
    from flowdenoising_tpu_torch.ops.farneback import (
        _level_displacement, poly_expand, split_route, update_flow,
        update_matrices)
    from flowdenoising_tpu_torch.ops.resize import resize_linear
    from flowdenoising_tpu_torch.ops.warp import warp_slices

    device = torch.device("cuda" if device is None else device)
    fcfg = cfg.flow
    totals = {"OFE_expansion": 0.0, "OFE_solve": 0.0, "pyramid": 0.0,
              "warping": 0.0, "convolution": 0.0}
    rng = np.random.default_rng(0)
    b = _SAMPLE_SLICES

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    def timed(step, init, *consts):
        return _time_op(step, init, *consts, device=device)

    # The three passes see planes (Y,X), (Z,X), (Z,Y) with n = Z, Y, X.
    planes = [(vol_shape[1], vol_shape[2]), (vol_shape[0], vol_shape[2]),
              (vol_shape[0], vol_shape[1])]
    for p, ((h, w), taps) in enumerate(zip(planes, kernels)):
        n = vol_shape[p]
        ks2 = len(taps) // 2
        scale = (n + 2 * ks2) / b       # padded stack slices per batch
        scale_n = n / b                 # interior slices per batch
        taps_nc = 2 * ks2
        if cfg.use_flow and fcfg.tap_mode != "solve":
            # compose: 2 adjacent-direction solves (1 with symmetric), one
            # compose step (2 warps) per tap.
            n_solves = 1 if fcfg.symmetric_adjacent else 2
            warps_per_tap = 2.0
        elif cfg.use_flow:
            n_solves = taps_nc
            warps_per_tap = 1.0
        else:
            n_solves = 0
            warps_per_tap = 0.0

        levels = fcfg.clamped_levels(h, w) if cfg.use_flow else 0
        for k in range(levels + 1) if cfg.use_flow else []:
            hk = max(1, round(h * fcfg.pyr_scale ** k))
            wk = max(1, round(w * fcfg.pyr_scale ** k))
            img = tensor(rng.normal(size=(b, hk, wk)))
            d = _level_displacement(fcfg, k)
            t_pe = timed(
                lambda x: poly_expand(x, fcfg.poly_n, fcfg.poly_sigma)[:, 0] + x,
                img)
            totals["OFE_expansion"] += t_pe * scale
            r0 = poly_expand(img, fcfg.poly_n, fcfg.poly_sigma).contiguous()
            r1 = r0 + 0.01
            if fcfg.precision == "bfloat16" and d is not None:
                r1 = r1.to(torch.bfloat16)
            # the JAX report's channels-last draw, moved channel-first
            flow0 = tensor(np.moveaxis(
                0.5 * rng.standard_normal((b, hk, wk, 2)), -1, -3))
            t_it = timed(
                lambda f, a, bb: update_flow(update_matrices(a, bb, f, d),
                                             fcfg.winsize),
                flow0, r0, r1)
            totals["OFE_solve"] += (t_it * fcfg.iterations * n_solves
                                    * (scale_n if fcfg.tap_mode == "solve"
                                       else scale))
            if k > 0:
                t_rz = timed(
                    lambda f: resize_linear(f, (hk, wk)) * 0.5 + f * 0.1,
                    flow0)
                totals["pyramid"] += t_rz * n_solves * scale_n

        if cfg.use_flow:
            img = tensor(rng.normal(size=(b, h, w)))
            flw = tensor(rng.uniform(-1, 1, size=(b, h, w, 2)))
            t_wp = timed(
                lambda s, f: warp_slices(s, f, fcfg.max_displacement),
                img, flw)
            totals["warping"] += t_wp * taps_nc * warps_per_tap * scale_n

        # convolution = the tap-weighted accumulate, reported for parity
        # with the reference's split
        img = tensor(rng.normal(size=(b, h, w)))
        t_acc = timed(lambda a, s: a + s * 0.123, img, img + 1)
        totals["convolution"] += t_acc * taps_nc * scale_n

    run = ("runs it with a bf16 phase 1" if split_route(fcfg)
           else "uses the fused K-umuf")
    logging.info("[stages] reconstructed device time (per-op microbench at "
                 f"{b}-slice samples on {device}, scaled to full passes; "
                 f"OFE_solve times the split iteration K-um + K-uf, the run "
                 f"{run}):")
    total = sum(totals.values())
    for name, secs in sorted(totals.items(), key=lambda kv: -kv[1]):
        pct = 100.0 * secs / total if total else 0.0
        logging.info(f"[stages]   {name:14s} {secs:8.4f}s  ({pct:4.1f}%)")
    logging.info(f"[stages]   {'total':14s} {total:8.4f}s")
    return totals

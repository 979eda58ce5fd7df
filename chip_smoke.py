"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py              # 256^3 main paths (the default)
    python3 chip_smoke.py --size 512   # the same phases at 512^3

Phases, one or more lines of output each (any failure exits non-zero):

1. device   -- a CUDA device of capability 9.0 (H100); its name and power
               limit as nvidia-smi reports them.
2. build    -- the kernels under flowdenoising_tpu_torch/csrc, compiled
               with nvcc for sm_90a (one compiler per source, in parallel),
               and beside them the native I/O runtime libfdio
               (flowdenoising_tpu_torch/runtime, g++); either failing to
               build or load fails the run.
3. kernels  -- K-sample, K-umuf, K-compose, K-um, K-uf and K-umuf-split
               against their plain PyTorch versions on the card, at the
               shapes the main paths give them, with the tolerances of the
               JAX package's own kernel tests; times of both, the least
               time the card could take for the same work (bound), and for
               K-sample the time of torch.nn.functional.grid_sample on the
               same sampling (the port never calls it).  K-umuf also at
               winsize 15 and on planes smaller than its tile, its
               main-path call at one iteration a launch against the
               planner's default, and its time at each pyramid level of the
               main path.  Then the packed
               forms (bf16 sources, --precision bfloat16) K-umuf-bf16,
               K-compose-bf16 (with and without the bf16 carry rounding) and
               K-um-bf16, each equal to its plain version bit for bit, timed
               beside its float32 form, bound at bf16 source width;
               K-umuf-bf16 also at every other level call the bf16 paths
               run packed at 256^3 and 512^3, bit-identical there too.  Last
               K-compose-run and K-compose-run-bf16, the whole compose pass
               in one launch (the form the compose paths run), bit-identical
               to compose_run_plain at D 8 and None, with and without the
               carry rounding and the symmetric sign, and timed at the main
               path's pass call beside the 16 per-tap K-compose launches it
               replaced.  K-uf also on the M of the split route's bf16
               phase 1 (--dtype bfloat16 --max_displacement 0) at every
               level of a 256^2 plane, batch 256, bit for bit, timed at
               level 0 beside that phase 1.  K-umuf-split, the split
               route's iterations of a level in one launch, bit for bit
               split_iterate_plain at every level of the 256^2 and 512^2
               pyramids (batch 256) from bf16 and float32 flows, at one,
               two and three iterations a launch, and on 40 x 261 and
               8 x 1030 planes; timed at each level beside its plain
               version and its bound.
4. main     -- paths through the CLI (python -m flowdenoising_tpu_torch
               ... -s 2 2 2) on a seeded size^3 blob volume with noise,
               through MRC files: at --max_displacement 8 solve mode,
               compose mode (--tap_flow compose), compose with
               --symmetric_adjacent and solve with --flow_presmooth auto
               (which must switch presmooth on), the bf16 fast mode in
               solve mode (solve_bf16: --dtype bfloat16 --precision
               bfloat16, run with -v 2 and the trace read as empty, so the
               reconstructed stage report runs K-um-bf16) and in the JAX
               README's fast mode (fast: compose, symmetric adjacent flows,
               bf16), each also against the same path at float32; the
               bf16 pass with no bound (the split route: K-umuf-split,
               the exact gather in bf16 in plain PyTorch) in solve mode
               (solve_bf16_nobound) and in the fast mode's compose flags
               (fast_nobound), each against the same flags at float32,
               with -v 2 and its measured stage report, and
               solve_bf16_nobound once more with the trace read as empty
               (the reconstruction); then auto_v2, the CLI's
               default flow setup with -v 2 (the auto displacement probe,
               the profiled run and its measured stage report), and the
               same command once more with the trace read as empty, so the
               CLI falls back to the reconstructed stage report (K-um and
               K-uf) on the card.  Each CLI run has the launch counts set
               to 0 just before it; the counts must be what its probe, tap,
               level and report loops imply, the output finite and closer
               to the clean volume than the input, and its MRC read and
               write must go through libfdio.  Then a warm timed run
               of ``denoise`` per path, which must equal the CLI's output, a
               torch.profiler run of solve and compose for the device-time
               split, the cost of the -v 2 profiling (auto_v2 and the two
               no-bound paths), and the two stage reports side by side.
5. e2e      -- a 24x96x96 volume through ``denoise`` on the card (kernels)
               and on the CPU (plain versions), in solve and in compose
               mode, presmoothed, and in the four bf16 paths: PSNR >= 55 dB
               between them; the compose, fast and both no-bound outputs
               bit-identical.
6. stream   -- the streamed, resumed and batched paths on phase 4's noisy
               volume (sigma 2, D 8, wrap unless named), each bit-identical
               to the in-memory CLI output of the same path and with the
               launch counts its windows imply: the in-memory references
               (solve, compose, --boundary mean); stream (--stream, the auto
               slab: one window a pass at these sizes; its host RSS rise
               beside the in-memory solve's); stream_slabs
               (--slab_size S = 3*size//10: 4 windows a pass with a shifted
               tail), twice; stream_compose; stream_mean;
               stream_bf16_nobound (against phase 4's output); denoise_streamed
               with its overlap off and on, in turns; resume (a
               --checkpoint_dir run stopped after pass 1's checkpoint, the
               same command resuming at pass 2 and stopped in the write,
               then the finished volume written with no launch); batch
               (denoise_many of three volumes, window 2, to_host off and
               on, against single denoises).  Each line gives the windows,
               the wall time beside the in-memory one and the peak device
               memory against core/memory.py's model.  Then memory: the
               peaks of in-memory solve denoises at 256^3, 512^3,
               384x512x512 and 128x1024x1024 against the model, and a
               denoise with the budget forced small (>= 3 slabs a pass),
               bit-identical to the whole axis.

7. sharded -- ``denoise_sharded`` over a mesh of 4 shards of the one card
               (``make_mesh(devices=[cuda:0] * 4)``, the shards run in
               turn) on phase 4's noisy volume: solve, compose, symmetric
               compose, solve_bf16 and fast, the MEAN and REPLICATE
               boundaries, an uneven (size-2)x(size)x(size-6) volume and a
               forced per-shard slab, each bit-identical to the
               single-device ``denoise`` with the launches its shard
               windows imply; the warm wall of 4 shards beside one device,
               in turns; the sharded stream (2 shards, S = 3*size//10);
               the CLI with --devices 4 (a mesh of the one card) and as a
               world of one NCCL process (--coordinator 127.0.0.1:PORT
               --num_hosts 1 --host_id 0: ingest, reductions and
               write_mrc_sharded), both equal to the plain CLI's output.
               One card cannot show two ranks' NCCL messages or a
               multi-GPU wall.
8. io      -- the CLI's read and write of a 512^3 float32 MRC through
               libfdio and through the NumPy path, in turns: the same
               array and the same file bytes, and their walls.

    python3 chip_smoke.py --stream_shape 512x1024x1024   # phases 1, 2, 6

The last lines are the card's nvidia-smi line, a JSON object of the kernels
(not with --stream_shape; each with its launches on the sharded paths
under "paths") and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def psnr(a: np.ndarray, ref: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    mse = np.mean((a - ref) ** 2)
    peak = max(ref.max() - ref.min(), 1e-12)
    return float("inf") if mse == 0 else float(10 * np.log10(peak * peak / mse))


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around ``reps``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Published peaks of one H100 SXM at its 700 W limit: HBM bytes/s and
# float32 flop/s outside the tensor cores (none of the kernels has a
# matrix product).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time in ms the card could take for work that must move
    ``nbytes`` (each input read once, each output written once) and do
    ``flops``, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# float32 operations per output element, counted from the kernels' sources
# (compares, floors and casts counted as one each).
SAMPLE_FLOPS = 10 + 6          # clamp, coordinates, floor, fractions; 3 lerps
COMPOSE_FLOPS = 2 * 10 + 2 * 6 + 2 + 6 + 2   # two footprints, 2 + 1 samples, add, fma


UM_FLOPS = 70                  # footprint, five sampled channels, M


def uf_flops(winsize: int) -> int:
    """Per pixel, what the function needs (not what a kernel happens to
    do): a separable box sum of 2 * (2r+1) adds per channel, r =
    winsize // 2, 5 scales, ~12 in the 2x2 solve."""
    return 5 * 2 * (2 * (winsize // 2) + 1) + 5 + 12


def umuf_flops(winsize: int) -> int:
    """Per pixel and iteration: phase 1 (K-um's work) and phase 2 (K-uf's)."""
    return UM_FLOPS + uf_flops(winsize)


def blob_volume(n: int, h: int, w: int, seed: int, drift: float = 0.7):
    """Smooth blob field whose slices drift with Z (the pattern of the
    test suite's make_blob_volume, with blob count scaled to the plane)."""
    r = np.random.default_rng(seed)
    pad = 16
    hp, wp = h + 2 * pad, w + 2 * pad
    base = np.zeros((hp, wp), np.float32)
    for _ in range(max(20, h * w // 300)):
        cy, cx = r.uniform(pad, h + pad), r.uniform(pad, w + pad)
        rad, amp = r.uniform(3, 9), r.uniform(50, 200)
        y0, y1 = max(int(cy - 4 * rad), 0), min(int(cy + 4 * rad) + 1, hp)
        x0, x1 = max(int(cx - 4 * rad), 0), min(int(cx + 4 * rad) + 1, wp)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        base[y0:y1, x0:x1] += amp * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * rad * rad))
    vol = np.empty((n, h, w), np.float32)
    oy = ox = float(pad)
    for z in range(n):
        iy, ix = int(round(oy)), int(round(ox))
        vol[z] = base[iy:iy + h, ix:ix + w]
        oy = min(max(oy + r.uniform(-drift, drift), 0), 2 * pad - 1)
        ox = min(max(ox + r.uniform(-drift, drift), 0), 2 * pad - 1)
    return vol


def phase_device() -> str:
    require(torch.cuda.is_available(), "no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    require(cap == (9, 0), f"needs a Hopper card (capability 9.0), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    # full-float32 matrix products for the resize einsums; the path has no
    # convolution, so cuDNN's TF32 flag does not apply
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    require(torch.get_float32_matmul_precision() == "highest",
            "float32 matmul precision is not 'highest'")
    print(f"[1 device] {torch.cuda.get_device_name(0)} capability {cap}, "
          f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"nvidia-smi: {card}; tf32 matmul off", flush=True)
    return card


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from flowdenoising_tpu_torch import runtime
    from flowdenoising_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    # the native I/O runtime (g++) beside the kernels (nvcc); either
    # failing to build fails the run
    with ThreadPoolExecutor(1) as pool:
        fdio = pool.submit(runtime.build)
        path = build.build()
        fdio_path = fdio.result()
    build.load_library()
    require(runtime.native_available(), f"libfdio built at {fdio_path} but "
            "did not load")
    secs = time.perf_counter() - t0
    log = path.with_suffix(".log").read_text() if path.with_suffix(".log").exists() else ""
    usage = [ln.split("info    : ")[-1] for ln in log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    print(f"[2 build] {path.name} in {secs:.2f} s; ptxas: {' | '.join(usage)}",
          flush=True)
    print(f"[2 build] native I/O runtime {fdio_path} built and loaded",
          flush=True)


def phase_kernels(dev, seed: int) -> dict:
    from flowdenoising_tpu_torch.ops import farneback as F
    from flowdenoising_tpu_torch.ops.cuda.compose import (
        compose_tap, compose_tap_plain)
    from flowdenoising_tpu_torch.ops.cuda.umuf import plan_umuf, umuf_iterate
    from flowdenoising_tpu_torch.ops.warp import (
        displace_sample, displace_sample_plain)

    r = np.random.default_rng(seed)
    res = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def banded_flow(n, h, w, d, scale=3.0):
        """Flows N(0, scale) (n, 2, h, w) with a band pushed beyond +-d."""
        f = r.normal(size=(n, 2, h, w)) * scale
        f[:, 0, : h // 4] += 3 * (d or 8)
        f[:, 1, :, : w // 4] -= 3 * (d or 8)
        return t(f)

    # K-sample: (64, 1, 256, 256) at D=8 and no bound; flows N(0, 3) with a
    # band pushed beyond +-D; data of scale ~50; atol 2e-4
    err = 0.0
    for d in (8, None):
        src = t(r.normal(size=(64, 1, 256, 256)) * 50)
        u = r.normal(size=(64, 256, 256)) * 3
        v = r.normal(size=(64, 256, 256)) * 3
        u[:, :64] += 24
        v[:, :, :64] -= 24
        u, v = t(u), t(v)
        out = displace_sample(src, u, v, d)
        ref = displace_sample_plain(src, u, v, d)
        torch.cuda.synchronize()
        e = float((out - ref).abs().max())
        require(e <= 2e-4, f"K-sample D={d}: max abs err {e} > 2e-4")
        err = max(err, e)
        ms = cuda_ms(lambda: displace_sample(src, u, v, d))
        pms = cuda_ms(lambda: displace_sample_plain(src, u, v, d), reps=3)
        print(f"[3 kernels] K-sample (64,1,256,256) D={d}: max_abs_err {e:.3g}, "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms", flush=True)
    # the main path's call: the tap warp of a 256^3 pass, (256, 256, 256)
    # neighbours, flow channels as views of a (256, 2, 256, 256) flow
    src = t(r.normal(size=(256, 256, 256)) * 50)
    flow = t(r.normal(size=(256, 2, 256, 256)) * 3)
    out = displace_sample(src, flow[:, 0], flow[:, 1], 8)
    ref = displace_sample_plain(src, flow[:, 0], flow[:, 1], 8)
    torch.cuda.synchronize()
    e = float((out - ref).abs().max())
    require(e <= 2e-4, f"K-sample main shape: max abs err {e} > 2e-4")
    ms = cuda_ms(lambda: displace_sample(src, flow[:, 0], flow[:, 1], 8))
    pms = cuda_ms(lambda: displace_sample_plain(src, flow[:, 0], flow[:, 1], 8), reps=3)
    # the library yardstick: grid_sample on the clamped flow, in normalised
    # coordinates (align_corners: -1 and 1 are the edge texel centres;
    # border padding replicates the edge)
    n, h, w = src.shape
    fc = flow.clamp(-8.0, 8.0)
    gx = torch.arange(w, device=dev, dtype=torch.float32) + fc[:, 0]
    gy = torch.arange(h, device=dev, dtype=torch.float32)[:, None] + fc[:, 1]
    grid = torch.stack([gx * (2.0 / (w - 1)) - 1.0, gy * (2.0 / (h - 1)) - 1.0], -1)
    src4 = src[:, None]

    def library():
        return torch.nn.functional.grid_sample(
            src4, grid, mode="bilinear", padding_mode="border", align_corners=True)

    lms = cuda_ms(library)
    lib_err = float((library()[:, 0] - out).abs().max())
    bms, by = bound(4 * (2 * src.numel() + flow.numel()), SAMPLE_FLOPS * src.numel())
    print(f"[3 kernels] K-sample main-path call (256,256,256) D=8: max_abs_err "
          f"{e:.3g}, kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms "
          f"({by}), grid_sample {lms:.4f} ms (max abs diff to the kernel "
          f"{lib_err:.3g})", flush=True)
    res["sample"] = dict(max_abs_err=max(err, e), ms=ms, plain_ms=pms,
                         bound_ms=bms, bound_by=by, library_ms=lms)
    del src, flow, out, ref, fc, gx, gy, grid, src4

    # K-umuf: batch 16 at every level of a 256^2 plane with its d_k, iters 3,
    # winsize 5, 7 and 15, and planes smaller than the tile; atol 5e-4, rtol
    # 1e-4 (the design intends 0: the log line says whether it is)
    def umuf_check(what, rr, flow, iters, d, ws, per_launch=None):
        out = umuf_iterate(rr[0], rr[1], flow, iters, d, ws, per_launch)
        ref = F.umuf_iterate_plain(rr[0], rr[1], flow, iters, d, ws)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        e = float(diff.max())
        require(bool((diff <= 5e-4 + 1e-4 * ref.abs()).all()),
                f"K-umuf {what}: max abs err {e}")
        return e, "bit-identical" if torch.equal(out, ref) else "NOT bit-identical"

    def umuf_operands(b, h, w, d):
        imgs = t(r.normal(size=(2, b, h, w)) * 40)
        return (F.poly_expand(imgs).contiguous(),
                t(r.normal(size=(b, 2, h, w)) * 1.5 * d / 9))

    err = 0.0
    for size, d in ((256, 9), (128, 5), (64, 3), (32, 2), (20, 2), (3, 2)):
        rr, flow = umuf_operands(16, size, size, d)
        for ws in (5, 7, 15):
            plan = plan_umuf(size, size, ws, 3)
            e, same = umuf_check(f"{size}^2 d={d} ws={ws}", rr, flow, 3, d, ws)
            err = max(err, e)
            ms = cuda_ms(lambda: umuf_iterate(rr[0], rr[1], flow, 3, d, ws))
            pms = cuda_ms(lambda: F.umuf_iterate_plain(rr[0], rr[1], flow, 3, d, ws),
                          reps=3)
            print(f"[3 kernels] K-umuf (16,5,{size},{size}) d={d} ws={ws} iters=3, "
                  f"tile {plan.tile_y}x{plan.tile_x} launches {plan.launches}: "
                  f"max_abs_err {e:.3g} ({same}), kernel {ms:.4f} ms, plain "
                  f"{pms:.4f} ms", flush=True)
    # the main path's largest call: level 0 of a 256^3 pass, batch 256; then
    # the same call one iteration a launch (k = 1) against the planner's
    # default, interleaved k1, default, default, k1
    rr, flow = umuf_operands(256, 256, 256, 9)
    plan = plan_umuf(256, 256, 5, 3)
    e, same = umuf_check("main shape", rr, flow, 3, 9, 5)
    e1, same1 = umuf_check("main shape k=1", rr, flow, 3, 9, 5, per_launch=1)
    by_k = {1: [], plan.per_launch: []}
    for k in (1, plan.per_launch, plan.per_launch, 1):
        by_k[k].append(cuda_ms(lambda: umuf_iterate(rr[0], rr[1], flow, 3, 9, 5, k),
                               reps=5))
    ms = sum(by_k[plan.per_launch]) / len(by_k[plan.per_launch])
    pms = cuda_ms(lambda: F.umuf_iterate_plain(rr[0], rr[1], flow, 3, 9, 5),
                  reps=2, warmup=1)
    # the function is 3 chained iterations: r0, r1 and the flow read once,
    # the flow written once
    px = flow.numel() // 2
    bms, by = bound(4 * (2 * rr[0].numel() + 2 * flow.numel()), 3 * umuf_flops(5) * px)
    times = "; ".join(f"k={k}: " + ", ".join(f"{v:.4f}" for v in vs) + " ms"
                      for k, vs in by_k.items())
    print(f"[3 kernels] K-umuf main-path call (256,5,256,256) d=9 ws=5 iters=3, "
          f"tile {plan.tile_y}x{plan.tile_x}, {plan.threads} threads, "
          f"{plan.smem} B shared: max_abs_err {e:.3g} ({same}; k=1 {e1:.3g}, "
          f"{same1}), kernel {ms:.4f} ms at the default k={plan.per_launch} "
          f"({times}), plain {pms:.4f} ms, bound {bms:.4f} ms ({by}); no single "
          "library call", flush=True)
    res["umuf"] = dict(max_abs_err=max(err, e, e1), ms=ms, plain_ms=pms,
                       bound_ms=bms, bound_by=by, library_ms=None)
    # winsize 15 at the main shape: the planner's k against k = 3 forced
    p15 = plan_umuf(256, 256, 15, 3)
    e15, same15 = umuf_check("main shape ws=15", rr, flow, 3, 9, 15)
    t15 = {k: cuda_ms(lambda: umuf_iterate(rr[0], rr[1], flow, 3, 9, 15, k), reps=3)
           for k in (p15.per_launch, 3)}
    p15k3 = plan_umuf(256, 256, 15, 3, 3)
    print(f"[3 kernels] K-umuf (256,5,256,256) d=9 ws=15 iters=3: max_abs_err "
          f"{e15:.3g} ({same15}); default k={p15.per_launch} tile "
          f"{p15.tile_y}x{p15.tile_x} {t15[p15.per_launch]:.4f} ms; k=3 tile "
          f"{p15k3.tile_y}x{p15k3.tile_x} (phase-1 work {p15k3.phase1_work:.2f}x) "
          f"{t15[3]:.4f} ms", flush=True)
    del rr, flow
    # per-level times of the main path's calls at batch 256, for weighting by
    # launches
    for size, d in ((256, 9), (128, 5), (64, 3), (32, 2)):
        rr, flow = umuf_operands(256, size, size, d)
        lms = cuda_ms(lambda: umuf_iterate(rr[0], rr[1], flow, 3, d, 5))
        lp = plan_umuf(size, size, 5, 3)
        print(f"[3 kernels] K-umuf level (256,5,{size},{size}) d={d} ws=5 iters=3: "
              f"{lms:.4f} ms, {len(lp.launches)} launch(es), tile "
              f"{lp.tile_y}x{lp.tile_x}", flush=True)
        del rr, flow

    # K-compose: flow atol 1e-5, accumulator atol 1e-4 (the bars of the JAX
    # package's compose kernel test); links of scale 0.6 (adjacent drift),
    # neighbours of scale ~50; stacks longer than the batch, read at offsets
    def compose_case(n, h, w, d, extra, link_start, nb_start, reps):
        link = t(r.normal(size=(n + extra, 2, h, w)) * 0.6)
        nb = t(r.normal(size=(n + extra + 1, h, w)) * 50)
        flow = banded_flow(n, h, w, d)
        acc = t(r.normal(size=(n, h, w)) * 20)
        wgt = float(np.float32(0.0702))
        fr, ar = compose_tap_plain(link[link_start:link_start + n], flow,
                                   nb[nb_start:nb_start + n], acc, wgt, d)
        fk, ak = flow.clone(), acc.clone()
        compose_tap(link, fk, nb, ak, wgt, d, link_start, nb_start)
        torch.cuda.synchronize()
        ef = float((fk - fr).abs().max())
        ea = float((ak - ar).abs().max())
        require(ef <= 1e-5 and ea <= 1e-4,
                f"K-compose ({n},{h},{w}) D={d}: max abs err flow {ef}, acc {ea}")
        # the kernel updates fk, ak in place on every timed call
        ms = cuda_ms(lambda: compose_tap(link, fk, nb, ak, wgt, d, link_start,
                                         nb_start), reps=reps)
        pms = cuda_ms(lambda: compose_tap_plain(
            link[link_start:link_start + n], flow, nb[nb_start:nb_start + n],
            acc, wgt, d), reps=3)
        # flow and accumulator read and written, n link planes and n
        # neighbour planes read once
        bms, by = bound(4 * (2 * flow.numel() + 2 * acc.numel() + flow.numel()
                             + acc.numel()), COMPOSE_FLOPS * acc.numel())
        print(f"[3 kernels] K-compose ({n},{h},{w}) D={d} link/nb stacks "
              f"{link.shape[0]}/{nb.shape[0]} at {link_start}/{nb_start}: max_abs_err "
              f"flow {ef:.3g} acc {ea:.3g}, kernel {ms:.4f} ms, plain {pms:.4f} ms, "
              f"bound {bms:.4f} ms ({by}); no single library call", flush=True)
        return max(ef, ea), ms, pms, bms, by

    err = 0.0
    for d in (8, None):
        err = max(err, compose_case(16, 256, 256, d, 3, 2, 3, reps=10)[0])
    # the main path's call at 256^3: one tap of a pass, n 256, a 271-plane
    # link stack and the 272-plane padded stack, a mid-run tap's offsets
    e, ms, pms, bms, by = compose_case(256, 256, 256, 8, 15, 7, 8, reps=10)
    res["compose"] = dict(max_abs_err=max(err, e), ms=ms, plain_ms=pms,
                          bound_ms=bms, bound_by=by, library_ms=None)

    # K-um: (256, 5, 256, 256) at d 9 and no bound, and the -v 2 stage
    # report's (8, 5, 256, 256); flows N(0, 1.5) with a band pushed beyond
    # +-d; atol 5e-4, rtol 1e-4 (tests/test_pallas_um.py)
    err, main = 0.0, None
    rr = F.poly_expand(t(r.normal(size=(2, 256, 256, 256)) * 40)).contiguous()
    for b, d in ((256, 9), (256, None), (8, 9)):
        r0, r1 = rr[0, :b], rr[1, :b]
        flow = banded_flow(b, 256, 256, d, scale=1.5)
        out = F.update_matrices(r0, r1, flow, d)
        ref = F.update_matrices_plain(r0, r1, flow, d)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        e = float(diff.max())
        require(bool((diff <= 5e-4 + 1e-4 * ref.abs()).all()),
                f"K-um ({b},5,256,256) d={d}: max abs err {e}")
        err = max(err, e)
        ms = cuda_ms(lambda: F.update_matrices(r0, r1, flow, d))
        pms = cuda_ms(lambda: F.update_matrices_plain(r0, r1, flow, d), reps=3)
        # r0, r1 and the flow read once, M written once: 68 B per pixel
        px = flow.numel() // 2
        bms, by = bound(4 * (3 * r0.numel() + flow.numel()), UM_FLOPS * px)
        print(f"[3 kernels] K-um ({b},5,256,256) d={d}: max_abs_err {e:.3g}, "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms ({by}); "
              "no single library call", flush=True)
        if main is None:
            main = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                        library_ms=None)
            m = ref             # K-uf's input below: M of the main-path call
        del flow, out, ref, diff
    res["um"] = dict(max_abs_err=err, **main)
    del rr

    # K-uf: that M (256, 5, 256, 256) at winsize 5 and 15; atol 1e-4, rtol
    # 1e-4 (tests/test_pallas_uf.py)
    err, main = 0.0, None
    for ws in (5, 15):
        out = F.update_flow(m, ws)
        ref = F.update_flow_plain(m, ws)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        e = float(diff.max())
        require(bool((diff <= 1e-4 + 1e-4 * ref.abs()).all()),
                f"K-uf (256,5,256,256) ws={ws}: max abs err {e}")
        err = max(err, e)
        ms = cuda_ms(lambda: F.update_flow(m, ws))
        pms = cuda_ms(lambda: F.update_flow_plain(m, ws), reps=3)
        # M read once, the flow written once: 28 B per pixel
        px = out.numel() // 2
        bms, by = bound(4 * (m.numel() + out.numel()), uf_flops(ws) * px)
        print(f"[3 kernels] K-uf (256,5,256,256) ws={ws}: max_abs_err {e:.3g}, "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms ({by}); "
              "no single library call", flush=True)
        if main is None:
            main = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                        library_ms=None)
        del out, ref, diff
    del m
    # K-uf on the split route (--dtype bfloat16 --max_displacement 0): M of
    # the bf16 phase 1 at each level of a 256^2 plane, batch 256 (the tap
    # solver's n at 256^3), winsize 5, bit for bit against its plain version;
    # timed at level 0, the path's largest call, beside the phase 1 that
    # makes its M (plain PyTorch, as the JAX package's is XLA)
    for size in (256, 128, 64, 32):
        rr = F.poly_expand(t(r.normal(size=(2, 256, size, size)) * 40).to(torch.bfloat16))
        flow = (banded_flow(256, size, size, None, scale=1.5) * (size / 256)
                ).to(torch.bfloat16)
        phase1 = lambda: F.update_matrices_xla(rr[0], rr[1], flow).float().contiguous()
        m = phase1()
        out = F.update_flow(m, 5)
        ref = F.update_flow_plain(m, 5)
        torch.cuda.synchronize()
        require(torch.equal(out, ref), f"K-uf on the split route's M "
                f"(256,5,{size},{size}): not bit-identical to its plain version "
                f"(max abs err {float((out - ref).abs().max())})")
        if size == 256:
            ms = cuda_ms(lambda: F.update_flow(m, 5))
            pms = cuda_ms(lambda: F.update_flow_plain(m, 5), reps=3)
            m1 = cuda_ms(phase1, reps=3)
            bms, by = bound(4 * (m.numel() + out.numel()), uf_flops(5) * (out.numel() // 2))
            main = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                        library_ms=None)
            print(f"[3 kernels] K-uf on the split route's M (256,5,256,256) ws=5: "
                  f"bit-identical, kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
                  f"{bms:.4f} ms ({by}); its bf16 phase 1 (plain PyTorch, bf16 "
                  f"flow) {m1:.4f} ms", flush=True)
        del rr, flow, m, out, ref
    print("[3 kernels] K-uf on the split route's M at every level of the 256^2 "
          "pyramid (256, 128, 64, 32), batch 256: bit-identical", flush=True)
    res["uf"] = dict(max_abs_err=err, **main)
    res.update(split_forms(r, t, banded_flow))
    res.update(packed_forms(r, t, banded_flow, umuf_operands))
    res.update(compose_runs(r, t))
    return res


def split_forms(r, t, banded_flow) -> dict:
    """K-umuf-split (the split route's iterations of a level in one launch)
    against split_iterate_plain at atol 0: at every level of the 256^2 and
    512^2 pyramids, batch 256, from a bf16 and a float32 flow, at the
    planner's k; at the main call also one and two iterations a launch; on
    planes wider than 256 that are no power of 2 (40 x 261, 8 x 1030) at
    k = 1, 2 and 3.  Timed at each level, the main call (256, 5, 256, 256)
    with a float32 flow among them, beside its plain version and its bound
    (36 B a pixel)."""
    from flowdenoising_tpu_torch.ops import farneback as F
    from flowdenoising_tpu_torch.ops.cuda.umuf_split import (
        plan_split, umuf_split_iterate)

    bf16 = torch.bfloat16

    def operands(b, h, w, flow_scale):
        rr = F.poly_expand(t(r.normal(size=(2, b, h, w)) * 40).to(bf16)).contiguous()
        return rr, banded_flow(b, h, w, None, scale=1.5) * flow_scale

    def same(what, rr, flow, ws=5, k=None):
        out = umuf_split_iterate(rr[0], rr[1], flow, 3, ws, k)
        ref = F.split_iterate_plain(rr[0], rr[1], flow, 3, ws)
        torch.cuda.synchronize()
        e = float((out - ref).abs().max())
        require(torch.equal(out, ref), f"K-umuf-split {what}: not bit-identical "
                f"to split_iterate_plain (max abs err {e})")
        return e

    err, main, times = 0.0, None, []
    for size in (512, 256, 128, 64, 32):
        rr, flow = operands(256, size, size, size / 256)
        plan = plan_split(size, size, 5, 3)
        ks = (None, 1, 2) if size == 256 else (None,)
        for dtype in (bf16, torch.float32):
            f = flow.to(dtype)
            for k in ks:
                err = max(err, same(f"(256,5,{size},{size}) {dtype} flow k={k}",
                                    rr, f, k=k))
        fb = flow.to(bf16)
        ms = cuda_ms(lambda: umuf_split_iterate(rr[0], rr[1], flow, 3, 5))
        ms_bf16 = cuda_ms(lambda: umuf_split_iterate(rr[0], rr[1], fb, 3, 5))
        pms = cuda_ms(lambda: F.split_iterate_plain(rr[0], rr[1], flow, 3, 5),
                      reps=2, warmup=1)
        # r0, r1 (bf16) read once, the float32 flow read and written once
        px = flow.numel() // 2
        bnd, by = bound(2 * 2 * rr[0].numel() + 4 * 2 * flow.numel(),
                        3 * umuf_flops(5) * px)
        times.append(f"{size}^2: {ms:.4f} ms (bf16 flow {ms_bf16:.4f}), plain "
                     f"{pms:.4f}, bound {bnd:.4f} ({by})")
        print(f"[3 kernels] K-umuf-split (256,5,{size},{size}) ws=5 iters=3, "
              f"tile {plan.tile_y}x{plan.tile_x}, {plan.threads} threads, "
              f"{plan.smem} B shared, launches {plan.launches}: bit-identical "
              f"from a bf16 and a float32 flow{' at k = 3, 1, 2' if size == 256 else ''}; "
              f"kernel {ms:.4f} ms (float32 flow; bf16 flow {ms_bf16:.4f} ms), plain "
              f"{pms:.4f} ms, bound {bnd:.4f} ms ({by}, 36 B/px)", flush=True)
        if size == 256:
            main = dict(ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by,
                        library_ms=None)
        del rr, flow, fb
    for b, h, w in ((64, 40, 261), (64, 8, 1030)):
        rr, flow = operands(b, h, w, 1.0)
        for dtype in (bf16, torch.float32):
            for k in (1, 2, 3):
                err = max(err, same(f"({b},5,{h},{w}) {dtype} flow k={k}",
                                    rr, flow.to(dtype), k=k))
        del rr, flow
    print(f"[3 kernels] K-umuf-split at every level of the 256^2 and 512^2 "
          f"pyramids (batch 256) and on (64,5,40,261) and (64,5,8,1030) at k = 1, "
          f"2, 3, from bf16 and float32 flows: bit-identical (max_abs_err "
          f"{err:.3g}); times: {'; '.join(times)}", flush=True)
    return {"umuf_split": dict(max_abs_err=err, **main)}


def compose_runs(r, t, n: int = 256) -> dict:
    """K-compose-run and K-compose-run-bf16 (one launch a compose pass)
    against compose_run_plain at atol 0, on 16 planes of n^2 and at the
    main path's pass call (n planes of n^2, ks2 8), timed there beside the
    2*ks2 per-tap K-compose launches it replaced."""
    from flowdenoising_tpu_torch.ops.cuda.compose import (
        compose_run, compose_run_plain, compose_tap)

    bf16 = torch.bfloat16

    def operands(planes, ks2, h, w, symmetric, src):
        """Link stacks (planes + 2*ks2 - 1, scale 0.6), the padded stack
        (planes + 2*ks2, scale ~50), the center accumulator, the weights of
        the taps of sigma ks2/4 (offsets -1 .. -ks2, then +1 .. +ks2)."""
        fwd = t(r.normal(size=(planes + 2 * ks2 - 1, 2, h, w)) * 0.6).to(src)
        bwd = None if symmetric else t(
            r.normal(size=(planes + 2 * ks2 - 1, 2, h, w)) * 0.6).to(src)
        nb = t(r.normal(size=(planes + 2 * ks2, h, w)) * 50).to(src)
        acc = t(r.normal(size=(planes, h, w)) * 20)
        taps = np.exp(-0.5 * (np.arange(-ks2, ks2 + 1) / (ks2 / 4)) ** 2)
        taps /= taps.sum()
        weights = [float(np.float32(taps[ks2 + s * j]))
                   for s in (-1, 1) for j in range(1, ks2 + 1)]
        return fwd, bwd, nb, acc, weights

    def check(what, ops, d, round_carry):
        fwd, bwd, nb, acc, weights = ops
        ref = compose_run_plain(fwd, bwd, nb, acc, weights, d, round_carry)
        out = compose_run(fwd, bwd, nb, acc.clone(), weights, d, round_carry)
        torch.cuda.synchronize()
        e = float((out - ref).abs().max())
        require(torch.equal(out, ref), f"{what}: not bit-identical to "
                f"compose_run_plain (max abs err {e})")
        return e

    def per_tap(ops, d, round_carry):
        """The pass's 2*ks2 per-tap K-compose launches (and the two flow
        resets) that K-compose-run replaces."""
        fwd, bwd, nb, acc, weights = ops
        ks2 = len(weights) // 2
        bwd = -fwd if bwd is None else bwd
        flow = torch.zeros((acc.shape[0], 2) + tuple(acc.shape[1:]),
                           device=acc.device)

        def run():
            for sign, adj, shift in ((-1, bwd, 0), (1, fwd, -1)):
                flow.zero_()
                for j in range(1, ks2 + 1):
                    start = ks2 + sign * j
                    compose_tap(adj, flow, nb, acc, weights[ks2 * (sign > 0) + j - 1],
                                d, start + shift, start, round_carry=round_carry)
        return run

    res, err = {}, {"f32": 0.0, "bf16": 0.0}
    # ks2 8 (sigma 2) runs the two chains side by side, ks2 12 (sigma 3)
    # one after the other
    for ks2 in (8, 12):
        for symmetric in (False, True):
            for d in (8, None):
                for round_carry in (False, True):
                    for src in (torch.float32, bf16):
                        ops = operands(16, ks2, n, n, symmetric, src)
                        form = "bf16" if src == bf16 else "f32"
                        err[form] = max(err[form], check(
                            f"K-compose-run ({form}) (16,{n},{n}) ks2 {ks2} "
                            f"D={d} round_carry={round_carry} "
                            f"symmetric={symmetric}", ops, d, round_carry))
    print(f"[3 kernels] K-compose-run and K-compose-run-bf16 (16,{n},{n}) ks2 8 "
          f"and 12, D 8 and None, round_carry on and off, two link stacks and "
          f"the symmetric sign: bit-identical to compose_run_plain", flush=True)
    # the main path's pass call at 256^3: n 256, ks2 8, 271-plane link
    # stacks, the 272-plane padded stack; float32 as compose mode runs it
    # (two link stacks), bf16 as the fast mode does (symmetric, the carry
    # rounded)
    ks2 = 8
    for form, src, symmetric, round_carry in (("f32", torch.float32, False, False),
                                              ("bf16", bf16, True, True)):
        ops = operands(n, ks2, n, n, symmetric, src)
        fwd, bwd, nb, acc, weights = ops
        name = "compose_run_bf16" if form == "bf16" else "compose_run"
        err[form] = max(err[form], check(f"K-compose-run ({form}) main-path call",
                                         ops, 8, round_carry))
        taps = per_tap(ops, 8, round_carry)
        times = {"run": [], "taps": []}
        for which in ("run", "taps", "taps", "run"):
            fn = (taps if which == "taps" else
                  lambda: compose_run(fwd, bwd, nb, acc, weights, 8, round_carry))
            times[which].append(cuda_ms(fn, reps=5))
        ms = sum(times["run"]) / 2
        tap_ms = sum(times["taps"]) / 2
        pms = cuda_ms(lambda: compose_run_plain(fwd, bwd, nb, acc, weights, 8,
                                                round_carry), reps=1, warmup=1)
        # the center tap the pass puts into the accumulator before the run
        cms = cuda_ms(lambda: (nb[ks2:ks2 + n] * weights[0]).float())
        # each link and neighbour plane read once, the accumulator read and
        # written once; 2*ks2 steps of COMPOSE_FLOPS a pixel
        size = 2 if form == "bf16" else 4
        links = fwd.numel() * (1 if bwd is None else 2)
        bms, by = bound(size * (links + nb.numel()) + 8 * acc.numel(),
                        2 * ks2 * COMPOSE_FLOPS * acc.numel())
        text = "; ".join(f"{k} " + ", ".join(f"{v:.4f}" for v in vs)
                         for k, vs in times.items())
        print(f"[3 kernels] K-compose-run{'-bf16' if form == 'bf16' else ''} "
              f"main-path pass call (n {n}, ks2 {ks2}, {n}^2, D 8, "
              f"{'symmetric, round_carry' if symmetric else 'two link stacks'}, "
              f"stacks {fwd.shape[0]}/{nb.shape[0]}): max_abs_err {err[form]:.3g} "
              f"(bit-identical), kernel {ms:.4f} ms, the {2 * ks2} per-tap "
              f"K-compose launches {tap_ms:.4f} ms ({text}), plain {pms:.4f} ms, "
              f"bound {bms:.4f} ms ({by}); no single library call; the center "
              f"tap before it {cms:.4f} ms", flush=True)
        res[name] = dict(max_abs_err=err[form], ms=ms, plain_ms=pms, bound_ms=bms,
                         bound_by=by, library_ms=None)
        del ops, fwd, bwd, nb, acc
    return res


def pair_ms(f32_fn, bf16_fn, reps: int) -> tuple[float, float, str]:
    """Mean ms of a kernel's float32 and bf16 forms, timed in turns (f32,
    bf16, bf16, f32), and the four times as text."""
    times = {"f32": [], "bf16": []}
    for form in ("f32", "bf16", "bf16", "f32"):
        times[form].append(cuda_ms(f32_fn if form == "f32" else bf16_fn, reps=reps))
    text = "; ".join(f"{k} " + ", ".join(f"{v:.4f}" for v in vs) for k, vs in times.items())
    return sum(times["f32"]) / 2, sum(times["bf16"]) / 2, text


def packed_forms(r, t, banded_flow, umuf_operands) -> dict:
    """The packed forms (--precision bfloat16: the sampling source in
    bfloat16) at the main paths' shapes: each must equal its plain version
    bit for bit; timed beside its float32 form; bound at bf16 source
    width."""
    from flowdenoising_tpu_torch.ops import farneback as F
    from flowdenoising_tpu_torch.ops.cuda.compose import (
        compose_tap, compose_tap_plain)
    from flowdenoising_tpu_torch.ops.cuda.umuf import umuf_iterate

    bf16 = torch.bfloat16
    res = {}

    def same(what, out, ref):
        torch.cuda.synchronize()
        e = float((out - ref).abs().max())
        require(torch.equal(out, ref), f"{what}: not bit-identical to its plain "
                f"version (max abs err {e})")
        return e

    # K-umuf-bf16: the main path's largest call, level 0 of a 256^3 pass;
    # and the float32 form with the bf16 border ramp that a bf16 pass's
    # tiny 32^2 level runs
    rt, ft = umuf_operands(64, 32, 32, 2)
    e_tiny = same("K-umuf 32^2 d=2 with the bf16 ramp",
                  umuf_iterate(rt[0], rt[1], ft, 3, 2, 5, ramp_bf16=True),
                  F.umuf_iterate_plain(rt[0], rt[1], ft, 3, 2, 5, ramp_bf16=True))
    del rt, ft
    rr, flow = umuf_operands(256, 256, 256, 9)
    r1b = rr[1].to(bf16)
    e = same("K-umuf-bf16 (256,5,256,256) d=9",
             umuf_iterate(rr[0], r1b, flow, 3, 9, 5),
             F.umuf_iterate_plain(rr[0], r1b, flow, 3, 9, 5))
    f32_ms, ms, times = pair_ms(lambda: umuf_iterate(rr[0], rr[1], flow, 3, 9, 5),
                                lambda: umuf_iterate(rr[0], r1b, flow, 3, 9, 5), 5)
    pms = cuda_ms(lambda: F.umuf_iterate_plain(rr[0], r1b, flow, 3, 9, 5),
                  reps=2, warmup=1)
    # r0 (float32) and r1 (bf16) read once, the flow read and written once
    px = flow.numel() // 2
    bms, by = bound(4 * (rr[0].numel() + 2 * flow.numel()) + 2 * r1b.numel(),
                    3 * umuf_flops(5) * px)
    print(f"[3 kernels] K-umuf-bf16 main-path call (256,5,256,256) d=9 ws=5 "
          f"iters=3, r1 bf16: max_abs_err {e:.3g} (bit-identical; the float32 "
          f"form with the bf16 ramp at (64,5,32,32) d=2: {e_tiny:.3g}), kernel "
          f"{ms:.4f} ms, float32 form {f32_ms:.4f} ms ({times}), plain "
          f"{pms:.4f} ms, bound {bms:.4f} ms ({by}, 46 B/px)", flush=True)
    del rr, flow, r1b
    # and at every other level call the bf16 paths run packed at 256^3 and
    # 512^3 (batch = the edge, d_k = 9, 5, 3, 2 at D 8) and at the adjacent
    # bound's level 0 (d 5): bit-identical to the plain version
    for b, size, d in ((256, 128, 5), (256, 64, 3), (256, 256, 5), (512, 512, 9),
                       (512, 256, 5), (512, 128, 3), (512, 64, 2), (512, 512, 5)):
        rr, flow = umuf_operands(b, size, size, d)
        r1b = rr[1].to(bf16)
        e = max(e, same(f"K-umuf-bf16 ({b},5,{size},{size}) d={d}",
                        umuf_iterate(rr[0], r1b, flow, 3, d, 5),
                        F.umuf_iterate_plain(rr[0], r1b, flow, 3, d, 5)))
        del rr, flow, r1b
    print(f"[3 kernels] K-umuf-bf16 at the other packed level calls of the "
          f"256^3 and 512^3 paths: bit-identical (max_abs_err {e:.3g})", flush=True)
    res["umuf_bf16"] = dict(max_abs_err=max(e, e_tiny), ms=ms, plain_ms=pms,
                            bound_ms=bms, bound_by=by, library_ms=None)

    # K-compose-bf16: the main path's call at 256^3 (n 256, a 271-plane
    # link stack and the 272-plane padded stack at a mid-run tap's
    # offsets), without and with the bf16 carry rounding of --dtype
    # bfloat16 (the fast mode rounds it)
    n = 256
    link = t(r.normal(size=(n + 15, 2, n, n)) * 0.6)
    nb = t(r.normal(size=(n + 16, n, n)) * 50)
    linkb, nbb = link.to(bf16), nb.to(bf16)
    flow = banded_flow(n, n, n, 8)
    acc = t(r.normal(size=(n, n, n)) * 20)
    wgt = float(np.float32(0.0702))
    # flow and accumulator read and written, n bf16 link planes and n bf16
    # neighbour planes read once
    bms, by = bound(4 * (2 * flow.numel() + 2 * acc.numel())
                    + 2 * (flow.numel() + acc.numel()), COMPOSE_FLOPS * acc.numel())
    err = 0.0
    for round_carry in (False, True):
        fk, ak = flow.clone(), acc.clone()
        compose_tap(linkb, fk, nbb, ak, wgt, 8, 7, 8, round_carry=round_carry)
        fr, ar = compose_tap_plain(linkb[7:7 + n], flow, nbb[8:8 + n], acc, wgt,
                                   8, round_carry)
        what = f"K-compose-bf16 round_carry={round_carry}"
        err = max(err, same(what + " flow", fk, fr), same(what + " acc", ak, ar))
        # the kernels update fk, ak in place on every timed call
        f32_ms, ms, times = pair_ms(
            lambda: compose_tap(link, fk, nb, ak, wgt, 8, 7, 8, round_carry=round_carry),
            lambda: compose_tap(linkb, fk, nbb, ak, wgt, 8, 7, 8,
                                round_carry=round_carry), 10)
        pms = cuda_ms(lambda: compose_tap_plain(linkb[7:7 + n], flow, nbb[8:8 + n],
                                                acc, wgt, 8, round_carry), reps=3)
        print(f"[3 kernels] K-compose-bf16 ({n},{n},{n}) D=8 round_carry="
              f"{round_carry}, link/nb bf16 stacks {n + 15}/{n + 16} at 7/8: "
              f"max_abs_err {err:.3g} (bit-identical), kernel {ms:.4f} ms, float32 "
              f"form {f32_ms:.4f} ms ({times}), plain {pms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}, 30 B/px)", flush=True)
    res["compose_bf16"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                               bound_by=by, library_ms=None)
    del link, nb, linkb, nbb, flow, acc, fk, ak, fr, ar

    # K-um-bf16: the -v 2 reconstruction's call (8, 5, 256, 256) at d 9,
    # and the main shape (256, 5, 256, 256) beside the float32 form's
    rr = F.poly_expand(t(r.normal(size=(2, 256, 256, 256)) * 40)).contiguous()
    err, main = 0.0, None
    for b in (256, 8):
        r0, r1b = rr[0, :b], rr[1, :b].to(bf16)
        flow = banded_flow(b, 256, 256, 9, scale=1.5)
        err = max(err, same(f"K-um-bf16 ({b},5,256,256) d=9",
                            F.update_matrices(r0, r1b, flow, 9),
                            F.update_matrices_plain(r0, r1b, flow, 9)))
        f32_ms, ms, times = pair_ms(lambda: F.update_matrices(r0, rr[1, :b], flow, 9),
                                    lambda: F.update_matrices(r0, r1b, flow, 9), 10)
        pms = cuda_ms(lambda: F.update_matrices_plain(r0, r1b, flow, 9), reps=3)
        # r0 (float32), r1 (bf16) and the flow read once, M written once
        px = flow.numel() // 2
        bms, by = bound(4 * (2 * r0.numel() + flow.numel()) + 2 * r1b.numel(),
                        UM_FLOPS * px)
        print(f"[3 kernels] K-um-bf16 ({b},5,256,256) d=9, r1 bf16: max_abs_err "
              f"{err:.3g} (bit-identical), kernel {ms:.4f} ms, float32 form "
              f"{f32_ms:.4f} ms ({times}), plain {pms:.4f} ms, bound {bms:.4f} ms "
              f"({by}, 58 B/px)", flush=True)
        main = main or dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                            library_ms=None)
    res["um_bf16"] = dict(max_abs_err=err, **main)
    return res


def nonzero(launches: dict) -> dict:
    """The kernel forms a run launched, for printing."""
    return {k: n for k, n in launches.items() if n}


def no_launches() -> dict:
    from flowdenoising_tpu_torch.ops import cuda as K
    return dict.fromkeys(K.LAUNCHES, 0)


def expected_launches(shape, cfg, windows=(1, 1, 1), passes=(0, 1, 2)) -> dict:
    """Launches the tap and level loops imply for one denoise of ``shape``,
    per kernel form: solve mode solves every tap pair and warps with
    K-sample; compose mode solves the adjacent pairs once per direction
    (once with symmetric_adjacent) and runs one K-compose-run per pass.  A
    solve launches K-umuf as its planner plans each pyramid level, in the
    packed form (umuf_bf16) on the levels where the JAX package packs
    (``_packed_at_level``: --precision bfloat16, outside the tiny route).
    K-compose-run runs packed (compose_run_bf16) with --precision bfloat16.
    A bf16 pass with no bound (the split route) launches K-umuf-split as
    its planner plans each level of every solve and no other kernel (its
    warps and compose chain are plain PyTorch); a denoise never launches
    the per-tap K-compose, K-um or K-uf.
    Pass i runs once per window,
    ``windows[i]`` times (slabs, or a stream's windows with the recomputed
    tail); only the passes in ``passes`` run (a resumed run)."""
    from flowdenoising_tpu_torch.kernels import get_gaussian_kernels
    from flowdenoising_tpu_torch.ops.cuda.umuf import plan_umuf
    from flowdenoising_tpu_torch.ops.cuda.umuf_split import plan_split
    from flowdenoising_tpu_torch.ops.farneback import _packed_at_level, split_route
    from flowdenoising_tpu_torch.ops.resize import pyramid_sizes
    planes = [(shape[1], shape[2]), (shape[0], shape[2]), (shape[0], shape[1])]
    f = cfg.flow
    # the adjacent solves' bound in compose mode
    adj = f
    if f.tap_mode == "compose" and None not in (f.max_displacement,
                                                f.adjacent_displacement):
        adj = dataclasses.replace(f, max_displacement=min(
            f.max_displacement, f.adjacent_displacement))
    packed = f.precision == "bfloat16" and f.max_displacement is not None
    compose = "compose_run_bf16" if packed else "compose_run"
    n = no_launches()
    for i, (taps, (h, w)) in enumerate(zip(get_gaussian_kernels(cfg.sigma), planes)):
        if i not in passes:
            continue
        n_taps = len(taps) - 1
        sizes = pyramid_sizes(h, w, f.clamped_levels(h, w), f.pyr_scale)
        solves = ((1 if f.symmetric_adjacent else 2) if f.tap_mode == "compose"
                  else n_taps) * windows[i]
        if split_route(f):
            n["umuf_split"] += solves * sum(
                len(plan_split(hk, wk, f.winsize, f.iterations).launches)
                for hk, wk in sizes)
            continue
        for k, (hk, wk) in enumerate(sizes):
            form = "umuf_bf16" if _packed_at_level(adj, k, hk, wk) else "umuf"
            n[form] += solves * len(plan_umuf(hk, wk, f.winsize,
                                              f.iterations).launches)
        if f.tap_mode == "compose":
            n[compose] += windows[i] if n_taps else 0
        else:
            n["sample"] += n_taps * windows[i]
    return n


def stage_report_launches(shape, cfg) -> dict:
    """Launches of the -v 2 reconstruction of a flow denoise of ``shape``:
    each op is timed as 3 runs (one warm-up, two timed) of _REPS chained
    calls -- the split iteration (K-um, K-uf) at every pyramid level of
    every pass, K-um packed (um_bf16) with --precision bfloat16 and a bound,
    the tap warp (K-sample) once per pass."""
    from flowdenoising_tpu_torch.utils.stage_report import _REPS
    planes = [(shape[1], shape[2]), (shape[0], shape[2]), (shape[0], shape[1])]
    f = cfg.flow
    um = ("um_bf16" if f.precision == "bfloat16" and f.max_displacement is not None
          else "um")
    n = no_launches()
    for h, w in planes:
        levels = f.clamped_levels(h, w) + 1
        n[um] += 3 * _REPS * levels
        n["uf"] += 3 * _REPS * levels
        n["sample"] += 3 * _REPS
    return n


def v2_cost(what: str, vol, cfg) -> None:
    """Print what -v 2's profiling costs the filter phase: a warm denoise
    without and with traced_run, the trace export and the report's parse
    included, and the parse alone."""
    from flowdenoising_tpu_torch.core.pipeline import denoise
    from flowdenoising_tpu_torch.utils import trace_report

    parse = []

    def traced():
        with trace_report.traced_run() as state:
            denoise(vol, cfg)
            torch.cuda.synchronize()
        try:
            t0 = time.perf_counter()
            trace_report.measured_stage_report(state["path"])
            parse.append(time.perf_counter() - t0)
        finally:
            os.remove(state["path"])

    plain_s = wall_s(lambda: denoise(vol, cfg))
    traced_s = wall_s(traced)
    print(f"[4 main] {what} -v 2 profiling cost: warm denoise {plain_s:.3f} s "
          f"without, {traced_s:.3f} s with traced_run (export and parse "
          f"included; the parse {parse[0]:.3f} s)", flush=True)


def wall_s(fn) -> float:
    """Host seconds of one ``fn()`` that ends in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def kernel_family(name: str) -> str:
    """A device kernel's family, for the device-time split."""
    low = name.lower()
    for key, family in (("umuf_split_kernel", "K-umuf-split"),
                        ("compose_run_kernel", "K-compose-run"),
                        ("compose_kernel", "K-compose"), ("umuf_kernel", "K-umuf"),
                        ("uf_kernel", "K-uf"), ("um_kernel", "K-um"),
                        ("sample_kernel", "K-sample"), ("memcpy", "memcpy"),
                        ("memset", "memset"), ("gemm", "matmul (resize einsums)"),
                        ("xmma", "matmul (resize einsums)"),
                        ("cutlass", "matmul (resize einsums)"),
                        ("gather", "gather/index"), ("index", "gather/index"),
                        ("elementwise", "elementwise"), ("reduce", "reductions"),
                        ("copy", "copies"), ("cat", "copies")):
        if key in low:
            return family
    return "other"


def device_split(fn) -> tuple[float, float, list]:
    """torch.profiler over one ``fn()``: (device busy ms, profiled wall ms,
    [(family, ms, launches)] by device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flowdenoising_tpu_torch.ops.farneback import EXPANSION_RANGE, SOLVE_RANGE
    from flowdenoising_tpu_torch.ops.warp import WARP_RANGE

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    fam = {}
    for ev in prof.events():
        # the ranges the port puts around the expansion pyramid and the
        # split route's plain stages also show on the device; they span
        # kernels and are none
        if (ev.device_type != DeviceType.CUDA
                or ev.name in (EXPANSION_RANGE, SOLVE_RANGE, WARP_RANGE)):
            continue
        key = kernel_family(ev.name)
        ms, count = fam.get(key, (0.0, 0))
        fam[key] = (ms + ev.time_range.elapsed_us() / 1e3, count + 1)
    busy = sum(ms for ms, _ in fam.values())
    require(busy > 0, "the profiler recorded no device time")
    return busy, wall, sorted(((k, ms, c) for k, (ms, c) in fam.items()),
                              key=lambda x: -x[1])


PATHS = {
    # name: (CLI flags beyond -s 2 2 2 --max_displacement 8, FlowConfig
    # fields, noise std); --flow_presmooth auto is resolved from the volume.
    # Noise std 40 against blob amplitudes 50-200 puts the input near 21 dB,
    # where the 3-pass sigma-2 filter gains clearly (+6-7 dB at 48^3 on the
    # CPU path); the presmooth policy reads rel 0.455 there, on the edge of
    # its 0.45 threshold, so its path gets std 60 (rel 0.68 at 256^3), where
    # presmooth must come on.
    "solve": ([], {}, 40.0),
    "compose": (["--tap_flow", "compose"], {"tap_mode": "compose"}, 40.0),
    "compose_symmetric": (["--tap_flow", "compose", "--symmetric_adjacent"],
                          {"tap_mode": "compose", "symmetric_adjacent": True}, 40.0),
    "presmooth_auto": (["--flow_presmooth", "auto"], {}, 60.0),
    # the bf16 fast mode (after the float32 path each is compared with)
    "solve_bf16": (["--dtype", "bfloat16", "--precision", "bfloat16"],
                   {"dtype": "bfloat16", "precision": "bfloat16"}, 40.0),
    "fast": (["--tap_flow", "compose", "--symmetric_adjacent", "--dtype",
              "bfloat16", "--precision", "bfloat16"],
             {"tap_mode": "compose", "symmetric_adjacent": True,
              "dtype": "bfloat16", "precision": "bfloat16"}, 40.0),
    # the bf16 pass with no bound (the split route: K-umuf-split, the exact
    # gather in bf16); --max_displacement 0 after the 8 above wins
    "solve_bf16_nobound": (["--dtype", "bfloat16", "--max_displacement", "0"],
                           {"dtype": "bfloat16", "max_displacement": None}, 40.0),
    "fast_nobound": (["--tap_flow", "compose", "--symmetric_adjacent", "--dtype",
                      "bfloat16", "--precision", "bfloat16", "--max_displacement",
                      "0"],
                     {"tap_mode": "compose", "symmetric_adjacent": True,
                      "dtype": "bfloat16", "precision": "bfloat16",
                      "max_displacement": None}, 40.0),
}
# each bf16 path's float32 counterpart in PATHS
FLOAT32_OF = {"solve_bf16": "solve", "fast": "compose_symmetric"}
# the no-bound paths: compared with the same flags at float32, a warm
# denoise (not a CLI run) of the config with dtype and precision float32
FLOAT32_FIELDS = ("solve_bf16_nobound", "fast_nobound")
# paths run with -v 2 and the measured report read as empty, so the CLI
# runs the reconstructed stage report (K-um, K-uf, K-sample) on the card
V2_FALLBACK = ("solve_bf16",)
# paths run with -v 2 and their measured report checked; those also in
# V2_FALLBACK_AFTER run the CLI a second time with the trace read as empty
V2_MEASURED = ("solve_bf16_nobound", "fast_nobound")
V2_FALLBACK_AFTER = ("solve_bf16_nobound",)
# paths with a torch.profiler device-time split of their warm denoise
SPLIT = ("solve", "compose", "solve_bf16", "fast", "solve_bf16_nobound",
         "fast_nobound")


def phase_main(dev, size: int, seed: int) -> tuple[dict, dict]:
    """Every path of PATHS through the CLI, then warm; then the auto_v2
    path.  Returns each path's launch counts, and the -v 2 reconstruction's
    as "stage_report", and each path's CLI output."""
    from flowdenoising_tpu_torch import cli
    from flowdenoising_tpu_torch.config import FilterConfig, FlowConfig
    from flowdenoising_tpu_torch.core import memory
    from flowdenoising_tpu_torch.core.noise import resolve_auto_presmooth
    from flowdenoising_tpu_torch.core.pipeline import denoise
    from flowdenoising_tpu_torch.io.mrc import read_mrc, write_mrc
    from flowdenoising_tpu_torch.kernels import get_gaussian_kernels
    from flowdenoising_tpu_torch.utils import trace_report

    clean = blob_volume(size, size, size, seed)
    inputs = {}
    measure = trace_report.measured_stage_report

    def noisy_input(std):
        """(noisy volume, its MRC file) at noise ``std``, made once."""
        if std not in inputs:
            vol = clean + np.random.default_rng(seed + 1).normal(
                0.0, std, clean.shape).astype(np.float32)
            path = Path(tmp) / f"noisy_{std:g}.mrc"
            write_mrc(path, vol)
            inputs[std] = vol, path
        return inputs[std]

    counts, outputs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (flags, fields, std) in PATHS.items():
            noisy, src = noisy_input(std)
            p_in = psnr(noisy, clean)
            # sigma 2, wrap, D = 8, float32 unless the path says bfloat16
            cfg = FilterConfig(flow=FlowConfig(**fields))
            if "--flow_presmooth" in flags:
                cfg = resolve_auto_presmooth(noisy, cfg)
                require(cfg.flow.presmooth > 0, f"{name}: the noise policy left "
                        f"presmooth off at noise std {std}")
            dst = Path(tmp) / f"denoised_{name}.mrc"
            args = ["-i", str(src), "-o", str(dst), "-s", "2", "2", "2",
                    "--max_displacement", "8", *flags]
            want = expected_launches(clean.shape, cfg)
            measured = []
            if name in V2_FALLBACK:
                rc, cold, launches = cli_v2(
                    [*args, "-v", "2"],
                    {(trace_report, "measured_stage_report"): lambda path: None})
                report = stage_report_launches(clean.shape, cfg)
                want = {k: n + report[k] for k, n in want.items()}
            elif name in V2_MEASURED:
                def capture(path):
                    measured.append(measure(path))
                    return measured[-1]

                rc, cold, launches = cli_v2(
                    [*args, "-v", "2"],
                    {(trace_report, "measured_stage_report"): capture})
            else:
                rc, cold, launches = cli_v2([*args, "-v", "1"], {})
            require(rc == 0, f"{name}: cli.main returned {rc}")
            out, _ = read_mrc(dst)
            require(launches == want,
                    f"{name}: launch counts {launches}, expected {want}")
            if name in V2_MEASURED:
                require(len(measured) == 1 and measured[0] is not None,
                        f"{name}: the CLI logged no measured stage report")
                # the compose chain's warps are its OFE_solve
                keys = ["OFE_solve", "OFE_expansion"]
                if cfg.flow.tap_mode == "solve":
                    keys.append("warping")
                for key in keys:
                    require(measured[0][key] > 0, f"{name}: measured {key} is 0")
                print(f"[4 main] {size}^3 {name} -v 2 measured stage split, ms: "
                      + "; ".join(f"{k} {1e3 * v:.1f}" for k, v in measured[0].items()),
                      flush=True)
            if (cfg.flow.precision == "bfloat16" and cfg.flow.max_displacement
                    is not None and size in (256, 512)):
                # packed levels on K-umuf-bf16; at 256^3 the tiny coarsest
                # level (32^2, d 2) on float32 K-umuf; at 512^3 the coarsest
                # level is 64^2, and every level is packed
                require(launches["umuf_bf16"] > 0 and (launches["umuf"] > 0)
                        == (size == 256), f"{name}: K-umuf launches by form "
                        f"{launches['umuf']} float32, {launches['umuf_bf16']} bf16")
            outputs[name] = out
            require(out.shape == clean.shape, f"{name}: output shape {out.shape}")
            require(bool(np.isfinite(out).all()), f"{name}: non-finite output")
            p_out = psnr(out, clean)
            require(p_out > p_in, f"{name}: PSNR vs clean {p_out:.2f} dB <= "
                    f"input's {p_in:.2f} dB")

            vol = torch.from_numpy(noisy).to(dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            warm = denoise(vol, cfg)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            # the model's peak of this whole-axis denoise, the input held
            model = memory.denoise_peak_bytes(
                cfg, clean.shape, [len(k) // 2 for k in get_gaussian_kernels(cfg.sigma)])
            require(peak <= model, f"{name}: peak device memory {peak} B above "
                    f"the memory model's {model} B")
            rerun = float(np.abs(warm.cpu().numpy() - out).max())
            # the kernels are deterministic, and the CLI resolves the same
            # config (presmooth included) from the same volume
            require(rerun == 0, f"{name}: warm denoise differs from the CLI's "
                    f"output by {rerun}")
            against = ""
            if name in FLOAT32_OF:
                against = (f"; PSNR against the float32 path "
                           f"{FLOAT32_OF[name]}: {psnr(out, outputs[FLOAT32_OF[name]]):.2f} dB")
            if name in FLOAT32_FIELDS:
                f32 = denoise(vol, dataclasses.replace(cfg, flow=dataclasses.replace(
                    cfg.flow, dtype="float32", precision="float32"))).cpu().numpy()
                against = (f"; PSNR against the same flags at float32: "
                           f"{psnr(out, f32):.2f} dB")
                del f32
            print(f"[4 main] {size}^3 CLI {name} denoise (sigma 2, D="
                  f"{cfg.flow.max_displacement or 'none'}, wrap, "
                  f"noise std {std:g}, presmooth {cfg.flow.presmooth}, dtype "
                  f"{cfg.flow.dtype}, precision {cfg.flow.precision}): "
                  f"launches {launches} as expected; PSNR vs clean {p_in:.2f} -> "
                  f"{p_out:.2f} dB{against}; CLI run {cold:.2f} s (cold, incl. I/O"
                  f"{', -v 2 profiling and reconstruction' if name in V2_FALLBACK else ''}); "
                  f"warm denoise {secs:.3f} s = {clean.size / secs / 1e6:.2f} "
                  f"Mvoxel/s; peak device memory {peak / 2**30:.3f} GiB (model "
                  f"{model / 2**30:.3f}); warm vs CLI "
                  f"output max abs diff {rerun:.3g}", flush=True)
            if name in V2_MEASURED:
                v2_cost(f"{size}^3 {name}", vol, cfg)
            if name in SPLIT:
                busy, wall, fams = device_split(lambda: denoise(vol, cfg))
                split = "; ".join(f"{k} {ms:.1f} ms ({100 * ms / busy:.1f}%, {c})"
                                  for k, ms, c in fams)
                print(f"[4 main] {size}^3 {name} device-time split (torch.profiler, "
                      f"one warm denoise): busy {busy:.1f} ms of {wall:.1f} ms "
                      f"profiled wall (idle {100 * (1 - busy / wall):.1f}%): {split}",
                      flush=True)
            del vol, warm
            counts[name] = launches
            if name in V2_FALLBACK_AFTER:
                # -v 2 once more with the trace read as empty: the CLI's
                # fallback, the reconstruction (K-um, K-uf, K-sample)
                dst2 = Path(tmp) / f"denoised_{name}_recon.mrc"
                rc, cold2, rlaunch = cli_v2(
                    [*args[:3], str(dst2), *args[4:], "-v", "2"],
                    {(trace_report, "measured_stage_report"): lambda path: None})
                report = stage_report_launches(clean.shape, cfg)
                want2 = {k: n + report[k] for k, n in want.items()}
                require(rc == 0 and rlaunch == want2, f"{name} reconstruction run: "
                        f"rc {rc}, launches {rlaunch}, expected {want2}")
                same2 = np.array_equal(read_mrc(dst2)[0], out)
                require(same2, f"{name}: the reconstruction run's output differs")
                print(f"[4 main] {size}^3 CLI {name} -v 2 with the trace read as "
                      f"empty: the reconstructed stage report ran on the card, "
                      f"launches {nonzero(rlaunch)} = the denoise's + the "
                      f"reconstruction's {nonzero(report)}; same output; CLI run "
                      f"{cold2:.2f} s", flush=True)
        noisy, src = noisy_input(40.0)
        counts["auto_v2"], counts["stage_report"] = path_auto_v2(
            dev, Path(tmp), src, clean, noisy)
    return counts, outputs


def cli_v2(args: list, report_hooks: dict) -> tuple[int, float, dict]:
    """``cli.main(args)`` with launch counts set to 0 just before it and
    read just after, and the -v 2 report functions of ``report_hooks``
    ({(module, name): replacement}) in place while it runs.  The run must
    read and write its MRC files through the native runtime (libfdio), not
    the NumPy path.  Returns (exit code, seconds, launches)."""
    from flowdenoising_tpu_torch import cli, runtime
    from flowdenoising_tpu_torch.ops import cuda as K

    saved = {key: getattr(*key) for key in report_hooks}
    for (module, name), fn in report_hooks.items():
        setattr(module, name, fn)
    K.reset_launches()
    runtime.reset_native_calls()
    t0 = time.perf_counter()
    try:
        rc = cli.main(args)
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)
    secs = time.perf_counter() - t0
    native = dict(runtime.NATIVE_CALLS)
    require(native["read_convert"] >= 1 and native["write_raw"] >= 1,
            f"cli {args}: native I/O calls {native}: the run read or wrote "
            "through the NumPy path")
    return rc, secs, dict(K.LAUNCHES)


def path_auto_v2(dev, tmp: Path, src: Path, clean, noisy):
    """The CLI's default flow setup with -v 2 (no --max_displacement: the
    auto probe picks the bound), twice: once with its measured stage report,
    once with the trace read as empty, which sends the CLI to its fallback,
    the reconstructed report (K-um, K-uf) on the card.  Between the two, the
    cost of the profiling.  Returns (the first run's launches, the
    second's)."""
    from flowdenoising_tpu_torch.config import FilterConfig, FlowConfig
    from flowdenoising_tpu_torch.core.autodisp import probe_displacement
    from flowdenoising_tpu_torch.io.mrc import read_mrc
    from flowdenoising_tpu_torch.ops import cuda as K
    from flowdenoising_tpu_torch.utils import stage_report, trace_report

    size = clean.shape[0]
    # the probe alone first, for its launches and seconds (the CLI's probe
    # sees the same volume, through the MRC file, and the same defaults)
    picked = []
    K.reset_launches()
    probe_s = wall_s(lambda: picked.append(
        probe_displacement(noisy, FilterConfig(), device=dev)))
    probe = dict(K.LAUNCHES)
    (max_d, adj_d), = picked
    cfg = FilterConfig(flow=FlowConfig(max_displacement=max_d,
                                       adjacent_displacement=adj_d))
    args = ["-i", str(src), "-s", "2", "2", "2", "-v", "2"]
    p_in = psnr(noisy, clean)

    def check_output(dst, run):
        out, _ = read_mrc(dst)
        require(out.shape == clean.shape and bool(np.isfinite(out).all()),
                f"{run}: output shape or non-finite values")
        p_out = psnr(out, clean)
        require(p_out > p_in, f"{run}: PSNR vs clean {p_out:.2f} dB <= input's "
                f"{p_in:.2f} dB")
        return out, p_out

    # run 1: the measured report, captured on the way out
    reports, recons = [], []
    measured_stage_report = trace_report.measured_stage_report
    device_stage_report = stage_report.device_stage_report

    def capture(path):
        reports.append(measured_stage_report(path))
        return reports[-1]

    dst = tmp / "denoised_auto_v2.mrc"
    rc, cold, launches = cli_v2(
        [*args, "-o", str(dst)],
        {(trace_report, "measured_stage_report"): capture})
    require(rc == 0, f"auto_v2: cli.main returned {rc}")
    want = {k: probe[k] + n for k, n in expected_launches(clean.shape, cfg).items()}
    require(launches == want, f"auto_v2: launch counts {launches}, expected "
            f"{want} (probe {probe} + the denoise at D={max_d})")
    out, p_out = check_output(dst, "auto_v2")
    require(len(reports) == 1 and reports[0] is not None,
            "auto_v2: the CLI logged no measured stage report")
    measured = reports[0]
    for key in ("OFE_solve", "warping", "OFE_expansion"):
        require(measured[key] > 0, f"auto_v2: measured {key} is 0: the trace's "
                "kernels were not classified")
    print(f"[4 main] {size}^3 CLI auto_v2 (default flow setup, -v 2): probe picked "
          f"max_displacement={max_d}, adjacent_displacement={adj_d} in "
          f"{probe_s:.3f} s (probe launches {probe}); CLI launches {launches} = "
          f"probe + denoise as expected; PSNR vs clean {p_in:.2f} -> {p_out:.2f} dB; "
          f"CLI run {cold:.2f} s (cold, incl. I/O, probe, profiling)", flush=True)

    vol = torch.from_numpy(noisy).to(dev)
    v2_cost(f"{size}^3", vol, cfg)
    del vol

    # run 2: the trace read as empty, as on a CPU run, so the CLI falls back
    # to the reconstruction on the card: K-um + K-uf at every level,
    # K-sample per pass
    def timed_recon(*a, **kw):
        t0 = time.perf_counter()
        recons.append(device_stage_report(*a, **kw))
        torch.cuda.synchronize()
        recons.append(time.perf_counter() - t0)
        return recons[0]

    dst = tmp / "denoised_auto_v2_recon.mrc"
    rc, cold2, rlaunch = cli_v2(
        [*args, "-o", str(dst)],
        {(trace_report, "measured_stage_report"): lambda path: None,
         (stage_report, "device_stage_report"): timed_recon})
    require(rc == 0, f"auto_v2 reconstruction run: cli.main returned {rc}")
    require(len(recons) == 2, "auto_v2 reconstruction run: the CLI did not "
            "fall back to the reconstructed stage report")
    recon, recon_s = recons
    report_n = stage_report_launches(clean.shape, cfg)
    want = {k: probe[k] + n + report_n[k]
            for k, n in expected_launches(clean.shape, cfg).items()}
    require(rlaunch == want, f"auto_v2 reconstruction run: launch counts {rlaunch}, "
            f"expected {want} (probe + denoise + the reconstruction's {report_n})")
    if size == 256:
        require(rlaunch["um"] == rlaunch["uf"] == 144,
                f"stage report at 256^3: {rlaunch['um']} K-um, {rlaunch['uf']} K-uf")
    out2, _ = check_output(dst, "auto_v2 reconstruction run")
    require(bool((out2 == out).all()), "auto_v2: the two CLI runs' outputs differ")
    keys = sorted(set(measured) | set(recon))
    table = "; ".join(f"{k} {1e3 * measured[k]:.1f}" if k in measured else f"{k} --"
                      for k in keys)
    table2 = "; ".join(f"{k} {1e3 * recon[k]:.1f}" if k in recon else f"{k} --"
                       for k in keys)
    print(f"[4 main] {size}^3 stage split, ms: measured (trace of the first CLI "
          f"run): {table}; reconstructed (the second CLI run's fallback, per-op "
          f"timings, OFE_solve = split K-um + K-uf): {table2}; reconstruction "
          f"took {recon_s:.2f} s of that run's {cold2:.2f} s; its launches "
          f"{rlaunch} = probe + denoise + reconstruction as expected; same "
          "output as the first run", flush=True)
    return launches, rlaunch


def phase_e2e(dev, seed: int) -> None:
    from flowdenoising_tpu_torch.config import FilterConfig, FlowConfig
    from flowdenoising_tpu_torch.core.pipeline import denoise

    vol = blob_volume(24, 96, 96, seed + 2)
    vol += np.random.default_rng(seed + 3).normal(0, 20, vol.shape).astype(np.float32)
    fast = dict(dtype="bfloat16", precision="bfloat16")
    nobound = dict(dtype="bfloat16", max_displacement=None)
    for name, fields in (
            ("solve", {}), ("compose", {"tap_mode": "compose"}),
            ("solve presmooth 1.5", {"presmooth": 1.5}), ("solve_bf16", fast),
            ("fast", {"tap_mode": "compose", "symmetric_adjacent": True, **fast}),
            ("solve_bf16_nobound", nobound),
            ("fast_nobound", {"tap_mode": "compose", "symmetric_adjacent": True,
                              **fast, **nobound})):
        cfg = FilterConfig(flow=FlowConfig(**fields))
        on_card = denoise(vol, cfg, device=dev).cpu().numpy()
        on_cpu = denoise(vol, cfg, device="cpu").numpy()
        p = psnr(on_card, on_cpu)
        require(p >= 55.0, f"{name}: card vs CPU PSNR {p:.2f} dB < 55")
        same = "bit-identical" if np.array_equal(on_card, on_cpu) else "not bit-identical"
        # the compose passes: K-compose-run on the card, its plain chain of
        # steps on the CPU; the no-bound paths: K-umuf-split against its
        # plain version and the same plain PyTorch gathers on both
        require(same == "bit-identical" or name not in (
            "compose", "fast", "solve_bf16_nobound", "fast_nobound"),
                f"{name}: the card's output is not the CPU's bit for bit")
        print(f"[5 e2e] 24x96x96 {name} denoise, card (kernels) vs CPU (plain): "
              f"PSNR {p:.2f} dB (bar 55), {same}; max abs diff "
              f"{float(np.abs(on_card - on_cpu).max()):.3g}", flush=True)


def host_rss() -> int | None:
    """This process's resident host memory in bytes (/proc/self/statm),
    None where the system does not say."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return None


class RssPeak:
    """The peak of ``host_rss`` above its value at entry, sampled every
    10 ms by a thread while the block runs (``rise``: bytes, or None)."""

    def __enter__(self):
        import threading
        self.base = host_rss()
        self.top = self.base
        self.stop = threading.Event()

        def sample():
            while not self.stop.wait(0.01):
                now = host_rss()
                if now is not None and self.top is not None:
                    self.top = max(self.top, now)

        self.thread = threading.Thread(target=sample, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=5)
        self.rise = None if self.base is None else self.top - self.base
        return False

    def text(self) -> str:
        return ("not measured" if self.rise is None
                else f"{self.rise / 2**30:.3f} GiB")


class Interrupted(Exception):
    """Raised by a hook to stop a CLI run part-way, as a crash would."""


def cli_run(args: list, hooks: dict) -> tuple[float, dict, int]:
    """``cli.main(args)`` in this process with ``hooks`` ({(module, name):
    replacement}) in place and the launch counts and the device memory peak
    reset just before it: (seconds, launches, peak device bytes).  A run a
    hook interrupts returns what it launched before."""
    from flowdenoising_tpu_torch import cli
    from flowdenoising_tpu_torch.ops import cuda as K

    saved = {key: getattr(*key) for key in hooks}
    for (module, name), fn in hooks.items():
        setattr(module, name, fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    try:
        require(cli.main(args) == 0, f"cli.main {args} failed")
    except Interrupted:
        pass
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, dict(K.LAUNCHES), torch.cuda.max_memory_allocated()


def phase_stream(dev, shape, seed: int, main_outputs=None) -> None:
    """6 stream: the streamed CLI (--stream), the checkpoint resume and
    denoise_many on the seeded blob volume of ``shape`` with noise std 40,
    sigma 2, D 8, wrap, each bit-identical to the in-memory output of the
    same path, with the launch counts its windows imply; then the device
    memory peaks against core/memory.py's model, and an in-memory denoise
    that the model, given a small budget, splits into >= 3 slabs a pass."""
    from flowdenoising_tpu_torch.config import Boundary, FilterConfig, FlowConfig
    from flowdenoising_tpu_torch.core import memory
    from flowdenoising_tpu_torch.core.pipeline import denoise, denoise_many
    from flowdenoising_tpu_torch.core.stream import denoise_streamed
    from flowdenoising_tpu_torch.io import volume as volume_io
    from flowdenoising_tpu_torch.io.mrc import read_mrc, write_mrc
    from flowdenoising_tpu_torch.kernels import get_gaussian_kernels
    from flowdenoising_tpu_torch.ops import cuda as K
    from flowdenoising_tpu_torch.utils import checkpoint

    tag = "x".join(map(str, shape))
    clean = blob_volume(*shape, seed)
    # the noisy volume of phase 4 (noise seed + 1), and two more for the batch
    vols = [clean + np.random.default_rng(s).normal(0.0, 40.0, shape).astype(np.float32)
            for s in (seed + 1, seed + 11, seed + 21)]
    noisy = vols[0]
    del clean
    ks2s = [len(k) // 2 for k in get_gaussian_kernels((2.0, 2.0, 2.0))]
    passes = [(shape[0], shape[1], shape[2]), (shape[1], shape[0], shape[2]),
              (shape[2], shape[0], shape[1])]
    slab = 3 * min(shape) // 10
    slab_windows = tuple(-(-n // slab) for n, _, _ in passes)
    cfgs = {"solve": FilterConfig(flow=FlowConfig()),
            "compose": FilterConfig(flow=FlowConfig(tap_mode="compose")),
            "mean": FilterConfig(boundary=Boundary.MEAN, flow=FlowConfig()),
            "solve_bf16_nobound": FilterConfig(flow=FlowConfig(
                dtype="bfloat16", max_displacement=None))}

    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "noisy.mrc"
        write_mrc(src, noisy)
        base = ["-i", str(src), "-s", "2", "2", "2", "--max_displacement", "8"]
        path_flags = {"solve": [], "compose": ["--tap_flow", "compose"],
                      "mean": ["--boundary", "mean"],
                      "solve_bf16_nobound": ["--dtype", "bfloat16",
                                             "--max_displacement", "0"]}

        def output(name):
            """A run's output, read and its file removed (disk space)."""
            path = Path(tmp) / f"{name}.mrc"
            data, _ = read_mrc(path)
            path.unlink()
            return np.asarray(data)

        def same(name, out, ref, what):
            require(out.shape == ref.shape and bool(np.isfinite(out).all()),
                    f"{name}: output shape {out.shape} or non-finite values")
            diff = float(np.abs(out - ref).max())
            require(np.array_equal(out, ref), f"{name}: not bit-identical to "
                    f"{what} (max abs diff {diff})")

        # the in-memory references
        ref, walls = {}, {}
        for name in ("solve", "compose", "mean"):
            with RssPeak() as rss:
                secs, launches, peak = cli_run(
                    [*base, *path_flags[name], "-o", str(Path(tmp) / f"mem_{name}.mrc")],
                    {})
            want = expected_launches(shape, cfgs[name])
            require(launches == want, f"in-memory {name}: launches {launches}, "
                    f"expected {want}")
            ref[name] = output(f"mem_{name}")
            walls[name] = secs
            if name == "solve":
                mem_peak, mem_rss = peak, rss
        for name in ("solve", "compose"):
            if main_outputs is not None:
                same(name, ref[name], main_outputs[name], "phase 4's CLI output")
        print(f"[6 stream] {tag} in-memory CLI references: solve {walls['solve']:.2f} s "
              f"(peak device memory {mem_peak / 2**30:.3f} GiB, host RSS rise "
              f"{mem_rss.text()}), compose {walls['compose']:.2f} s, mean "
              f"{walls['mean']:.2f} s; launches as expected", flush=True)

        # stream, auto slab: the model gives the whole axis at these sizes
        budget = memory.device_budget(dev)
        auto = tuple(-(-n // (memory.pass_slab(cfgs["solve"], n, h, w, k, budget,
                                              streamed=True) or n))
                     for (n, h, w), k in zip(passes, ks2s))
        with RssPeak() as rss:
            secs, launches, peak = cli_run(
                [*base, "--stream", "-o", str(Path(tmp) / "stream.mrc")], {})
        want = expected_launches(shape, cfgs["solve"], auto)
        require(launches == want, f"stream: launches {launches}, expected {want} "
                f"(windows {auto})")
        same("stream", output("stream"), ref["solve"], "the in-memory CLI output")
        model = max(memory.window_peak_bytes(cfgs["solve"], n, h, w, k, None,
                                             streamed=True)
                    for (n, h, w), k in zip(passes, ks2s))
        require(peak <= model, f"stream: peak {peak} B above the model's {model} B")
        import resource
        maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        print(f"[6 stream] {tag} stream (--stream, auto slab): windows a pass "
              f"{auto}; bit-identical to the in-memory output; launches "
              f"{nonzero(launches)} as expected; CLI {secs:.2f} s against in-memory "
              f"{walls['solve']:.2f} s; peak device memory {peak / 2**30:.3f} GiB "
              f"(model {model / 2**30:.3f}); host RSS rise {rss.text()} (in-memory "
              f"{mem_rss.text()}; this process's peak RSS so far, getrusage: "
              f"{maxrss / 2**30:.3f} GiB)", flush=True)

        # streams with slab S: 4 windows a pass at a cube, a shifted tail
        def streamed(run, name, extra):
            dst = Path(tmp) / f"{run}.mrc"
            secs, launches, peak = cli_run(
                [*base, *path_flags[name], "--stream", "--slab_size", str(slab),
                 *extra, "-o", str(dst)], {})
            want = expected_launches(shape, cfgs[name], slab_windows)
            require(launches == want, f"{run}: launches {launches}, expected {want}")
            same(run, output(run), ref[name], f"the in-memory {name} CLI output")
            model = max(memory.window_peak_bytes(cfgs[name], n, h, w, k, slab,
                                                 streamed=True)
                        for (n, h, w), k in zip(passes, ks2s))
            require(peak <= model, f"{run}: peak {peak} B above the model's {model} B")
            against = (f"in-memory {walls[name]:.2f} s" if name in walls
                       else "phase 4's in-memory CLI output")
            print(f"[6 stream] {tag} {run} (--stream --slab_size {slab}"
                  f"{' ' + ' '.join(path_flags[name]) if path_flags[name] else ''}): "
                  f"windows a pass {slab_windows}; bit-identical to the in-memory "
                  f"output; launches {nonzero(launches)} as expected; CLI {secs:.2f} s against "
                  f"{against}; peak device memory "
                  f"{peak / 2**30:.3f} GiB (model {model / 2**30:.3f})", flush=True)

        streamed("stream_slabs", "solve", [])
        streamed("stream_slabs_again", "solve", [])
        streamed("stream_compose", "compose", [])
        streamed("stream_mean", "mean", [])
        if main_outputs is not None:
            # the bf16 pass with no bound, against phase 4's CLI output of
            # the same volume (not run with --stream_shape)
            ref["solve_bf16_nobound"] = main_outputs["solve_bf16_nobound"]
            streamed("stream_bf16_nobound", "solve_bf16_nobound", [])

        # the overlap: the library stream with it off and on, in turns
        mapped = volume_io.read_volume(src, memory_map=True)
        times = {False: [], True: []}
        for overlap in (False, True, True, False):
            res = []
            times[overlap].append(wall_s(lambda: res.append(denoise_streamed(
                mapped, cfgs["solve"], slab_size=slab, tmp_dir=tmp,
                overlap=overlap, device=dev))))
            same(f"stream overlap={overlap}", res[0], ref["solve"],
                 "the in-memory CLI output")
            del res
        del mapped
        print(f"[6 stream] {tag} denoise_streamed (S {slab}, solve) with the overlap "
              f"off: {', '.join(f'{t:.3f}' for t in times[False])} s; on: "
              f"{', '.join(f'{t:.3f}' for t in times[True])} s (in turns); "
              "bit-identical to the in-memory output", flush=True)

        # resume: stopped after pass 1's checkpoint, then after pass 2's
        # (the output's write fails), then the finished volume
        ck = Path(tmp) / "ck"
        dst = Path(tmp) / "resume.mrc"
        args = [*base, "--checkpoint_dir", str(ck), "-o", str(dst)]
        save_pass = checkpoint.CheckpointManager.save_pass

        def stop_after_pass_1(self, i, vol):
            save_pass(self, i, vol)
            if i == 1:
                raise Interrupted

        def failed_write(*a, **kw):
            raise Interrupted

        runs = []
        for hooks in ({(checkpoint.CheckpointManager, "save_pass"): stop_after_pass_1},
                      {(volume_io, "write_volume"): failed_write}, {}):
            runs.append(cli_run(args, hooks))
        cfg = cfgs["solve"]
        for (secs, launches, _), want, what in zip(
                runs, (expected_launches(shape, cfg, passes=(0, 1)),
                       expected_launches(shape, cfg, passes=(2,)), no_launches()),
                ("passes 0-1, stopped", "resumed at pass 2", "finished volume")):
            require(launches == want, f"resume ({what}): launches {launches}, "
                    f"expected {want}")
        same("resume", output("resume"), ref["solve"], "the in-memory CLI output")
        require(not any(ck.iterdir()), "resume: the checkpoint was not cleared")
        print(f"[6 stream] {tag} resume (--checkpoint_dir): run 1 stopped after "
              f"pass 1's checkpoint ({runs[0][0]:.2f} s, {nonzero(runs[0][1])}), run 2 resumed "
              f"at pass 2 and stopped in the write ({runs[1][0]:.2f} s, {nonzero(runs[1][1])}: "
              f"one pass), run 3 wrote the finished volume ({runs[2][0]:.2f} s, "
              "no launch); bit-identical to the in-memory output; checkpoint "
              "cleared", flush=True)

        # batch: three volumes (noise under three seeds), window 2
        singles, single_s = [], []
        for v in vols:
            t = torch.from_numpy(v).to(dev)
            single_s.append(wall_s(lambda: singles.append(denoise(t, cfg).cpu().numpy())))
            del t
        same("batch reference", singles[0], ref["solve"], "the in-memory CLI output")
        for to_host in (False, True):
            res = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launches()
            secs = wall_s(lambda: res.extend(denoise_many(
                iter(vols), cfg, window=2, to_host=to_host, device=dev)))
            launches = dict(K.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            want = {k: 3 * n for k, n in expected_launches(shape, cfg).items()}
            require(launches == want, f"batch to_host={to_host}: launches {launches}, "
                    f"expected {want}")
            for j, (out, single) in enumerate(zip(res, singles)):
                out = out if to_host else out.cpu().numpy()
                require(isinstance(res[j], np.ndarray) == to_host,
                        f"batch to_host={to_host}: result type {type(res[j])}")
                same(f"batch to_host={to_host} volume {j}", out, single,
                     "a single denoise")
            del res
            print(f"[6 stream] {tag} batch (denoise_many, 3 volumes, window 2, "
                  f"to_host={to_host}): each bit-identical to a single denoise (the "
                  f"first to the in-memory CLI output); launches {nonzero(launches)} = 3 "
                  f"denoises; {secs / 3:.3f} s a volume against a warm single denoise "
                  f"{min(single_s):.3f} s; peak device memory {peak / 2**30:.3f} GiB",
                  flush=True)
        del singles, vols[1:]

    phase_memory(dev, cfgs["solve"], noisy, ks2s, ref["solve"], seed)


# the in-memory denoises whose device memory peaks are held to the model:
# PERF.md's two sizes, and two other aspect ratios
MEMORY_SHAPES = ((256, 256, 256), (512, 512, 512), (384, 512, 512),
                 (128, 1024, 1024))


def phase_memory(dev, cfg, noisy, ks2s, ref, seed: int) -> None:
    """Peaks of in-memory denoises (solve, D 8, the input held) against the
    memory model at the sizes of PERF.md and other aspect ratios; then a
    denoise of ``noisy`` with the budget forced small, so the model splits
    each pass into >= 3 slabs, bit-identical to the whole axis (``ref``)."""
    from flowdenoising_tpu_torch.core import memory
    from flowdenoising_tpu_torch.core.pipeline import denoise
    from flowdenoising_tpu_torch.ops import cuda as K

    lines = []
    for vshape in MEMORY_SHAPES:
        vol = torch.from_numpy(blob_volume(*vshape, seed + 5)).to(dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        denoise(vol, cfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        model = memory.denoise_peak_bytes(cfg, vshape, ks2s)
        require(peak <= model, f"memory {vshape}: peak {peak} B above the "
                f"model's {model} B")
        lines.append(f"{'x'.join(map(str, vshape))} {peak / 2**30:.3f} "
                     f"(model {model / 2**30:.3f}, {100 * peak / model:.1f}%)")
        del vol
    print(f"[6 stream] memory: in-memory solve denoise peaks, GiB: "
          f"{'; '.join(lines)}; none above the model", flush=True)

    shape = noisy.shape
    passes = [(shape[0], shape[1], shape[2]), (shape[1], shape[0], shape[2]),
              (shape[2], shape[0], shape[1])]
    # every pass's window at a third of its axis or less
    budget = min(memory.window_peak_bytes(cfg, n, h, w, k, n // 3)
                 for (n, h, w), k in zip(passes, ks2s))
    slabs = [memory.pass_slab(cfg, n, h, w, k, budget)
             for (n, h, w), k in zip(passes, ks2s)]
    windows = tuple(-(-n // s) for (n, _, _), s in zip(passes, slabs))
    require(min(windows) >= 3, f"forced budget: windows {windows}")
    vol = torch.from_numpy(noisy).to(dev)
    out = []
    saved = memory.device_budget
    memory.device_budget = lambda device: budget
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        secs = wall_s(lambda: out.append(denoise(vol, cfg)))
        launches = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    finally:
        memory.device_budget = saved
    want = expected_launches(shape, cfg, windows)
    require(launches == want, f"forced budget: launches {launches}, expected {want}")
    got = out[0].cpu().numpy()
    require(np.array_equal(got, ref), "forced budget: the slabbed denoise is not "
            f"bit-identical to the whole axis (max abs diff "
            f"{float(np.abs(got - ref).max())})")
    model = memory.denoise_peak_bytes(cfg, shape, ks2s, slabs)
    require(peak <= model, f"forced budget: peak {peak} B above the model's {model} B")
    del vol, out
    print(f"[6 stream] memory: in-memory denoise of {'x'.join(map(str, shape))} with "
          f"the budget forced to {budget / 2**30:.3f} GiB: slabs {slabs}, windows a "
          f"pass {windows}; bit-identical to the whole axis; launches {nonzero(launches)} as "
          f"expected; {secs:.3f} s; peak device memory {peak / 2**30:.3f} GiB (model "
          f"{model / 2**30:.3f})", flush=True)


# phase 4's paths run sharded in phase 7
SHARDED_PATHS = ("solve", "compose", "compose_symmetric", "solve_bf16", "fast")


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def shard_windows(shape, cfg, n_shards: int) -> tuple:
    """Pass windows of a sharded denoise of ``shape``: every shard runs each
    pass once, or once a slab (``cfg.slab_size``) of its planes."""
    from flowdenoising_tpu_torch.kernels import get_gaussian_kernels
    from flowdenoising_tpu_torch.parallel.mesh import _pass_extent
    out = []
    for n, taps in zip(shape, get_gaussian_kernels(cfg.sigma)):
        part = _pass_extent(n, len(taps) // 2, n_shards) // n_shards
        out.append(n_shards * -(-part // (cfg.slab_size or part)))
    return tuple(out)


def phase_sharded(dev, size: int, seed: int, outputs: dict) -> dict:
    """7 sharded: ``denoise_sharded`` over a mesh of 4 shards of the one
    card on phase 4's noisy volume (sigma 2, D 8, wrap unless named), in
    phase 4's paths, MEAN and REPLICATE, an uneven shape and a forced
    per-shard slab, each bit-identical to the card's single-device
    ``denoise`` with the launches its shard windows imply; the sharded
    stream over 2 shards; the CLI with --devices 4 (a mesh of the one card)
    and as a world of one NCCL process (--coordinator), each equal to the
    plain CLI's output.  Returns each sharded path's launches."""
    from flowdenoising_tpu_torch.config import Boundary, FilterConfig, FlowConfig
    from flowdenoising_tpu_torch.core.pipeline import denoise
    from flowdenoising_tpu_torch.core.stream import denoise_streamed
    from flowdenoising_tpu_torch.io import volume as volume_io
    from flowdenoising_tpu_torch.io.mrc import read_mrc, write_mrc
    from flowdenoising_tpu_torch.ops import cuda as K
    from flowdenoising_tpu_torch.parallel.mesh import denoise_sharded, make_mesh

    shape = (size,) * 3
    noisy = blob_volume(*shape, seed) + np.random.default_rng(seed + 1).normal(
        0.0, 40.0, shape).astype(np.float32)
    mesh4 = make_mesh(devices=[dev] * 4)
    counts = {}

    def same(name, out, ref):
        require(out.shape == ref.shape and bool(np.isfinite(out).all()),
                f"{name}: output shape {out.shape} or non-finite values")
        require(np.array_equal(out, ref), f"{name}: not bit-identical to one "
                f"device (max abs diff {float(np.abs(out - ref).max())})")

    def sharded(name, vol, cfg, ref, mesh=mesh4):
        """One sharded denoise against ``ref`` with its launch counts."""
        torch.cuda.synchronize()
        K.reset_launches()
        secs = wall_s(lambda: res.append(denoise_sharded(vol, cfg, mesh=mesh)))
        launches = dict(K.LAUNCHES)
        windows = shard_windows(np.shape(vol), cfg, len(mesh))
        want = expected_launches(np.shape(vol), cfg, windows)
        require(launches == want, f"{name}: launches {launches}, expected {want} "
                f"(windows {windows})")
        same(name, res.pop().cpu().numpy(), ref)
        counts[name] = launches
        print(f"[7 sharded] {'x'.join(map(str, np.shape(vol)))} {name}: "
              f"{len(mesh)} shards of one card, windows a pass {windows}; "
              f"bit-identical to one device; launches {nonzero(launches)} as "
              f"expected; {secs:.3f} s", flush=True)

    res = []
    vol = torch.from_numpy(noisy).to(dev)
    for name in SHARDED_PATHS:
        sharded(f"sharded_{name}", vol, FilterConfig(flow=FlowConfig(**PATHS[name][1])),
                outputs[name])
    solve = FilterConfig(flow=FlowConfig())
    for boundary in (Boundary.MEAN, Boundary.REPLICATE):
        cfg = dataclasses.replace(solve, boundary=boundary)
        # an array input: the MEAN fill is volume_mean, as in the CLI
        sharded(f"sharded_{boundary.value}", noisy, cfg,
                denoise(noisy, cfg).cpu().numpy())
    uneven = np.ascontiguousarray(noisy[:size - 2, :, :size - 6])
    sharded("sharded_uneven", uneven, solve, denoise(uneven, solve).cpu().numpy())
    del uneven
    sharded("sharded_slabs", vol, dataclasses.replace(solve, slab_size=size // 10 + 1),
            outputs["solve"])

    # the warm walls: one device and 4 shards of it, in turns
    walls = {"one device": [], "4 shards": []}
    for what in ("one device", "4 shards", "4 shards", "one device"):
        fn = ((lambda: denoise(vol, solve)) if what == "one device"
              else (lambda: denoise_sharded(vol, solve, mesh=mesh4)))
        walls[what].append(wall_s(fn))
    print(f"[7 sharded] {size}^3 solve warm wall, one device: "
          f"{', '.join(f'{t:.3f}' for t in walls['one device'])} s; 4 shards of "
          f"the card: {', '.join(f'{t:.3f}' for t in walls['4 shards'])} s (in "
          "turns)", flush=True)
    del vol

    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "noisy.mrc"
        write_mrc(src, noisy)
        del noisy
        # the sharded stream: windows of S planes, each over 2 shards
        slab = 3 * size // 10
        mesh2 = make_mesh(devices=[dev] * 2)
        mapped = volume_io.read_volume(src, memory_map=True)
        K.reset_launches()
        secs = wall_s(lambda: res.append(denoise_streamed(
            mapped, solve, slab_size=slab, tmp_dir=tmp, mesh=mesh2)))
        launches = dict(K.LAUNCHES)
        windows = (2 * -(-size // slab),) * 3
        want = expected_launches(shape, solve, windows)
        require(launches == want, f"sharded stream: launches {launches}, "
                f"expected {want}")
        same("sharded stream", np.asarray(res.pop()), outputs["solve"])
        counts["sharded_stream"] = launches
        del mapped
        print(f"[7 sharded] {size}^3 sharded stream (denoise_streamed, S {slab}, "
              f"2 shards of one card): windows a pass {windows}; bit-identical "
              f"to the in-memory output; launches {nonzero(launches)} as "
              f"expected; {secs:.3f} s", flush=True)

        base = ["-i", str(src), "-s", "2", "2", "2", "--max_displacement", "8"]
        cards = len(make_mesh(4))
        for name, flags, n_shards in (
                ("cli_devices", ["--devices", "4"], cards),
                ("cli_coordinator", ["--coordinator", f"127.0.0.1:{free_port()}",
                                     "--num_hosts", "1", "--host_id", "0",
                                     "--device", "cuda"], 1)):
            dst = Path(tmp) / f"{name}.mrc"
            secs, launches, _ = cli_run([*base, *flags, "-o", str(dst)], {})
            want = expected_launches(shape, solve, shard_windows(shape, solve, n_shards))
            require(launches == want, f"{name}: launches {launches}, expected {want}")
            out, _ = read_mrc(dst)
            same(name, np.asarray(out), outputs["solve"])
            counts[name] = launches
            print(f"[7 sharded] {size}^3 CLI {' '.join(flags)}: {n_shards} "
                  f"shard(s); bit-identical to the plain CLI output; launches "
                  f"{nonzero(launches)} as expected; {secs:.2f} s", flush=True)
        require(not torch.distributed.is_initialized(),
                "the process group outlived the CLI run")
    return counts


def phase_io(seed: int) -> None:
    """8 io: the CLI's read (``read_volume(..., as_f32=True)``) and write
    (``write_volume``) of a 512^3 float32 MRC (512 MiB) through the native
    runtime and through the NumPy path, in turns (native, NumPy, NumPy,
    native): each the same array and the same file bytes.  The read follows
    the write, so it reads from the host's page cache."""
    from flowdenoising_tpu_torch import runtime
    from flowdenoising_tpu_torch.io.volume import read_volume, write_volume

    vol = np.random.default_rng(seed + 7).normal(100.0, 40.0, (512,) * 3).astype(
        np.float32)
    walls = {"native": [], "numpy": []}
    files = {}
    load = runtime._load
    with tempfile.TemporaryDirectory() as tmp:
        for path in ("native", "numpy", "numpy", "native"):
            dst = Path(tmp) / f"{path}.mrc"
            if path == "numpy":
                runtime._load = lambda: None
            try:
                runtime.reset_native_calls()
                t0 = time.perf_counter()
                write_volume(dst, vol)
                t1 = time.perf_counter()
                back = read_volume(dst, as_f32=True)
                t2 = time.perf_counter()
                calls = dict(runtime.NATIVE_CALLS)
            finally:
                runtime._load = load
            n = int(path == "native")
            require(calls == {"read_convert": n, "write_raw": n, "stats": n},
                    f"io {path}: native calls {calls}")
            require(np.array_equal(back, vol), f"io {path}: the array read back "
                    "is not the one written")
            walls[path].append((t1 - t0, t2 - t1))
            data = dst.read_bytes()
            require(files.setdefault(path, data) == data and
                    files.get("native", data) == data,
                    f"io {path}: the file's bytes differ from the native path's")
            dst.unlink()
            del back, data
    fmt = "; ".join(f"{p}: " + ", ".join(f"write {w:.3f} s read {r:.3f} s"
                                         for w, r in walls[p]) for p in walls)
    print(f"[8 io] CLI read and write of a 512^3 float32 MRC (512 MiB), in turns: "
          f"{fmt}; the same array and the same file bytes on both paths",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=256,
                    help="edge of the cubic main-path volume")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stream_shape", type=str, default=None,
                    help="ZxYxX: run only phases 1, 2 and 6 at this shape")
    args = ap.parse_args()

    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    if args.stream_shape:
        shape = tuple(int(v) for v in args.stream_shape.lower().split("x"))
        require(len(shape) == 3, f"--stream_shape {args.stream_shape}: expected ZxYxX")
        phase_stream(dev, shape, args.seed)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    kern = phase_kernels(dev, args.seed)
    torch.cuda.empty_cache()
    counts, outputs = phase_main(dev, args.size, args.seed)
    phase_e2e(dev, args.seed)
    torch.cuda.empty_cache()
    phase_stream(dev, (args.size,) * 3, args.seed, outputs)
    torch.cuda.empty_cache()
    sharded = phase_sharded(dev, args.size, args.seed, outputs)
    del outputs
    phase_io(args.seed)

    # each kernel form's launches from the path that defines it: K-umuf and
    # K-sample from solve mode, K-compose-run (and the per-tap K-compose,
    # which no denoise launches now) from compose mode, K-umuf-split from
    # the bf16 pass with no bound, K-um and K-uf from the auto_v2 CLI run
    # that falls back to the reconstruction; the packed forms from the bf16
    # paths (K-um-bf16 from solve_bf16's reconstruction)
    kernels = {
        "umuf": ("flowdenoising_tpu_torch/csrc/umuf.cu",
                 "flowdenoising_tpu/ops/pallas/umuf.py:87", "solve"),
        "sample": ("flowdenoising_tpu_torch/csrc/sample.cu",
                   "flowdenoising_tpu/ops/pallas/sample.py:99", "solve"),
        "compose": ("flowdenoising_tpu_torch/csrc/compose.cu",
                    "flowdenoising_tpu/ops/pallas/compose.py:141", "compose"),
        "um": ("flowdenoising_tpu_torch/csrc/um.cu",
               "flowdenoising_tpu/ops/pallas/update_matrices.py:54", "stage_report"),
        "uf": ("flowdenoising_tpu_torch/csrc/uf.cu",
               "flowdenoising_tpu/ops/pallas/update_flow.py:32", "stage_report"),
        "umuf_split": ("flowdenoising_tpu_torch/csrc/umuf_split.cu",
                       "flowdenoising_tpu/ops/pallas/update_flow.py:32",
                       "solve_bf16_nobound"),
        "umuf_bf16": ("flowdenoising_tpu_torch/csrc/umuf.cu",
                      "flowdenoising_tpu/ops/pallas/umuf.py:87", "solve_bf16"),
        "compose_bf16": ("flowdenoising_tpu_torch/csrc/compose.cu",
                         "flowdenoising_tpu/ops/pallas/compose.py:141", "fast"),
        "um_bf16": ("flowdenoising_tpu_torch/csrc/um.cu",
                    "flowdenoising_tpu/ops/pallas/update_matrices.py:54",
                    "solve_bf16"),
        "compose_run": ("flowdenoising_tpu_torch/csrc/compose.cu",
                        "flowdenoising_tpu/ops/pallas/compose.py:141", "compose"),
        "compose_run_bf16": ("flowdenoising_tpu_torch/csrc/compose.cu",
                             "flowdenoising_tpu/ops/pallas/compose.py:141", "fast"),
    }
    print(card)
    # "paths": the launches of every phase 4 path (the reconstruction as
    # "stage_report") and every sharded path that runs the kernel
    runs = {**counts, **sharded}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": counts[path][name], **kern[name],
         "paths": {path: counts[path][name],
                   **{p: n[name] for p, n in runs.items() if n[name]}}}
        for name, (source, replaces, path) in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

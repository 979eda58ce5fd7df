"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py              # 256^3 main path (the default)
    python3 chip_smoke.py --size 512   # the same phase at 512^3

Phases, one line of output each (any failure exits non-zero):

1. device   -- a CUDA device of capability 9.0 (H100); its name and power
               limit as nvidia-smi reports them.
2. build    -- the kernels under flowdenoising_tpu_torch/csrc, compiled
               with nvcc for sm_90a.
3. kernels  -- K-sample and K-umuf against their plain PyTorch versions on
               the card, at the shapes the main path gives them, with the
               tolerances of the JAX package's own kernel tests; times of
               both.
4. main     -- the CLI's flow denoise (python -m flowdenoising_tpu_torch ...
               -s 2 2 2 --max_displacement 8) on a seeded size^3 blob
               volume with noise, through MRC files; the launch counts of
               both kernels must be what the tap and level loops imply, the
               output finite and closer to the clean volume than the input.
               Then a warm timed run of ``denoise``.
5. e2e      -- a 24x96x96 volume through ``denoise`` on the card (kernels)
               and on the CPU (plain versions): PSNR >= 55 dB between them.

The last lines are the card's nvidia-smi line, a JSON object of the kernels
and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
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
    from flowdenoising_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    path = build.build()
    build.load_library()
    secs = time.perf_counter() - t0
    log = path.with_suffix(".log").read_text() if path.with_suffix(".log").exists() else ""
    usage = [ln.split("info    : ")[-1] for ln in log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    print(f"[2 build] {path.name} in {secs:.2f} s; ptxas: {' | '.join(usage)}",
          flush=True)


def phase_kernels(dev, seed: int) -> dict:
    from flowdenoising_tpu_torch.ops import farneback as F
    from flowdenoising_tpu_torch.ops.cuda.umuf import umuf_iterate
    from flowdenoising_tpu_torch.ops.warp import (
        displace_sample, displace_sample_plain)

    r = np.random.default_rng(seed)
    res = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

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
    print(f"[3 kernels] K-sample main-path call (256,256,256) D=8: max_abs_err "
          f"{e:.3g}, kernel {ms:.4f} ms, plain {pms:.4f} ms", flush=True)
    res["sample"] = dict(max_abs_err=max(err, e), ms=ms, plain_ms=pms)
    del src, flow, out, ref

    # K-umuf: batch 16 at every level of a 256^2 plane with its d_k, iters 3,
    # winsize 5 and 7; atol 5e-4, rtol 1e-4
    err = 0.0
    for size, d in ((256, 9), (128, 5), (64, 3), (32, 2)):
        imgs = t(r.normal(size=(2, 16, size, size)) * 40)
        rr = F.poly_expand(imgs).contiguous()
        flow = t(r.normal(size=(16, 2, size, size)) * 1.5 * d / 9)
        for ws in (5, 7):
            out = umuf_iterate(rr[0], rr[1], flow, 3, d, ws)
            ref = F.umuf_iterate_plain(rr[0], rr[1], flow, 3, d, ws)
            torch.cuda.synchronize()
            diff = (out - ref).abs()
            ok = bool((diff <= 5e-4 + 1e-4 * ref.abs()).all())
            e = float(diff.max())
            require(ok, f"K-umuf {size}^2 d={d} ws={ws}: max abs err {e}")
            err = max(err, e)
            ms = cuda_ms(lambda: umuf_iterate(rr[0], rr[1], flow, 3, d, ws))
            pms = cuda_ms(lambda: F.umuf_iterate_plain(rr[0], rr[1], flow, 3, d, ws),
                          reps=3)
            print(f"[3 kernels] K-umuf (16,5,{size},{size}) d={d} ws={ws} iters=3: "
                  f"max_abs_err {e:.3g}, kernel {ms:.4f} ms, plain {pms:.4f} ms",
                  flush=True)
    # the main path's largest call: level 0 of a 256^3 pass, batch 256
    imgs = t(r.normal(size=(2, 256, 256, 256)) * 40)
    rr = F.poly_expand(imgs).contiguous()
    del imgs
    flow = t(r.normal(size=(256, 2, 256, 256)) * 1.5)
    out = umuf_iterate(rr[0], rr[1], flow, 3, 9, 5)
    ref = F.umuf_iterate_plain(rr[0], rr[1], flow, 3, 9, 5)
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    e = float(diff.max())
    require(bool((diff <= 5e-4 + 1e-4 * ref.abs()).all()),
            f"K-umuf main shape: max abs err {e}")
    ms = cuda_ms(lambda: umuf_iterate(rr[0], rr[1], flow, 3, 9, 5), reps=5)
    pms = cuda_ms(lambda: F.umuf_iterate_plain(rr[0], rr[1], flow, 3, 9, 5),
                  reps=2, warmup=1)
    print(f"[3 kernels] K-umuf main-path call (256,5,256,256) d=9 ws=5 iters=3: "
          f"max_abs_err {e:.3g}, kernel {ms:.4f} ms, plain {pms:.4f} ms", flush=True)
    res["umuf"] = dict(max_abs_err=max(err, e), ms=ms, plain_ms=pms)
    return res


def expected_launches(shape, cfg) -> dict:
    """Launches the tap and level loops imply for one denoise of ``shape``."""
    from flowdenoising_tpu_torch.kernels import get_gaussian_kernels
    planes = [(shape[1], shape[2]), (shape[0], shape[2]), (shape[0], shape[1])]
    n = {"sample": 0, "umuf": 0}
    for taps, (h, w) in zip(get_gaussian_kernels(cfg.sigma), planes):
        n_taps = len(taps) - 1
        n["sample"] += n_taps
        n["umuf"] += n_taps * (cfg.flow.clamped_levels(h, w) + 1) * cfg.flow.iterations
    return n


def phase_main(dev, size: int, seed: int) -> dict:
    from flowdenoising_tpu_torch import cli
    from flowdenoising_tpu_torch.config import FilterConfig
    from flowdenoising_tpu_torch.core.pipeline import denoise
    from flowdenoising_tpu_torch.io.mrc import read_mrc, write_mrc
    from flowdenoising_tpu_torch.ops import cuda as K

    clean = blob_volume(size, size, size, seed)
    # noise std 40 against blob amplitudes 50-200: the input sits near
    # 21 dB, where the 3-pass sigma-2 filter gains clearly (+6-7 dB at 48^3
    # on the CPU path)
    noisy = clean + np.random.default_rng(seed + 1).normal(
        0.0, 40.0, clean.shape).astype(np.float32)
    cfg = FilterConfig()   # sigma 2, wrap, D = 8, solve, float32
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "noisy.mrc", Path(tmp) / "denoised.mrc"
        write_mrc(src, noisy)
        K.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["-i", str(src), "-o", str(dst), "-s", "2", "2", "2",
                       "--max_displacement", "8", "-v", "1"])
        cold = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        require(rc == 0, f"cli.main returned {rc}")
        out, _ = read_mrc(dst)
    want = expected_launches(clean.shape, cfg)
    require(launches == want, f"launch counts {launches}, expected {want}")
    require(out.shape == clean.shape, f"output shape {out.shape}")
    require(bool(np.isfinite(out).all()), "non-finite output")
    p_in, p_out = psnr(noisy, clean), psnr(out, clean)
    require(p_out > p_in, f"PSNR vs clean {p_out:.2f} dB <= input's {p_in:.2f} dB")

    vol = torch.from_numpy(noisy).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = denoise(vol, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rerun = float(np.abs(warm.cpu().numpy() - out).max())
    mvox = clean.size / secs / 1e6
    print(f"[4 main] {size}^3 CLI solve denoise (sigma 2, D=8, wrap): launches "
          f"{launches} as expected; PSNR vs clean {p_in:.2f} -> {p_out:.2f} dB; "
          f"CLI run {cold:.2f} s (cold, incl. I/O); warm denoise {secs:.3f} s = "
          f"{mvox:.2f} Mvoxel/s; peak device memory {peak / 2**30:.2f} GiB; "
          f"warm vs CLI output max abs diff {rerun:.3g}", flush=True)
    return launches


def phase_e2e(dev, seed: int) -> None:
    from flowdenoising_tpu_torch.config import FilterConfig
    from flowdenoising_tpu_torch.core.pipeline import denoise

    vol = blob_volume(24, 96, 96, seed + 2)
    vol += np.random.default_rng(seed + 3).normal(0, 20, vol.shape).astype(np.float32)
    cfg = FilterConfig()
    on_card = denoise(torch.from_numpy(vol).to(dev), cfg).cpu().numpy()
    on_cpu = denoise(torch.from_numpy(vol), cfg).numpy()
    p = psnr(on_card, on_cpu)
    require(p >= 55.0, f"card vs CPU PSNR {p:.2f} dB < 55")
    print(f"[5 e2e] 24x96x96 denoise, card (kernels) vs CPU (plain): PSNR "
          f"{p:.2f} dB (bar 55); max abs diff "
          f"{float(np.abs(on_card - on_cpu).max()):.3g}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=256,
                    help="edge of the cubic main-path volume")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kern = phase_kernels(dev, args.seed)
    torch.cuda.empty_cache()
    launches = phase_main(dev, args.size, args.seed)
    phase_e2e(dev, args.seed)

    sources = {"sample": ("flowdenoising_tpu_torch/csrc/sample.cu",
                          "flowdenoising_tpu/ops/pallas/sample.py:99"),
               "umuf": ("flowdenoising_tpu_torch/csrc/umuf.cu",
                        "flowdenoising_tpu/ops/pallas/umuf.py:87")}
    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name], **kern[name]}
        for name in ("umuf", "sample")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

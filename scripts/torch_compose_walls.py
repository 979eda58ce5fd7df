"""Warm wall time, compose-kernel device time and peak device memory of the
PyTorch/CUDA port's compose denoise paths on one GPU.

    python3 scripts/torch_compose_walls.py --root DIR [--size 256 512]

Imports ``flowdenoising_tpu_torch`` from the checkout at ``--root`` (so two
trees can be compared in turns on one card) and denoises
``chip_smoke.py``'s seeded blob volume with noise std 40 at each size,
sigma 2, D 8, in three configurations: compose, compose with symmetric
adjacent flows, and the fast mode (symmetric, bf16).  Per configuration:
one cold run, then three warm runs ended by ``torch.cuda.synchronize()``
(each wall printed), the peak of ``torch.cuda.max_memory_allocated``, and
a ``torch.profiler`` run summing the device time of the compose kernels
(``compose_kernel`` per tap, ``compose_run_kernel`` per pass) and of all
kernels.  Prints one JSON line per configuration.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="checkout to import from")
    ap.add_argument("--size", type=int, nargs="+", default=[256, 512])
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from flowdenoising_tpu_torch.config import FilterConfig, FlowConfig
    from flowdenoising_tpu_torch.core.pipeline import denoise
    from flowdenoising_tpu_torch.utils import tracing

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    configs = {
        "compose": {"tap_mode": "compose"},
        "compose_symmetric": {"tap_mode": "compose", "symmetric_adjacent": True},
        "fast": {"tap_mode": "compose", "symmetric_adjacent": True,
                 "dtype": "bfloat16", "precision": "bfloat16"},
    }
    for size in args.size:
        clean = chip_smoke.blob_volume(size, size, size, 0)
        noisy = clean + np.random.default_rng(1).normal(
            0.0, 40.0, clean.shape).astype(np.float32)
        vol = torch.from_numpy(noisy).to(dev)
        for name, fields in configs.items():
            cfg = FilterConfig(flow=FlowConfig(max_displacement=8, **fields))
            denoise(vol, cfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                denoise(vol, cfg)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() / 2**30
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                denoise(vol, cfg)
                torch.cuda.synchronize()
            compose_ms = busy_ms = 0.0
            for ev in prof.events():
                # the port's ranges also show on the device; they span
                # kernels and are none
                if ev.device_type != DeviceType.CUDA or ev.name in (
                        tracing.EXPANSION_RANGE, tracing.SOLVE_RANGE,
                        tracing.WARP_RANGE, tracing.COMPOSE_RANGE,
                        tracing.RESIZE_RANGE, tracing.PASS_RANGE) or (
                        ev.name.startswith(tracing.DRAIN_PREFIX)):
                    continue
                ms = ev.time_range.elapsed_us() / 1e3
                busy_ms += ms
                if "compose_kernel" in ev.name or "compose_run_kernel" in ev.name:
                    compose_ms += ms
            print(json.dumps({"root": args.root, "size": size, "config": name,
                              "warm_s": walls, "peak_gib": peak,
                              "compose_kernel_ms": compose_ms,
                              "device_busy_ms": busy_ms}), flush=True)
        del vol
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

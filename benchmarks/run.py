#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the CUDA card it starts on.

    python3 benchmarks/run.py --workload epfl.solve --seed 7 --seconds 50 --trace 0

From the root of a checkout.  The cell's pool of distinct volumes is made
on the card from ``--seed`` and brought to the host; one warm volume is
denoised; then one client denoises the pool's volumes in turn, each
``flowdenoising_tpu_torch.core.pipeline.denoise`` of a float32 host volume
with its result brought back to the host (as the CLI runs between its read
and its write), the next started when the last is back.  The window ends
when the first volume to finish after ``--seconds`` is back, and holds at
least one round of the pool.  ``--trace 1`` runs one round of the pool
under ``torch.profiler`` instead and reports the per-layer metrics.

Afterwards every window output of the pool volume the seed samples is
compared with the plain reference's denoise of that volume
(``benchmarks/compare.py``).  The last line of standard output is the JSON
result; the compared numbers and their limits end standard error.  Exits
non-zero, printing no result, without enough CUDA cards or with JAX or
the JAX package loaded.
"""

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import trace as tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "flowdenoising_tpu")
GIB = 1 << 30


def forbidden_modules() -> list[str]:
    """Loaded modules of JAX or the JAX package, by whole top-level name."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


class Window:
    """The measured window: its start and each volume's (start, end), host
    seconds."""

    def __init__(self, start: float, spans: list):
        self.start = start
        self.spans = spans

    @property
    def seconds(self) -> float:
        return self.spans[-1][1] - self.start

    @property
    def walls(self) -> list:
        return [b - a for a, b in self.spans]

    def mvoxel_s(self, voxels: int) -> float:
        return len(self.spans) * voxels / self.seconds / 1e6


def closed_loop(step, pool: list, seconds: float, rounds_only: bool = False,
                keep=None, clock=time.perf_counter):
    """One client: ``step(pool[i % len(pool)])`` one after the other until
    the first to finish after ``seconds`` (and one round of the pool at
    least; with ``rounds_only`` exactly one).  Returns the window and the
    outputs of the pool index ``keep``."""
    kept, spans = [], []
    start = clock()
    i = 0
    while True:
        a = clock()
        out = step(pool[i % len(pool)])
        b = clock()
        spans.append((a, b))
        if i % len(pool) == keep:
            kept.append(out)
        i += 1
        if i >= len(pool) and (rounds_only or b - start >= seconds):
            return Window(start, spans), kept


class Program:
    """The system under test: ``denoise`` of a host volume, its result on
    the host."""

    def __init__(self, cell, device):
        import torch

        from flowdenoising_tpu_torch.config import (
            Boundary, FilterConfig, FlowConfig)
        from flowdenoising_tpu_torch.core.pipeline import denoise
        from flowdenoising_tpu_torch.kernels import get_gaussian_kernels

        c = cell.config
        self.cfg = FilterConfig(sigma=tuple(c["sigma"]),
                                boundary=Boundary(c["boundary"]),
                                flow=FlowConfig(**cell.flow))
        self.kernels = get_gaussian_kernels(self.cfg.sigma)
        self.device = device
        self.denoise = denoise
        self.span = torch.profiler.record_function

    def __call__(self, vol):
        with self.span(tracing.VOLUME_SPAN):
            out = self.denoise(vol, self.cfg, kernels=self.kernels,
                               device=self.device)
        with self.span(tracing.TO_HOST_SPAN):
            return out.cpu().numpy()


def reference(cell, vol, device, tf32: bool = False):
    from benchmarks.reference import plain

    c = cell.config
    flow = cell.flow
    if (c["boundary"] != "wrap" or flow["dtype"] != "float32"
            or flow["precision"] != "float32" or flow["presmooth"]):
        raise ValueError("the plain reference computes the float32 flow "
                         "denoise with the wrap boundary and no presmooth")
    return plain.denoise(vol, c["sigma"], flow, flow["tap_mode"], device,
                         tf32=tf32)


def run(cell, seed: int, seconds: float, trace: bool, device, start: float,
        step=None):
    """One run of ``cell``: (result without its ``compared`` key, the
    compared numbers with their limits)."""
    import torch

    from benchmarks import compare, volumes
    from benchmarks.spec import reader

    cuda = device.type == "cuda"
    step = step or Program(cell, device)
    pool = volumes.pool(cell.config, cell.traffic, seed, device)
    keep = volumes.sampled(cell.traffic, seed)
    step(pool[0])
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    if trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            with torch.profiler.record_function(tracing.WINDOW_SPAN):
                window, kept = closed_loop(step, pool, seconds, True, keep)
        traced = tracing.Trace(tracing.from_profiler(prof), len(window.spans),
                               cell)
        del prof
    else:
        window, kept = closed_loop(step, pool, seconds, False, keep)
    setup_s = window.start - start
    print(f"{len(window.spans)} volumes in {window.seconds:.3f} s",
          file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = reader(m["name"], cell.root)(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"mvoxel_s": window.mvoxel_s(math.prod(cell.shape)),
                  "peak_gib": peak / GIB, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = reference(cell, pool[keep], device)
    worst, failed = compare.judge(kept, ref, cell.limits)
    del ref
    print(f"pool volume {keep}: {len(kept)} outputs compared with the "
          f"reference ({time.perf_counter() - t:.3f} s)", file=sys.stderr)
    correct = bool(kept) and failed == 0
    result = {"correct": correct, "attempted": len(window.spans),
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": (torch.cuda.get_device_name(device) if cuda
                                  else device.type),
                         "count": cell.chips, "memory_peak_bytes": peak}}
    if trace:
        result["device"]["busy_s"] = traced.busy_s
        result["device"]["window_s"] = traced.window_s
        result["breakdown"] = traced.breakdown()
    compared = {k: {"value": worst[k], "limit": cell.limits[k]}
                for k in worst}
    return result, compared


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmarks import spec

    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, compared = run(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), _START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    result["compared"] = compared
    for k, v in compared.items():
        print(f"compared {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the CUDA card it starts on.

    python3 benchmarks/run.py --workload epfl.solve --seed 7 --seconds 50 --trace 0

From the root of a checkout.  The cell's pool of distinct volumes is made
on the card from ``--seed`` and brought to the host; one warm volume is
denoised; then one client denoises the pool's volumes in turn, each
``flowdenoising_tpu_torch.core.pipeline.denoise`` of a float32 host volume
with its result brought back to the host (as the CLI runs between its read
and its write), the next started when the last is back.  Where the cell's
flow has ``"max_displacement": "auto"``, each volume is first probed for
its bound as the CLI probes it (``core/autodisp.py:
resolve_auto_displacement``, from the CLI's fixed default) and denoised at
the bound picked.  The window ends when the first volume to finish after
``--seconds`` is back, and holds at least one round of the pool.
``--trace 1`` runs one round of the pool under ``torch.profiler`` instead
and reports the per-layer metrics.

Afterwards every window output of the pool volume the seed samples is
compared with the plain reference's denoise of that volume
(``benchmarks/compare.py``), at the bound the plain probe
(``benchmarks/reference/autodisp.py``) picks for an ``auto`` cell; an output
whose bound is not that pick fails.  The last line of standard output is
the JSON result; the compared numbers and their limits end standard error.
Exits non-zero, printing no result, without enough CUDA cards or with JAX
or the JAX package loaded.  The bytecode of what a run imports is kept in
the checkout's ``build/pycache``, beside the kernels' build.
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
# a flow's max_displacement that the CLI's probe resolves for each volume
AUTO = "auto"
# the bounds the program's probe picks are the plain probe's exactly
PICK_LIMIT = 0


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
    the host.  With an ``auto`` bound, each volume's probe first; the bounds
    it resolved, ``(max_displacement, adjacent_displacement)``, are kept in
    ``picks``, one a call."""

    def __init__(self, cell, device):
        import torch

        from flowdenoising_tpu_torch.config import (
            Boundary, FilterConfig, FlowConfig)
        from flowdenoising_tpu_torch.core.pipeline import denoise
        from flowdenoising_tpu_torch.kernels import get_gaussian_kernels

        c = cell.config
        flow = cell.flow
        self.resolve = None
        if flow["max_displacement"] == AUTO:
            from flowdenoising_tpu_torch.cli import MAX_DISPLACEMENT
            from flowdenoising_tpu_torch.core.autodisp import (
                resolve_auto_displacement)

            # the fixed default stands until the probe replaces it, as in
            # the CLI (its floors fall back to it)
            flow = {**flow, "max_displacement": MAX_DISPLACEMENT}
            self.resolve = resolve_auto_displacement
        self.cfg = FilterConfig(sigma=tuple(c["sigma"]),
                                boundary=Boundary(c["boundary"]),
                                flow=FlowConfig(**flow))
        self.kernels = get_gaussian_kernels(self.cfg.sigma)
        self.device = device
        self.denoise = denoise
        self.picks = []
        self.span = torch.profiler.record_function

    def __call__(self, vol):
        cfg = self.cfg
        if self.resolve is not None:
            with self.span(tracing.PROBE_SPAN):
                cfg = self.resolve(vol, cfg, device=self.device)
            self.picks.append((cfg.flow.max_displacement,
                               cfg.flow.adjacent_displacement))
        with self.span(tracing.VOLUME_SPAN):
            out = self.denoise(vol, cfg, kernels=self.kernels,
                               device=self.device)
        with self.span(tracing.TO_HOST_SPAN):
            return out.cpu().numpy()


def plain_flow(cell, vol, device) -> dict:
    """The flow settings the reference runs for ``vol``: the cell's, with an
    ``auto`` bound resolved by the plain probe (IEEE float32 products)."""
    flow = cell.flow
    if flow["max_displacement"] != AUTO:
        return flow
    from benchmarks.reference import autodisp

    max_d, adj_d = autodisp.probe(vol, cell.config["sigma"], flow, device)
    return {**flow, "max_displacement": max_d, "adjacent_displacement": adj_d}


def reference(cell, vol, device, tf32: bool = False, flow=None):
    """The plain reference's denoise of ``vol`` under ``flow`` (default:
    ``plain_flow``'s)."""
    from benchmarks.reference import plain

    c = cell.config
    flow = flow or plain_flow(cell, vol, device)
    if (c["boundary"] != "wrap" or flow["dtype"] != "float32"
            or flow["precision"] != "float32" or flow["presmooth"]):
        raise ValueError("the plain reference computes the float32 flow "
                         "denoise with the wrap boundary and no presmooth")
    return plain.denoise(vol, c["sigma"], flow, flow["tap_mode"], device,
                         tf32=tf32)


def kept_picks(step, volumes: int, pool: int, keep: int) -> list:
    """The bounds the step's probe picked for each window output of pool
    volume ``keep``, in order (none where the step keeps no picks)."""
    picks = getattr(step, "picks", [])
    if len(picks) < volumes:
        return []
    return picks[len(picks) - volumes:][keep::pool]


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
    flow = plain_flow(cell, pool[keep], device)
    ref = reference(cell, pool[keep], device, flow=flow)
    worst, bad = compare.failures(kept, ref, cell.limits)
    del ref
    print(f"pool volume {keep}: {len(kept)} outputs compared with the "
          f"reference ({time.perf_counter() - t:.3f} s)", file=sys.stderr)
    limits = dict(cell.limits)
    if cell.flow["max_displacement"] == AUTO:
        want = (flow["max_displacement"], flow["adjacent_displacement"])
        mine = kept_picks(step, len(window.spans), len(pool), keep)
        print(f"pool volume {keep}: bounds picked (max_displacement, "
              f"adjacent_displacement): the program's "
              f"{sorted(set(mine)) or 'none kept'}, the plain probe's "
              f"{want}", file=sys.stderr)
        gaps = [max(abs(a - b) for a, b in zip(p, want)) for p in mine]
        gaps += [math.inf] * (len(kept) - len(gaps))
        bad = [b or g > PICK_LIMIT for b, g in zip(bad, gaps)]
        worst["pick_gap"] = max(gaps, default=0.0)
        limits["pick_gap"] = PICK_LIMIT
    failed = sum(bad)
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
    compared = {k: {"value": worst[k], "limit": limits[k]} for k in worst}
    return result, compared


def cache_bytecode(root: Path = ROOT) -> None:
    """Keep the bytecode of every module imported from here on (torch,
    numpy, the port) in the checkout's ``build/pycache``, so that only a
    checkout's first run compiles it: with ``PYTHONDONTWRITEBYTECODE`` set
    and no bytecode installed, every start recompiled torch's sources
    (7-9 s on an H100 host, the most of ``setup_s`` and of its spread)."""
    sys.pycache_prefix = str(root / "build" / "pycache")
    sys.dont_write_bytecode = False


def main(argv=None) -> int:
    cache_bytecode()
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

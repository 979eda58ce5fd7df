#!/usr/bin/env python3
"""Audit the port's spans on the card: one traced round of each benchmark
cell, as ``benchmarks/run.py --trace 1`` runs it, read for what the
per-layer metrics cannot show.

    python3 scripts/torch_drain_audit.py --seed 123456789 [--cells epfl.solve ...]

For each cell it prints one JSON line:

- ``metrics``: the cell's per-layer metrics, as the benchmark reads them;
- ``idle_ms``: device idle a volume, and ``covered``: the share of it in
  the gaps the three ``*.drain_idle_ms`` metrics count;
- ``rest``: the idle a volume in the other gaps, by the innermost host op
  open on the loop's thread when each began;
- ``drains``: drain spans a volume by site, and ``spans``: every program
  span a volume by name;
- ``blocking``: the runtime calls that hold the host (syncs,
  ``cudaMemGetInfo``, ``cudaHostAlloc``) inside ``bench.denoise``, a
  volume, and ``blocking_outside``: those outside every drain span, by the
  innermost host op around them;
- ``unspanned``: device events inside ``bench.denoise`` launched outside
  every program span, by name and the host op that launched them;
- ``runtime``: every CUDA runtime call inside ``bench.denoise``, a volume.

With ``--on_cost ROUNDS``, then, a cell at a time, ROUNDS traced rounds
with the spans on and as many with them off, in turns in one process: each
round's traced wall and idle share.  Last, the span helper's cost with no
profiler and while one records (ns a span, timed on the host), and whether
the spans enter ``record_function`` under
``torch.autograd.profiler.emit_nvtx`` (where torch makes each an NVTX
range).  Needs a CUDA card; imports neither JAX nor the JAX package.
"""

import argparse
import bisect
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmarks import drains, spec, trace, volumes  # noqa: E402
from benchmarks.run import Program, closed_loop  # noqa: E402

CELLS = ("epfl.solve", "czii.compose", "czii.solve", "epfl.compose")
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaMemGetInfo", "cudaHostAlloc")
PROGRAM = ("OFE_expansion", "OFE_solve", "warping", "fdt.compose",
           "fdt.resize", "fdt.pass")


def program_span(name: str) -> bool:
    return name in PROGRAM or name.startswith(drains.DRAIN_PREFIX)


class Intervals:
    """A union of intervals, for membership by bisection."""

    def __init__(self, spans):
        merged = trace.union(spans)
        self.lo = [lo for lo, _ in merged]
        self.hi = [hi for _, hi in merged]

    def holds(self, a, b=None) -> bool:
        """Whether [a, b] (b = a: the point) lies inside the union."""
        i = bisect.bisect_right(self.lo, a) - 1
        return i >= 0 and (a if b is None else b) <= self.hi[i]


def stacks(host, times) -> dict:
    """{t: names of the host events open at t, outermost first} for each
    time, by one sweep over the events sorted by start."""
    host = sorted(host, key=lambda e: (e.start, -e.end))
    out, stack, i = {}, [], 0
    for t in sorted(set(times)):
        while i < len(host) and host[i].start <= t:
            e = host[i]
            while stack and stack[-1].end < e.start:
                stack.pop()
            stack.append(e)
            i += 1
        # events that ended before t may sit under one still open
        out[t] = [e.name for e in stack if e.end >= t]
    return out


def warm(name: str, seed: int, device):
    """The cell, its program and its pool, one volume denoised."""
    cell = spec.load(name)
    step = Program(cell, device)
    pool = volumes.pool(cell.config, cell.traffic, seed, device)
    step(pool[0])
    torch.cuda.synchronize(device)
    return cell, step, pool


def traced_round(cell, step, pool):
    """One round of the pool under the profiler, as ``run.py --trace 1``
    runs it: (its ``Trace``, its events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            window, _ = closed_loop(step, pool, 0.0, True)
    events = trace.from_profiler(prof)
    return trace.Trace(events, len(window.spans), cell), events


def audit(name: str, seed: int, device) -> dict:
    cell, step, pool = warm(name, seed, device)
    tr, events = traced_round(cell, step, pool)
    del pool
    vols = tr.volumes
    host = [e for e in events if not e.device]
    loop = [e for e in host if e.thread == tr.thread]
    calls = Intervals((e.start, e.end) for e in loop
                      if e.name == trace.VOLUME_SPAN)
    drained = Intervals((e.start, e.end) for e in loop
                        if e.name.startswith(drains.DRAIN_PREFIX))
    spanned = Intervals((e.start, e.end) for e in loop
                        if program_span(e.name))

    metrics = {m["name"]: spec.reader(m["name"])(tr) for m in cell.per_layer}
    idle_ms = (tr.hi - tr.lo) / 1e6 / vols - tr.busy_s * 1e3 / vols
    covered = sum(metrics.get(k) or 0.0 for k in (
        "resize.drain_idle_ms", "expansion.drain_idle_ms",
        "pipeline.drain_idle_ms"))

    # the idle the drains do not hold, by what the host was in
    gaps = [(a, b) for a, b in tr.gaps() if not drained.holds(a)]
    open_at = stacks(loop, [a for a, _ in gaps])
    rest = {}
    for a, b in gaps:
        label = open_at[a][-1] if open_at[a] else "python"
        rest[label] = rest.get(label, 0.0) + (b - a) / 1e6 / vols

    def per_volume(names):
        counts = {}
        for n in names:
            counts[n] = counts.get(n, 0) + 1
        return {k: v / vols for k, v in sorted(counts.items())}

    in_calls = [e for e in loop if calls.holds(e.start)]
    blocking = [e for e in in_calls if e.name in BLOCKING]
    stray = [e for e in blocking if not drained.holds(e.start, e.end)]
    open_at = stacks(loop, [e.start for e in stray])
    outside = [" > ".join([n for n in open_at[e.start]
                           if n not in BLOCKING][-3:] + [e.name])
               for e in stray]

    # each device event's launch: the runtime call of its correlation id,
    # else the torch op it is linked to
    by_corr = {}
    for e in host:
        if e.corr > 0:
            by_corr.setdefault(e.corr, []).append(e)
    via = {"runtime": 0, "op": 0, "none": 0}
    launches = []
    for e in tr.work:
        runtime = [c for c in by_corr.get(e.corr, ())
                   if c.name.startswith("cuda")]
        if runtime:
            launch, how = runtime[0], "runtime"
        elif e.linked and by_corr.get(e.linked):
            launch, how = by_corr[e.linked][0], "op"
        else:
            via["none"] += 1
            continue
        via[how] += 1
        if launch.thread == tr.thread and calls.holds(launch.start):
            launches.append((e, launch))
    loose = [(e, launch) for e, launch in launches
             if not spanned.holds(launch.start)]
    open_at = stacks(loop, [launch.start for _, launch in loose])
    unspanned = [f"{e.name[:60]} <- " + " > ".join(open_at[launch.start][-3:])
                 for e, launch in loose]

    return {
        "cell": name, "seed": seed, "volumes": vols,
        "device": torch.cuda.get_device_name(device),
        "window_s": tr.window_s, "busy_s": tr.busy_s,
        "metrics": metrics, "idle_ms": idle_ms,
        "covered": covered / idle_ms if idle_ms else None,
        "rest": dict(sorted(rest.items(), key=lambda kv: -kv[1])[:12]),
        "drains": per_volume(e.name for e in in_calls
                             if e.name.startswith(drains.DRAIN_PREFIX)),
        "spans": per_volume(e.name for e in in_calls
                            if program_span(e.name)),
        "blocking": per_volume(e.name for e in blocking),
        "blocking_outside": per_volume(outside),
        "device_events_in_calls": len(launches) / vols,
        "unspanned": per_volume(unspanned),
        "launch_found_via": via,
        "runtime": per_volume(e.name for e in in_calls
                              if e.name.startswith("cuda")),
    }


def off_cost(reps: int = 1_000_000) -> dict:
    """ns a span with no profiler, against the same loop without one."""
    from flowdenoising_tpu_torch.utils.tracing import span

    def loop(with_span: bool) -> float:
        t = time.perf_counter_ns()
        if with_span:
            for _ in range(reps):
                with span("fdt.drain.input"):
                    pass
        else:
            for _ in range(reps):
                pass
        return (time.perf_counter_ns() - t) / reps

    runs = [(loop(False), loop(True)) for _ in range(5)]
    return {"empty_loop_ns": sorted(a for a, _ in runs)[2],
            "span_loop_ns": sorted(b for _, b in runs)[2]}


def on_cost(name: str, seed: int, device, rounds: int) -> dict:
    """Traced rounds of one process with the spans on and off in turns
    (off: the helper's check patched to read no profiler), so the spans'
    cost under the profiler shows apart from process and host changes:
    each round's traced wall and idle share, ms a volume."""
    from flowdenoising_tpu_torch.utils import tracing

    cell, step, pool = warm(name, seed, device)
    real = tracing._profiler_enabled
    out = {"on": [], "off": []}
    try:
        for r in range(rounds):
            for on in ((True, False) if r % 2 == 0 else (False, True)):
                tracing._profiler_enabled = real if on else (lambda: False)
                tr, _ = traced_round(cell, step, pool)
                out["on" if on else "off"].append({
                    "wall_ms": tr.window_s * 1e3 / tr.volumes,
                    "idle_pct": 100.0 * (1.0 - tr.busy_s / tr.window_s),
                    "drains": spec.reader("pipeline.drains")(tr)})
    finally:
        tracing._profiler_enabled = real
    del pool
    return {"cell": name, "on_cost": out}


def span_ns_profiled(reps: int = 100_000) -> float:
    """ns a span while the profiler records (the span and its event)."""
    from torch.profiler import ProfilerActivity, profile

    from flowdenoising_tpu_torch.utils.tracing import span

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t = time.perf_counter_ns()
        for _ in range(reps):
            with span("fdt.drain.input"):
                pass
        ns = (time.perf_counter_ns() - t) / reps
    return ns


def nvtx_check(device) -> dict:
    """Whether the spans enter ``record_function`` under ``emit_nvtx``, in
    a small denoise, against a kineto trace of the same denoise."""
    import numpy as np

    from flowdenoising_tpu_torch.config import FilterConfig, FlowConfig
    from flowdenoising_tpu_torch.core.pipeline import denoise
    from flowdenoising_tpu_torch.utils import tracing

    vol = np.random.default_rng(1).normal(100, 30, (16, 64, 64)).astype(
        np.float32)
    cfg = FilterConfig(flow=FlowConfig(levels=2, min_size=8))
    denoise(vol, cfg, device=device)
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    torch.profiler.record_function = counting
    try:
        with torch.autograd.profiler.emit_nvtx():
            enabled = bool(tracing._profiler_enabled())
            denoise(vol, cfg, device=device)
            torch.cuda.synchronize(device)
        under_nvtx = len(entered)
        entered.clear()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            denoise(vol, cfg, device=device)
            torch.cuda.synchronize(device)
        under_kineto = len(entered)
    finally:
        torch.profiler.record_function = real
    return {"profiler_enabled_under_emit_nvtx": enabled,
            "spans_entered_under_emit_nvtx": under_nvtx,
            "spans_entered_under_torch_profiler": under_kineto}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=123456789)
    p.add_argument("--cells", nargs="*", default=list(CELLS))
    p.add_argument("--on_cost", type=int, default=0, metavar="ROUNDS",
                   help="then, a cell at a time, ROUNDS traced rounds with "
                        "the spans on and as many with them off, in turns")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for name in args.cells:
        print(json.dumps(audit(name, args.seed, device)), flush=True)
        torch.cuda.empty_cache()
    for name in args.cells if args.on_cost else ():
        print(json.dumps(on_cost(name, args.seed, device, args.on_cost)),
              flush=True)
        torch.cuda.empty_cache()
    extra = {"off_cost": off_cost(), "span_ns_profiled": span_ns_profiled(),
             "nvtx": nvtx_check(device)}
    print(json.dumps(extra), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

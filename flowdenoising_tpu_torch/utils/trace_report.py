"""Measured per-stage device time from a ``torch.profiler`` trace of the run.

Counterpart of ``flowdenoising_tpu/utils/trace_report.py``, the successor
of the reference GPU variant's OFE / warping / convolution accumulators.
``traced_run`` wraps the CLI's filter phase in ``torch.profiler`` and
exports the Chrome trace; ``measured_stage_report`` sums the device events
of that trace by stage:

- ``OFE_solve``     -- the flow-iteration kernels K-umuf, K-umuf-split,
                       K-um and K-uf (the kernels that return flow
                       stacks), and every other kernel inside a
                       ``torch.profiler`` range named ``OFE_solve``;
- ``compose``       -- the compose kernels K-compose and
                       K-compose-run(-split), and every other kernel inside
                       a range named ``fdt.compose``;
- ``warping``       -- K-sample, K-sample-split, and every other kernel
                       inside a range named ``warping``;
- ``OFE_expansion`` -- every other kernel inside a range named
                       ``OFE_expansion`` (the port puts one around
                       ``ops.farneback.polyexp_pyramid``: its
                       shift-and-adds are not a kernel family of their own);
- ``elementwise``   -- every other kernel (tap accumulate, pads, flow
                       scaling, resize products, copies by kernel);
- ``async_copies``  -- memcpy and memset, left out of the busy total.

The ranges are ``utils.tracing``'s.  The report also logs the program's
drains (its ``fdt.drain.<site>`` ranges, each a call that held the host
until the stream drained) by site, and the device idle after them: each
gap between device events (kernels, copies, sets) that began inside a
drain, counted whole to the next event, by the drain's site.

A trace without device events (a CPU run) gives None, and the CLI then
logs the reconstruction of ``utils.stage_report`` instead.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import logging
import os
import re
import tempfile

import torch

from flowdenoising_tpu_torch.utils.tracing import (
    COMPOSE_RANGE, DRAIN_PREFIX, EXPANSION_RANGE, SOLVE_RANGE, WARP_RANGE)

# kernel symbol -> stage, the first that matches
_KERNELS = ((re.compile(r"\b(umuf|umuf_split|um|uf)_kernel\b"), "OFE_solve"),
            (re.compile(r"\bcompose(_run(_split)?)?_kernel\b"), "compose"),
            (re.compile(r"\bsample(_split)?_kernel\b"), "warping"))
# the stage of the kernels inside each of the port's profiler ranges, which
# do not nest one another
_RANGES = {EXPANSION_RANGE: "OFE_expansion", SOLVE_RANGE: "OFE_solve",
           COMPOSE_RANGE: "compose", WARP_RANGE: "warping"}
_COPY_CATS = ("gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def traced_run(export_phase=contextlib.nullcontext, log_dir=None):
    """Profile the enclosed block (CPU ops, and CUDA kernels where there is
    a card); yields a dict that receives ``{"path": <Chrome trace>}`` once
    the block ends.  Stopping the profiler and writing the trace run inside
    ``export_phase()`` (the CLI times them as its ``trace_export`` phase,
    apart from the block).  The trace is a new file in ``log_dir`` (None:
    the system's temporary directory), which the caller removes."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    state = {}
    prof = profile(activities=activities)
    prof.start()
    try:
        yield state
    except BaseException:
        prof.stop()
        raise
    with export_phase():
        prof.stop()
        fd, path = tempfile.mkstemp(prefix="fdt_trace_", suffix=".json",
                                    dir=log_dir)
        os.close(fd)
        prof.export_chrome_trace(path)
    state["path"] = path


def _drain_idle(spans: list) -> tuple[dict, dict]:
    """The drains of a trace's complete events and the idle after them:
    ({site: drains}, {site: device idle s in the gaps that began inside one
    of the site's drains}); the sites in the order of their first drain."""
    drains = sorted((e["ts"], e["ts"] + e.get("dur", 0),
                     e["name"][len(DRAIN_PREFIX):]) for e in spans
                    if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(DRAIN_PREFIX))
    count = {}
    for _, _, site in drains:
        count[site] = count.get(site, 0) + 1
    idle = dict.fromkeys(count, 0.0)
    starts = [lo for lo, _, _ in drains]
    end = None
    for lo, hi in sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in spans
                         if e.get("cat") in ("kernel",) + _COPY_CATS):
        if end is not None and lo > end:
            # the device idled from ``end`` to ``lo``: whose drain held it?
            i = bisect.bisect_right(starts, end) - 1
            if i >= 0 and end <= drains[i][1]:
                idle[drains[i][2]] += (lo - end) / 1e6   # us -> s
        end = hi if end is None else max(end, hi)
    return count, idle


def measured_stage_report(path: str) -> dict[str, float] | None:
    """Aggregate the trace's device-event durations by stage; logs a table.

    Returns {"OFE_solve": s, "compose": s, "warping": s, "OFE_expansion":
    s, "elementwise": s, "async_copies": s} (device seconds of the traced
    window), or None when there is no trace or it holds no device kernel.
    """
    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    spans = [e for e in events if e.get("ph") == "X"]
    # the device spans of the port's ranges, which do not nest: per pid,
    # sorted by start, so a kernel's range is found by bisection
    ranges = {}
    for e in spans:
        if e.get("cat") == "gpu_user_annotation" and e.get("name") in _RANGES:
            ranges.setdefault(e.get("pid"), []).append(
                (e["ts"], e["ts"] + e.get("dur", 0), _RANGES[e["name"]]))
    starts = {}
    for pid, rs in ranges.items():
        rs.sort()
        starts[pid] = [lo for lo, _, _ in rs]

    def stage(e):
        name = e.get("name", "")
        for pattern, kernel_stage in _KERNELS:
            if pattern.search(name):
                return kernel_stage
        rs = ranges.get(e.get("pid"))
        if not rs:
            return "elementwise"
        i = bisect.bisect_right(starts[e.get("pid")], e["ts"]) - 1
        return rs[i][2] if i >= 0 and e["ts"] <= rs[i][1] else "elementwise"

    totals = {"OFE_solve": 0.0, "compose": 0.0, "warping": 0.0,
              "OFE_expansion": 0.0, "elementwise": 0.0, "async_copies": 0.0}
    busy = 0.0
    for e in spans:
        cat = e.get("cat")
        dur = e.get("dur", 0) / 1e6   # us -> s
        if cat in _COPY_CATS:
            totals["async_copies"] += dur
        elif cat == "kernel":
            totals[stage(e)] += dur
            busy += dur

    if busy == 0.0:
        return None
    logging.info("[stages] MEASURED device time (torch.profiler trace of the "
                 "actual run):")
    for name, secs in sorted(totals.items(), key=lambda kv: -kv[1]):
        pct = 100.0 * secs / busy
        logging.info(f"[stages]   {name:14s} {secs:8.4f}s  ({pct:4.1f}%)")
    logging.info(f"[stages]   {'device busy':14s} {busy:8.4f}s "
                 "(memcpy and memset are excluded)")
    count, idle = _drain_idle(spans)
    logging.info(f"[stages]   {'drains':14s} {sum(count.values()):8d}   "
                 + ", ".join(f"{site} {n}" for site, n in count.items()))
    logging.info(f"[stages]   {'idle after':14s} {sum(idle.values()):8.4f}s  "
                 + ", ".join(f"{site} {s:.4f}s" for site, s in idle.items()))
    return totals

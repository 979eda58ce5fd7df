"""The traced window read into layers: one frozen rule puts every device
event into exactly one layer.

1. Events launched inside the harness's ``bench.probe`` span (the CLI's
   auto-bound probe, ahead of a volume's denoise) to the probe, whatever
   their kernel: by the host op that launched each (its thread and start
   inside the span), or, for an event launched outside any torch op, as a
   ctypes launch is, by the span's device span.
2. The port's kernels that the cells run, by symbol: ``umuf_kernel`` to
   the tap solve, ``sample_kernel`` to the tap warp,
   ``compose_run_kernel`` to the compose pass.  (The benchmark PR that
   adds a cell of another kernel form adds its pattern.)
3. Then matrix-product kernels (gemm, cutlass, xmma, nvjet) to the resize.
4. Then events launched inside the program's ``OFE_expansion`` range to
   the expansion pyramid, tested as in rule 1.
5. Then memcpy, memset, copies and index gathers (the pads and
   transposes) to the pipeline.
6. The rest is other elementwise work (casts, flow scaling, the tap FMA).

Rules 1 and 4 test a range by ``Trace.launched_in``.  Metrics may apply
the same test to other ranges beside the rule, as ``resize.ms`` does to the
program's ``fdt.resize``: such a reading crosses the layers and moves no
event between them.

Profiler ranges mirrored on the device (a device event with the name of a
host event) span kernels and are not work.  Busy time is the union of the
device events' intervals inside the benchmark's ``bench.window`` span.
"""

from __future__ import annotations

import dataclasses
import re

EXPANSION_RANGE = "OFE_expansion"
WINDOW_SPAN = "bench.window"
VOLUME_SPAN = "bench.denoise"
TO_HOST_SPAN = "bench.to_host"
PROBE_SPAN = "bench.probe"
# each separable resize of the program, both routes; read by ``resize.ms``
# alone, never by the rule
RESIZE_RANGE = "fdt.resize"

KERNELS = (
    (re.compile(r"\bumuf_kernel\b"), "tap solve"),
    (re.compile(r"\bsample_kernel\b"), "tap warp"),
    (re.compile(r"\bcompose_run_kernel\b"), "compose pass"),
)
MATMUL = ("gemm", "cutlass", "xmma", "nvjet")
PIPELINE = ("memcpy", "memset", "copy", "index")
# the layers of the program's denoise, by rules 2-6; rule 1's apart
LAYERS = ("tap solve", "tap warp", "compose pass", "resize",
          "expansion pyramid", "pipeline", "other elementwise")
PROBE_LAYER = "probe"
TOP = 10


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    device: bool     # ran on the device (else a host op or range)
    start: int       # ns
    end: int
    thread: int = 0
    corr: int = 0    # a host op's correlation id
    linked: int = 0  # a device event's: the host op that launched it


def from_profiler(prof) -> list[Event]:
    """The events of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        kind = ev.device_type()
        if kind not in (DeviceType.CPU, DeviceType.CUDA):
            continue
        out.append(Event(ev.name(), kind == DeviceType.CUDA, ev.start_ns(),
                         ev.end_ns(), ev.start_thread_id(),
                         ev.correlation_id(), ev.linked_correlation_id()))
    return out


def union(intervals) -> list[tuple[int, int]]:
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


class Trace:
    """A traced window of ``volumes`` volumes of ``cell``."""

    def __init__(self, events: list[Event], volumes: int, cell):
        self.cell = cell
        self.volumes = volumes
        host = [e for e in events if not e.device]
        names = {e.name for e in host}
        window = [e for e in host if e.name == WINDOW_SPAN]
        if len(window) != 1:
            raise ValueError(f"expected one {WINDOW_SPAN} span, found "
                             f"{len(window)}")
        self.lo, self.hi = window[0].start, window[0].end
        self.thread = window[0].thread
        self._host_events = host
        self._device_events = [e for e in events if e.device]
        self._ops = {e.corr: e for e in host if e.corr > 0 and not e.linked}
        in_probe = self.launched_in(PROBE_SPAN)
        in_expansion = self.launched_in(EXPANSION_RANGE)
        self.work = [e for e in events if e.device and e.name not in names
                     and e.end > self.lo and e.start < self.hi]
        self.layer_ns = dict.fromkeys((PROBE_LAYER,) + LAYERS, 0)
        self.layer_count = dict.fromkeys((PROBE_LAYER,) + LAYERS, 0)
        for e in self.work:
            name = layer(e, in_probe, in_expansion)
            self.layer_ns[name] += e.end - e.start
            self.layer_count[name] += 1
        self.busy = union((max(e.start, self.lo), min(e.end, self.hi))
                          for e in self.work)
        self.host = sorted((e for e in host if e.thread == self.thread),
                           key=lambda e: (e.start, -e.end))

    def launched_in(self, name: str):
        """A test of whether a device event was launched inside range
        ``name``: by the host op that launched it (its thread and start
        inside one of the range's host spans), or, for an event launched
        outside any torch op, as a ctypes launch is, by its start inside
        one of the range's device mirrors."""
        spans = [(e.thread, e.start, e.end) for e in self._host_events
                 if e.name == name]
        device_spans = [(e.start, e.end) for e in self._device_events
                        if e.name == name]
        ops = self._ops

        def test(ev: Event) -> bool:
            op = ops.get(ev.linked)
            if op is not None:
                return any(t == op.thread and lo <= op.start <= hi
                           for t, lo, hi in spans)
            return any(lo <= ev.start <= hi for lo, hi in device_spans)
        return test

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy) / 1e9

    def layer_ms(self, layer: str) -> float | None:
        """Device ms a volume of ``layer``; None where it ran nothing."""
        if not self.layer_count[layer]:
            return None
        return self.layer_ns[layer] / 1e6 / self.volumes

    def launches(self) -> float:
        return len(self.work) / self.volumes

    def gaps(self):
        """Idle intervals of the device inside the window."""
        edges = [self.lo] + [t for iv in self.busy for t in iv] + [self.hi]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def idle_by_host(self) -> dict:
        """Idle ns of the device by the innermost host op or range running
        on the loop's thread when each gap began ("python" where none
        was)."""
        idle, stack, i = {}, [], 0
        for a, b in self.gaps():
            while i < len(self.host) and self.host[i].start <= a:
                e = self.host[i]
                while stack and stack[-1].end < e.start:
                    stack.pop()
                stack.append(e)
                i += 1
            while stack and stack[-1].end < a:
                stack.pop()
            label = stack[-1].name if stack else "python"
            idle[label] = idle.get(label, 0) + (b - a)
        return idle

    def breakdown(self) -> dict:
        ops = {}
        for e in self.work:
            ops[e.name] = ops.get(e.name, 0) + (e.end - e.start)

        def top(d):
            return [[k[:160], v / 1e9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": top(ops),
                "idle_gaps": top(self.idle_by_host())}


def layer(e: Event, in_probe, in_expansion) -> str:
    """The rule above for one device event."""
    if in_probe(e):
        return PROBE_LAYER
    for pattern, name in KERNELS:
        if pattern.search(e.name):
            return name
    low = e.name.lower()
    if any(k in low for k in MATMUL):
        return "resize"
    if in_expansion(e):
        return "expansion pyramid"
    if any(k in low for k in PIPELINE):
        return "pipeline"
    return "other elementwise"

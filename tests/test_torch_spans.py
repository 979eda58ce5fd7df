"""The port's profiler spans (``utils/tracing.py: span``): the drains and
layer ranges a traced ``denoise`` opens, counted against what its shape
and flags imply; the helper with no profiler; the benchmark's
readers of the drain spans (``benchmarks/metrics/*drain*``) on hand-made
events; and, on the card (``-m cuda``), every stream sync of a traced
``denoise`` inside a drain span.

The file imports neither JAX nor the test suite's conftest, so the card
test runs on a machine with the card and no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_spans.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import spec  # noqa: E402
from benchmarks.trace import Event, Trace, from_profiler  # noqa: E402
from flowdenoising_tpu_torch.config import FilterConfig, FlowConfig  # noqa: E402
from flowdenoising_tpu_torch.core.pipeline import denoise  # noqa: E402
from flowdenoising_tpu_torch.kernels import get_gaussian_kernels  # noqa: E402
from flowdenoising_tpu_torch.utils import tracing  # noqa: E402

torch.set_num_threads(1)

DRAIN = tracing.DRAIN_PREFIX
LAYERS = (tracing.EXPANSION_RANGE, tracing.SOLVE_RANGE, tracing.WARP_RANGE,
          tracing.COMPOSE_RANGE, tracing.RESIZE_RANGE, tracing.PASS_RANGE)
# the runtime calls that hold the host until the device is done
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaMemGetInfo", "cudaHostAlloc")
# pass i filters axis i over planes of these axes (core/pipeline.py)
PASS_AXES = ((0, 1, 2), (1, 0, 2), (2, 0, 1))
# corr1d calls a pyramid level: the smoothing's two, poly_expand's nine
BLUR_INDEX_A_LEVEL = 11


def reckon(shape, cfg: FilterConfig, cuda: bool, array_input: bool) -> dict:
    """The spans a float32 wrap-boundary ``denoise`` of a (Z, Y, X) volume
    opens, by name, counted from its shape and flags: each pass pads once,
    builds one expansion pyramid of L + 1 levels (L from
    ``clamped_levels``), and solves 2 * ks2 tap flows (solve mode, each
    seeded by the tap before it within a run) or the adjacent flows once
    or twice (compose mode), every solve L + 1 levels with a resize
    between them and, where seeded, one to the coarsest level.  On the CPU
    a resize copies two weight matrices; on the card K-resize copies each
    tap table at its shape's first use only, which the warm call before
    the traced one has made.  On the card the float32 pyramid runs in
    the kernels, which copy no index vector; on the CPU (``cuda`` false)
    it runs the plain chain, whose correlations copy one each, the solves
    run the plain iteration, whose box sum is two more correlations an
    iteration, and nothing queries the device's memory."""
    f = cfg.flow
    want = dict.fromkeys(LAYERS, 0)
    want.update({DRAIN + s: 0 for s in ("input", "pad_index", "mem_info",
                                        "blur_index", "resize_matrix")})
    want[DRAIN + "input"] = int(array_input)
    for taps, axes in zip(get_gaussian_kernels(cfg.sigma), PASS_AXES):
        ks2 = len(taps) // 2
        h, w = shape[axes[1]], shape[axes[2]]
        levels = f.clamped_levels(h, w)
        seeded = int(f.use_initial_flow and levels > 0)
        if f.tap_mode == "solve":
            solves = 2 * ks2
            resizes = levels + 2 * (levels + (ks2 - 1) * (levels + seeded))
            want[tracing.WARP_RANGE] += 2 * ks2
        else:
            solves = 1 if f.symmetric_adjacent else 2
            resizes = levels + solves * levels
            want[tracing.COMPOSE_RANGE] += 1
        want[tracing.PASS_RANGE] += 1
        want[tracing.EXPANSION_RANGE] += 1
        want[tracing.SOLVE_RANGE] += solves * (levels + 1)
        want[tracing.RESIZE_RANGE] += resizes
        want[DRAIN + "pad_index"] += 1
        want[DRAIN + "mem_info"] += int(cuda)
        if not cuda:
            want[DRAIN + "blur_index"] += (
                BLUR_INDEX_A_LEVEL + 2 * f.iterations * solves) * (levels + 1)
        if not cuda:
            want[DRAIN + "resize_matrix"] += 2 * resizes
    return want


def _config(tap_mode: str) -> FilterConfig:
    return FilterConfig(sigma=(1.0, 1.0, 0.5), flow=FlowConfig(
        levels=2, min_size=4, tap_mode=tap_mode))


def _volume(shape=(8, 40, 36)) -> np.ndarray:
    r = np.random.default_rng(7)
    return (r.normal(size=shape) * 30 + 100).astype(np.float32)


def _traced(fn) -> list:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        fn()
    return from_profiler(prof)


def _counts(events) -> dict:
    counts = {}
    for e in events:
        if not e.device and (e.name in LAYERS or e.name.startswith(DRAIN)):
            counts[e.name] = counts.get(e.name, 0) + 1
    return counts


@pytest.mark.parametrize("tap_mode", ["solve", "compose"])
def test_a_traced_denoise_opens_the_reckoned_spans(tap_mode):
    vol = _volume()
    cfg = _config(tap_mode)
    events = _traced(lambda: denoise(vol, cfg, device="cpu"))
    want = {k: n for k, n in reckon(vol.shape, cfg, False, True).items() if n}
    assert _counts(events) == want
    # each route's layer spans: a solve pass warps, a compose pass composes
    assert (tracing.WARP_RANGE in want) == (tap_mode == "solve")
    assert (tracing.COMPOSE_RANGE in want) == (tap_mode == "compose")


def test_a_tensor_input_opens_no_input_drain():
    cfg = _config("compose")
    vol = torch.from_numpy(_volume((6, 24, 20)))
    events = _traced(lambda: denoise(vol, cfg))
    want = {k: n for k, n in reckon(vol.shape, cfg, False, False).items() if n}
    assert _counts(events) == want


def test_the_spans_nest_in_their_layers():
    """Every drain and layer span of a pass lies inside its ``fdt.pass``;
    each ``resize_matrix`` drain inside an ``fdt.resize``; each
    ``blur_index`` drain inside an ``OFE_expansion`` (or, on the CPU, the
    plain iteration's ``OFE_solve``)."""
    vol = torch.from_numpy(_volume())
    events = [e for e in _traced(lambda: denoise(vol, _config("solve")))
              if not e.device]

    def inside(e, name):
        return any(o.name == name and o.start <= e.start and e.end <= o.end
                   for o in events)

    for e in events:
        if e.name in LAYERS[:-1] or e.name.startswith(DRAIN):
            assert inside(e, tracing.PASS_RANGE), e
        if e.name == DRAIN + "resize_matrix":
            assert inside(e, tracing.RESIZE_RANGE), e
        if e.name == DRAIN + "blur_index":
            assert (inside(e, tracing.EXPANSION_RANGE)
                    or inside(e, tracing.SOLVE_RANGE)), e


def test_no_profiler_no_range(monkeypatch):
    """With no profiler the helper enters no ``record_function`` and makes
    no NVTX call: both raise here, and a denoise still runs."""
    def refuse(*args, **kwargs):
        raise AssertionError("a range was opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    assert tracing.span("a") is tracing.span("b")
    out = denoise(_volume((6, 24, 20)), _config("solve"), device="cpu")
    assert out.shape == (6, 24, 20)


def test_the_span_is_the_profilers_range():
    def body():
        with tracing.span("fdt.test"):
            torch.ones(4).add_(1)

    events = _traced(body)
    marks = [e for e in events if e.name == "fdt.test"]
    adds = [e for e in events if e.name == "aten::add_"]
    assert len(marks) == 1 and adds
    assert all(marks[0].start <= e.start <= marks[0].end for e in adds)


@pytest.mark.parametrize("tap_mode", ["solve", "compose"])
def test_the_denoise_output_is_the_same_traced_or_not(tap_mode):
    vol = _volume((6, 24, 20))
    cfg = _config(tap_mode)
    plain = denoise(vol, cfg, device="cpu")
    traced = []
    _traced(lambda: traced.append(denoise(vol, cfg, device="cpu")))
    assert torch.equal(plain, traced[0])


# --- the benchmark's readers of the drain spans --------------------------

READERS = ("pipeline.drains", "resize.drain_idle_ms",
           "expansion.drain_idle_ms", "pipeline.drain_idle_ms")
MS = 1e6   # ns


def _host(name, start, end, thread=1):
    return Event(name, False, start, end, thread)


def _device(start, end):
    return Event("kernel", True, start, end, 0)


def _trace(extra_host, volumes=2, marked=True):
    """A window of 10 ms with device work at 0-1, 1.5-3, 4-5, 7-8 and 9-10
    ms, so gaps at 1-1.5, 3-4, 5-7 and 8-9 ms; ``marked``: the program's
    spans are there (``fdt.pass``)."""
    host = [_host("bench.window", 0, 10 * MS),
            _host(tracing.EXPANSION_RANGE, 0, 2 * MS)]
    if marked:
        host.append(_host(tracing.PASS_RANGE, 0, 10 * MS))
    device = [_device(a * MS, b * MS) for a, b in
              ((0, 1), (1.5, 3), (4, 5), (7, 8), (9, 10))]
    return Trace(host + list(extra_host) + device, volumes, None)


def _read(trace):
    return {name: spec.reader(name)(trace) for name in READERS}


def test_readers_count_each_gap_whole_by_the_drain_it_began_in():
    drains = [
        # the 1-1.5 ms gap begins inside: 0.5 ms to the resize layer
        _host(DRAIN + "resize_matrix", 0.9 * MS, 1.2 * MS),
        # the 3-4 ms gap: 1 ms to the expansion pyramid
        _host(DRAIN + "blur_index", 2.5 * MS, 3.1 * MS),
        # the 5-7 ms gap: 2 ms to the pipeline, counted to the next event
        # though the drain ends first
        _host(DRAIN + "input", 4.5 * MS, 5.5 * MS),
        # the 8-9 ms gap begins outside any drain: counted nowhere, though
        # this one covers its end
        _host(DRAIN + "mem_info", 8.5 * MS, 9.5 * MS),
        # outside the window, and on another thread: not the loop's drains
        _host(DRAIN + "pad_index", 11 * MS, 12 * MS),
        _host(DRAIN + "pad_index", 7.5 * MS, 8.5 * MS, thread=2),
    ]
    got = _read(_trace(drains, volumes=2))
    assert got == pytest.approx({"pipeline.drains": 2.0,
                                 "resize.drain_idle_ms": 0.25,
                                 "expansion.drain_idle_ms": 0.5,
                                 "pipeline.drain_idle_ms": 1.0})


@pytest.mark.parametrize("site,reader", [
    ("resize_matrix", "resize.drain_idle_ms"),
    ("blur_index", "expansion.drain_idle_ms"),
    ("input", "pipeline.drain_idle_ms"),
    ("pad_index", "pipeline.drain_idle_ms"),
    ("pad_fill", "pipeline.drain_idle_ms"),
    ("mem_info", "pipeline.drain_idle_ms"),
])
def test_each_site_counts_toward_its_own_layer(site, reader):
    got = _read(_trace([_host(DRAIN + site, 4.9 * MS, 5.1 * MS)], volumes=1))
    want = {name: 0.0 for name in READERS[1:]}
    want[reader] = 2.0
    want["pipeline.drains"] = 1.0
    assert got == pytest.approx(want)


def test_readers_read_zero_without_drains_and_nothing_without_spans():
    assert _read(_trace([])) == dict.fromkeys(READERS, 0.0)
    assert _read(_trace([], marked=False)) == dict.fromkeys(READERS)


# --- on the card ----------------------------------------------------------

@pytest.mark.cuda
def test_every_blocking_call_of_a_denoise_on_the_card_is_a_drain_span():
    """A warm solve and compose ``denoise`` of a host array, traced: every
    sync, ``cudaMemGetInfo`` and ``cudaHostAlloc`` inside the call lies in
    an ``fdt.drain.*`` span, and there is one drain span for each sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    vol = _volume((24, 96, 80))
    for tap_mode in ("solve", "compose"):
        cfg = _config(tap_mode)
        denoise(vol, cfg)
        torch.cuda.synchronize()

        def body():
            with torch.profiler.record_function("test.denoise"):
                denoise(vol, cfg)
            torch.cuda.synchronize()

        host = [e for e in _traced(body) if not e.device]
        call = [e for e in host if e.name == "test.denoise"]
        assert len(call) == 1
        lo, hi, thread = call[0].start, call[0].end, call[0].thread
        drains = [e for e in host if e.name.startswith(DRAIN)
                  and e.thread == thread and lo <= e.start <= hi]
        blocking = [e for e in host if e.name in BLOCKING
                    and e.thread == thread and lo <= e.start <= hi]
        outside = [e.name for e in blocking
                   if not any(d.start <= e.start and e.end <= d.end
                              for d in drains)]
        assert blocking and not outside, (tap_mode, outside)
        assert len(blocking) == len(drains), tap_mode
        assert _counts(host) == {k: n for k, n in reckon(
            vol.shape, cfg, True, True).items() if n}, tap_mode

"""The benchmark harness on the CPU: its imports, its files found by name,
its window arithmetic, its work counts, its layer rule, its reference (in
windows of output planes too) and its plain auto-bound probe against the
port's CPU path, and ``correct`` coming out false for a broken program and
for the lower-precision control.

    python -m pytest -p no:cacheprovider benchmarks/tests -q
"""

import ast
import copy
import dataclasses
import hashlib
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmarks import spec, trace, volumes, work  # noqa: E402
from benchmarks.reference import autodisp, plain  # noqa: E402
from benchmarks.run import (  # noqa: E402
    FORBIDDEN, Program, cache_bytecode, closed_loop, reference, run)

HERE = ROOT / "benchmarks"
CPU = torch.device("cpu")


def imported(path: Path) -> set:
    """Top-level names of the modules a file imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not imported(path) & set(FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert imported(path) <= {"__future__", "contextlib", "functools",
                                  "numpy", "torch"}, path


def test_every_cell_and_metric_resolves_to_its_files():
    bench = spec.benchmark()
    for entry in bench["configs"]:
        assert (ROOT / entry["file"]).is_relative_to(HERE)
    for w in bench["workloads"]:
        cell = spec.load(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert set(cell.limits) == {"max_err", "rms_err"}
        assert {m["name"] for m in cell.end_to_end} >= {"mvoxel_s", "setup_s"}
        assert cell.per_layer
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def _hashes(root: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmarks").rglob("*")) if p.is_file()}


def _copy_benchmark(root: Path) -> Path:
    """``BENCHMARK.json`` and ``benchmarks/`` copied into ``root``; returns
    the copy of ``benchmarks/``."""
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(HERE, root / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root / "benchmarks"


def _add_entries(root: Path, **entries):
    """Each list of ``entries`` appended to its key of the copy's
    ``BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for key, added in entries.items():
        bench[key].extend(added)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_new_config_mix_and_metric_are_found_as_new_files(tmp_path):
    here = _copy_benchmark(tmp_path)
    before = _hashes(tmp_path)
    config = json.loads((here / "configs/epfl_ca1_165x768x1024.json").read_text())
    config.update(name="tiny_8x40x40")
    config["volume"]["shape"] = [8, 40, 40]
    (here / "configs/tiny_8x40x40.json").write_text(json.dumps(config))
    mix = json.loads((here / "traffic/compose_f32.json").read_text())
    mix.update(name="compose_symmetric_f32")
    mix["flow"]["symmetric_adjacent"] = True
    (here / "traffic/compose_symmetric_f32.json").write_text(json.dumps(mix))
    (here / "limits/tiny.symmetric.json").write_text(
        json.dumps({"max_err": 1e-6, "rms_err": 1e-7}))
    (here / "metrics/tiny.launches.py").write_text(
        "def read(trace):\n    return 2 * trace.launches()\n")
    _add_entries(
        tmp_path,
        configs=[{"name": "tiny_8x40x40", "source": "x",
                  "file": "benchmarks/configs/tiny_8x40x40.json",
                  "reduced": [], "why": "x"}],
        workloads=[{"name": "tiny.symmetric", "config": "tiny_8x40x40",
                    "traffic": "compose_symmetric_f32", "chips": 1,
                    "why": "x"}],
        per_layer=[{"name": "tiny.launches", "unit": "launches",
                    "better": "lower", "source": "device_trace",
                    "layer": "pipeline", "moves": "mvoxel_s",
                    "workloads": ["tiny.symmetric"]}])

    cell = spec.load("tiny.symmetric", root=tmp_path)
    assert cell.shape == (8, 40, 40)
    assert cell.flow["symmetric_adjacent"] and cell.flow["tap_mode"] == "compose"
    assert "tiny.launches" in [m["name"] for m in cell.per_layer]
    assert "tiny.launches" not in [m["name"] for m in
                                   spec.load("epfl.solve", tmp_path).per_layer]

    class Fake:
        def launches(self):
            return 21.0

    assert spec.reader("tiny.launches", tmp_path)(Fake()) == 42.0
    after = _hashes(tmp_path)
    assert {p: h for p, h in after.items() if p in before} == before


def test_the_window_counts_every_volume_and_all_its_time():
    # volumes take 0.1 s but the 6th stalls for 2 s; --seconds 1.5
    t = [0.0]
    durations = iter([0.1] * 5 + [2.0] + [0.1] * 20)

    def clock():
        return t[0]

    def step(vol):
        t[0] += next(durations)
        return vol

    window, kept = closed_loop(step, [0, 1, 2, 3], 1.5, keep=2, clock=clock)
    # the stall ends at 2.5 s, after --seconds: the window ends there
    assert len(window.spans) == 6 and window.seconds == pytest.approx(2.5)
    assert kept == [2]
    assert window.mvoxel_s(10**6) == pytest.approx(6 / 2.5)
    walls = [0.1] * 5 + [2.0]
    assert window.walls == pytest.approx(walls)
    # at least one round of the pool, however short --seconds
    t[0] = 0.0
    durations = iter([0.1] * 8)
    window, _ = closed_loop(step, [0, 1, 2, 3], 0.0, clock=clock)
    assert len(window.spans) == 4


def test_bytecode_is_kept_in_the_checkout(tmp_path, monkeypatch):
    # an environment that forbids writing bytecode recompiled torch on
    # every start; the run keeps it at a fixed path inside the checkout
    monkeypatch.setattr(sys, "pycache_prefix", None)
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    cache_bytecode(tmp_path)
    assert sys.pycache_prefix == str(tmp_path / "build" / "pycache")
    assert not sys.dont_write_bytecode


FLOW = {"levels": 3, "winsize": 5, "iterations": 3, "poly_n": 5,
        "poly_sigma": 1.2, "pyr_scale": 0.5, "min_size": 32,
        "use_initial_flow": True, "max_displacement": 8,
        "adjacent_displacement": 4, "presmooth": 0.0, "tap_mode": "solve",
        "symmetric_adjacent": False}


def test_the_work_counts_by_hand():
    # a 64^3 cube, sigma 1: ks2 4, stacks of 72 planes, levels 64^2 and
    # 32^2 (16 < min_size 32), 5120 px a plane; the three passes alike
    shape, sigma = (64, 64, 64), (1.0, 1.0, 1.0)
    solve = work.tap_solve(shape, sigma, FLOW)
    assert solve.flops == 3 * (8 * 64 * 5120 * 3 * 137)
    assert solve.bytes == 3 * 4 * (72 * 5120 * 5 + 8 * 64 * 4096 * 2)
    assert solve.bound == "operations"
    composed = work.tap_solve(shape, sigma, {**FLOW, "tap_mode": "compose"})
    assert composed.flops == 3 * (2 * 71 * 5120 * 3 * 137)
    assert composed.bytes == 3 * 4 * (72 * 5120 * 5 + 2 * 71 * 4096 * 2)
    # blur taps 3 (level 0) and 3 (level 1): 2 * 2 * 6 flop a full pixel;
    # nine 11-tap filters and nine combining operations a level pixel
    pyr = work.expansion(shape, sigma, FLOW)
    assert pyr.flops == 3 * 72 * (24 * 4096 + 207 * 5120)
    assert pyr.bytes == 3 * 4 * 72 * (4096 + 5 * 5120)
    assert pyr.bound == "bytes"
    comp = work.compose(shape, sigma, FLOW)
    assert comp.flops == 3 * 8 * 42 * 64 * 4096
    assert comp.bytes == 3 * 4 * 4096 * (2 * 71 * 2 + 72 + 2 * 64)
    assert comp.least_ms == pytest.approx(
        1e3 * max(comp.bytes / 3.35e12, comp.flops / 67e12))


class _Cell:
    shape = (4, 64, 64)
    config = {"sigma": [1.0, 1.0, 1.0]}
    flow = FLOW


def _events(solve_launches: int):
    """A window of one volume: the host window, an OFE_expansion range
    with one op in it, ops outside; the device kernels of each layer."""
    E = trace.Event
    ev = [E("bench.window", False, 0, 10_000, thread=1),
          E("bench.denoise", False, 10, 9_000, thread=1),
          E("OFE_expansion", False, 100, 2_000, thread=1),
          E("aten::mul", False, 200, 300, thread=1, corr=5),
          E("aten::index_select", False, 2_100, 2_200, thread=1, corr=6),
          E("aten::add_", False, 2_300, 2_400, thread=1, corr=7),
          E("aten::copy_", False, 9_100, 9_900, thread=1, corr=8),
          E("OFE_expansion", True, 250, 1_500),
          E("void at::native::vectorized_elementwise_kernel<4>(mul)", True,
            300, 1_000, linked=5),
          E("void at::native::indexSelectLargeIndex<float>", True,
            2_150, 2_250, linked=6),
          E("void at::native::vectorized_elementwise_kernel<4>(add)", True,
            2_400, 2_500, linked=7),
          E("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n", True, 2_500, 2_600),
          E("void sample_kernel(float const*)", True, 5_000, 5_400),
          E("void compose_run_kernel<float>(float const*)", True, 5_400,
            5_500),
          E("Memcpy DtoH (Device -> Pageable)", True, 9_200, 9_800, linked=8)]
    step = 2_000 // solve_launches
    ev += [E("void umuf_kernel<float>(float const*)", True,
             3_000 + i * step, 3_000 + (i + 1) * step)
           for i in range(solve_launches)]
    return ev


def test_the_layer_rule_and_the_idle_share():
    t = trace.Trace(_events(1), 1, _Cell())
    ms = {layer: t.layer_ms(layer) for layer in trace.LAYERS}
    assert ms == pytest.approx({
        "tap solve": 2_000e-6, "tap warp": 400e-6, "compose pass": 100e-6,
        "resize": 100e-6, "expansion pyramid": 700e-6,
        "pipeline": 100e-6 + 600e-6, "other elementwise": 100e-6})
    # the mirrored range is no work; busy is the union of the rest
    assert t.launches() == 8
    assert t.busy_s == pytest.approx((700 + 100 + 200 + 2_000 + 500 + 600)
                                     / 1e9)
    assert t.window_s == pytest.approx(10_000 / 1e9)
    idle = t.idle_by_host()
    assert sum(idle.values()) == 10_000 - 4_100
    assert idle == {"bench.window": 300, "OFE_expansion": 1_150,
                    "bench.denoise": 150 + 400 + 3_700, "aten::copy_": 200}
    assert spec.reader("device.idle_pct")(t) == pytest.approx(59.0)
    assert spec.reader("tap_warp.ms")(t) == pytest.approx(0.0004)
    out = t.breakdown()
    assert out["device_ops"][0] == ["void umuf_kernel<float>(float const*)",
                                    2e-6]
    assert len(out["idle_gaps"]) <= trace.TOP


def _probe_events():
    """A probe ahead of the window's volume: the host span with an op in
    it, the op's kernel and a ctypes K-umuf launch (no op) inside the
    span's device mirror."""
    E = trace.Event
    return [E("bench.probe", False, 9_950, 9_990, thread=1),
            E("aten::minimum", False, 9_955, 9_960, thread=1, corr=9),
            E("bench.probe", True, 9_956, 9_985),
            E("void at::native::vectorized_elementwise_kernel<4>(min)", True,
              9_958, 9_966, linked=9),
            E("void umuf_kernel<float>(float const*)", True, 9_970, 9_982)]


def test_the_probe_layer_takes_what_the_probe_launched():
    before = trace.Trace(_events(1), 1, _Cell())
    t = trace.Trace(_events(1) + _probe_events(), 1, _Cell())
    assert t.layer_ms(trace.PROBE_LAYER) == pytest.approx((8 + 12) * 1e-6)
    assert before.layer_ms(trace.PROBE_LAYER) is None
    for name in trace.LAYERS:
        assert t.layer_ms(name) == before.layer_ms(name), name
    assert spec.reader("probe.ms")(t) == pytest.approx(20e-6)
    assert spec.reader("probe.wall_ms")(t) == pytest.approx(40e-6)
    assert spec.reader("probe.wall_ms")(before) is None


def _resize_launches():
    """Resizes' device work beside ``_events`` and ``_probe_events``: a
    K-resize downsample launched by ctypes inside the pyramid, a dense
    product launched by a host op, another by an op on a second thread, a
    K-resize flow upsample, one launched inside the probe and one outside
    every resize."""
    E = trace.Event
    return [E("_anonymous_namespace_::resize_kernel<2>(float const*)", True,
              1_100, 1_300),
            E("aten::bmm", False, 2_650, 2_660, thread=1, corr=12),
            E("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n", True, 2_700, 2_900,
              linked=12),
            E("aten::bmm", False, 2_670, 2_680, thread=2, corr=13),
            E("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n", True, 2_900, 2_950,
              linked=13),
            E("_anonymous_namespace_::resize_tile_kernel(float const*)",
              True, 6_000, 6_300),
            E("_anonymous_namespace_::resize_tile_kernel(float const*)",
              True, 9_982, 9_985),
            E("_anonymous_namespace_::resize_kernel<0>(float const*)", True,
              7_000, 7_100),
            E("fdt.pass", False, 20, 8_900, thread=1),
            E("fdt.drain.input", False, 2_940, 2_990, thread=1)]


def _resize_spans():
    """The program's ``fdt.resize`` ranges around the first four launches
    of ``_resize_launches`` and the probe's: each host span on the loop's
    thread, and its device mirror where the range launched by ctypes."""
    E = trace.Event
    return [E("fdt.resize", False, 1_050, 1_090, thread=1),
            E("fdt.resize", True, 1_100, 1_300),
            E("fdt.resize", False, 2_640, 2_700, thread=1),
            E("fdt.resize", True, 2_700, 2_900),
            E("fdt.resize", False, 5_900, 5_950, thread=1),
            E("fdt.resize", True, 6_000, 6_300),
            E("fdt.resize", False, 9_962, 9_968, thread=1),
            E("fdt.resize", True, 9_982, 9_985)]


def _resize_traces():
    """The window without and with the ``fdt.resize`` ranges."""
    base = _events(1) + _probe_events() + _resize_launches()
    return (trace.Trace(base, 1, _Cell()),
            trace.Trace(base + _resize_spans(), 1, _Cell()))


def test_resize_ms_reads_what_was_launched_in_the_resize_range():
    without, t = _resize_traces()
    read = spec.reader("resize.ms")
    # the downsample and the flow upsample by the range's device mirror,
    # the thread-1 product by its op; not the second thread's product
    # (inside the mirror, but its op is not in the range), not the probe's
    # K-resize, not the launch and the gemm outside every range
    assert read(t) == pytest.approx((200 + 200 + 300) * 1e-6)
    assert read(without) is None
    assert read(trace.Trace(_events(1), 1, _Cell())) is None
    in_resize = t.launched_in(trace.RESIZE_RANGE)
    by_start = {e.start: e for e in t.work}
    assert [in_resize(by_start[a]) for a in
            (1_100, 2_700, 2_900, 6_000, 9_982, 7_000, 2_500)] == [
        True, True, False, True, True, False, False]
    assert t.launched_in(trace.PROBE_SPAN)(by_start[9_982])


def test_the_resize_ranges_move_no_layer_and_no_other_reading():
    without, t = _resize_traces()
    for name in (trace.PROBE_LAYER,) + trace.LAYERS:
        assert t.layer_ms(name) == without.layer_ms(name), name
    assert t.launches() == without.launches()
    assert t.busy == without.busy
    read = 0
    for m in spec.benchmark()["per_layer"]:
        if m["name"] == "resize.ms":
            continue
        value = spec.reader(m["name"])(t)
        assert value == spec.reader(m["name"])(without), m["name"]
        read += value is not None
    assert read >= 10


def test_a_roofline_share_is_unchanged_by_more_launches():
    one = spec.reader("tap_solve.roofline_pct")(trace.Trace(_events(1), 1,
                                                            _Cell()))
    four = spec.reader("tap_solve.roofline_pct")(trace.Trace(_events(4), 1,
                                                             _Cell()))
    assert one == pytest.approx(four)
    least = work.tap_solve(_Cell.shape, _Cell.config["sigma"], FLOW).least_ms
    assert one == pytest.approx(100 * least / 0.002)


def tiny(workload: str, shape=(8, 64, 64)):
    cell = spec.load(workload)
    cell.config = copy.deepcopy(cell.config)
    cell.config["volume"]["shape"] = list(shape)
    return cell


@pytest.mark.parametrize("workload", ["epfl.solve", "czii.compose",
                                      "czii.auto"])
def test_the_reference_is_the_ports_cpu_path(workload):
    from flowdenoising_tpu_torch.core.autodisp import (
        resolve_auto_displacement)
    from flowdenoising_tpu_torch.core.pipeline import denoise

    cell = tiny(workload, (12, 64, 72))
    vol = volumes.volume(cell.config, 3, 0, CPU).numpy()
    ref = reference(cell, vol, CPU)
    cfg = Program(cell, CPU).cfg
    if cell.flow["max_displacement"] == "auto":
        cfg = resolve_auto_displacement(vol, cfg, device="cpu")
    out = denoise(vol, cfg, device="cpu")
    assert torch.equal(out, ref)
    assert not torch.equal(ref, torch.as_tensor(vol))


# (Z, Y, X) 20 x 64 x 66 at sigma 0.5 (ks2 2): planes of 4224, 1320 and
# 1280 pixels; a window of WINDOW_PIXELS holds 6, 28 and 29 output planes
# (4, 3 and 3 windows, the last short), a tap-solve block of BLOCK_PIXELS 1,
# 1 and 2 planes
SMALL = (20, 64, 66)
SMALL_SIGMA = [0.5, 0.5, 0.5]
WINDOW_PIXELS = 42240
BLOCK_PIXELS = 2600
FLOWS = {"solve": ("epfl.solve", False), "compose": ("epfl.compose", False),
         "symmetric": ("epfl.compose", True)}


def small(flow: str):
    """A cell of ``FLOWS[flow]`` cut to ``SMALL`` at ``SMALL_SIGMA``."""
    workload, symmetric = FLOWS[flow]
    cell = tiny(workload, SMALL)
    cell.config["sigma"] = list(SMALL_SIGMA)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["flow"]["symmetric_adjacent"] = symmetric
    return cell


def test_small_budgets_split_every_pass():
    for n, h, w, ks2 in work.passes(SMALL, SMALL_SIGMA):
        spans = plain.windows(n, h, w, ks2, WINDOW_PIXELS)
        assert len(spans) >= 3
        assert spans[-1][1] - spans[-1][0] < spans[0][1] - spans[0][0]
        assert [a for a, _ in spans[1:]] == [b for _, b in spans[:-1]]
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert plain.block_planes(h, w, BLOCK_PIXELS) in (1, 2)


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_the_windowed_reference_is_the_whole_pass(flow):
    cell = small(flow)
    vol = volumes.volume(cell.config, 2**31 + 3, 0, CPU).numpy()
    args = (vol, SMALL_SIGMA, cell.flow, cell.flow["tap_mode"], CPU)
    whole = plain.denoise(*args)
    windowed = plain.denoise(*args, pixels=BLOCK_PIXELS,
                             window_pixels=WINDOW_PIXELS)
    assert torch.equal(windowed, whole)
    assert not torch.equal(whole, torch.as_tensor(vol))


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_the_windowed_reference_is_the_ports_slabbed_path(flow):
    from flowdenoising_tpu_torch.core.pipeline import denoise

    cell = small(flow)
    vol = volumes.volume(cell.config, 2**31 + 4, 0, CPU).numpy()
    cfg = dataclasses.replace(Program(cell, CPU).cfg, slab_size=5)
    out = denoise(vol, cfg, device="cpu")
    ref = plain.denoise(vol, SMALL_SIGMA, cell.flow, cell.flow["tap_mode"],
                        CPU, pixels=BLOCK_PIXELS, window_pixels=WINDOW_PIXELS)
    assert torch.equal(out, ref)


# The cells measured before the reference took windows.  A later cell may
# take several (test_every_cells_reference_windows_cover_each_pass).
ONE_WINDOW = ("epfl.solve", "czii.compose", "czii.solve", "epfl.compose",
              "czii.auto")


@pytest.mark.parametrize("workload", ONE_WINDOW)
def test_every_cells_passes_run_whole_in_full_blocks(workload):
    # the budgets leave the cells' reference arithmetic as it was before
    # the windows: one window a pass, BLOCK planes a tap solve
    cell = spec.load(workload)
    for n, h, w, ks2 in work.passes(cell.shape, cell.config["sigma"]):
        assert plain.windows(n, h, w, ks2) == [(0, n)]
        assert plain.block_planes(h, w) == plain.BLOCK


def reference_windows(shape, sigma) -> list:
    """The reference's windows of each pass of a ``shape`` volume, checked:
    they tile the pass's output planes in order, with no gap and no
    overlap; each window's planes and its 2 ks2 halo planes fit
    ``WINDOW_PIXELS``, or it holds one output plane; its tap-solve blocks
    hold 1 to ``BLOCK`` planes, within ``PIXELS`` where more than one."""
    found = []
    for n, h, w, ks2 in work.passes(shape, sigma):
        spans = plain.windows(n, h, w, ks2)
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert [a for a, _ in spans[1:]] == [b for _, b in spans[:-1]]
        for a, b in spans:
            assert b > a
            assert (b - a + 2 * ks2) * h * w <= plain.WINDOW_PIXELS or (
                b - a == 1)
        block = plain.block_planes(h, w)
        assert 1 <= block <= plain.BLOCK
        assert block * h * w <= plain.PIXELS or block == 1
        found.append(spans)
    return found


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.benchmark()["workloads"]])
def test_every_cells_reference_windows_cover_each_pass(workload):
    cell = spec.load(workload)
    assert len(reference_windows(cell.shape, cell.config["sigma"])) == 3


FULL_FRAME = (256, 1536, 2048)


def test_a_full_frame_cell_is_added_as_new_files(tmp_path):
    # the EPFL CA1 section's whole planes, 256 slices deep, on solve_f32:
    # a configuration, a cell and its limits as new files and entries;
    # only planned here, no volume made
    here = _copy_benchmark(tmp_path)
    before = _hashes(tmp_path)
    name = "epfl_ca1_256x1536x2048"
    config = json.loads((here / "configs/epfl_ca1_165x768x1024.json")
                        .read_text())
    config.update(name=name, reduced=["volume"])
    config["volume"].update(shape=list(FULL_FRAME), blobs=116)
    (here / f"configs/{name}.json").write_text(json.dumps(config))
    (here / "limits/epfl_full.solve.json").write_text(
        (here / "limits/epfl.solve.json").read_text())
    _add_entries(
        tmp_path,
        configs=[{"name": name, "source": "x",
                  "file": f"benchmarks/configs/{name}.json",
                  "reduced": ["volume"], "why": "x"}],
        workloads=[{"name": "epfl_full.solve", "config": name,
                    "traffic": "solve_f32", "chips": 1, "why": "x"}])

    cell = spec.load("epfl_full.solve", root=tmp_path)
    assert cell.shape == FULL_FRAME and cell.flow["tap_mode"] == "solve"
    assert cell.limits == spec.load("epfl.solve").limits
    assert cell.per_layer
    # Z: 29 output planes a window; Y: 256; X: 346; the Z pass's tap
    # solves in blocks of 32 planes
    spans = reference_windows(cell.shape, cell.config["sigma"])
    assert [len(s) for s in spans] == [9, 6, 6]
    assert [s[0][1] for s in spans] == [29, 256, 346]
    assert plain.block_planes(*FULL_FRAME[1:]) == 32
    after = _hashes(tmp_path)
    assert {p: h for p, h in after.items() if p in before} == before


def test_a_sound_run_is_correct():
    cell = tiny("czii.compose")
    result, compared = run(cell, 2**31 + 11, 0.0, False, CPU, 0.0)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == 4
    assert compared["max_err"]["value"] == 0.0
    assert set(result["metrics"]) == {"mvoxel_s", "peak_gib", "setup_s"}


def _unchanged(program):
    return lambda vol: vol.copy()


def _half_left_out(program):
    def step(vol):
        # the first half of the Z planes filtered; the rest left as they came
        out = program(vol)
        half = vol.shape[0] // 2
        out[half:] = vol[half:]
        return out
    return step


def _altered(program):
    def step(vol):
        out = program(vol)
        out[1, 2, 3] += 0.25 * (out.max() - out.min())
        return out
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _altered])
@pytest.mark.parametrize("workload", ["epfl.solve", "czii.compose",
                                      "czii.auto"])
def test_a_broken_program_is_not_correct(workload, fault):
    cell = tiny(workload)
    program = Program(cell, CPU)
    result, compared = run(cell, 5, 0.0, False, CPU, 0.0, fault(program))
    assert not result["correct"]
    assert result["failed"] >= 1
    assert any(v["value"] > v["limit"] for v in compared.values())


def _drifting(p, shape, r, device):
    """Blobs that translate ``speed`` px a Z slice along x, plus noise: at
    the far tap distance 8 the motion is 16 px, past the fixed D 8."""
    n, h, w = shape
    pad = int(np.ceil(p["speed"] * n)) + 4
    yy, xx = np.mgrid[:h, :w + pad]
    base = np.zeros((h, w + pad))
    for _ in range(int(p["blobs"])):
        cy, cx = r.uniform(0, h), r.uniform(0, w + pad)
        rad, amp = r.uniform(2, 5), r.uniform(50, 150)
        base += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                             / (2 * rad * rad))
    vol = np.stack([base[:, int(round(z * p["speed"])):][:, :w]
                    for z in range(n)])
    vol += r.normal(0, p["noise"], vol.shape)
    return torch.as_tensor(vol, dtype=torch.float32, device=device)


DRIFT = {"generator": "drifting", "shape": [12, 64, 64], "speed": 2.0,
         "blobs": 30, "noise": 4.0}


@pytest.fixture
def drifting(monkeypatch):
    """``czii.auto`` on the drifting volumes."""
    monkeypatch.setitem(volumes.GENERATORS, "drifting", _drifting)
    cell = tiny("czii.auto")
    cell.config["volume"] = dict(DRIFT)
    return cell


def _probes(vol, cell, monkeypatch):
    """(the port's pick, the plain probe's, the port's curves, the plain
    probe's) of ``vol``, every group of every probe call in order."""
    from flowdenoising_tpu_torch.core import autodisp as port

    curves = {"port": [], "plain": []}
    runs = {"port": port._run_probe, "plain": autodisp.run_probe}

    def recording(side):
        def run_probe(groups, ladders, flow, device):
            out = runs[side](groups, ladders, flow, device)
            curves[side].append(out)
            return out
        return run_probe

    monkeypatch.setattr(port, "_run_probe", recording("port"))
    monkeypatch.setattr(autodisp, "run_probe", recording("plain"))
    theirs = port.probe_displacement(vol, Program(cell, CPU).cfg,
                                     device="cpu")
    ours = autodisp.probe(vol, cell.config["sigma"], cell.flow, CPU)
    return theirs, ours, curves["port"], curves["plain"]


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 7])
@pytest.mark.parametrize("config", ["czii_184x630x630",
                                    "epfl_ca1_165x768x1024", "drifting"])
def test_the_plain_probe_is_the_ports(config, seed, monkeypatch):
    monkeypatch.setitem(volumes.GENERATORS, "drifting", _drifting)
    cell = tiny("czii.auto", (12, 64, 72))
    if config == "drifting":
        cell.config["volume"] = dict(DRIFT)
    else:
        cell.config["volume"] = {**json.loads(
            (HERE / "configs" / f"{config}.json").read_text())["volume"],
            "shape": [12, 64, 72]}
    vol = volumes.volume(cell.config, seed, 0, CPU).numpy()
    theirs, ours, port_curves, plain_curves = _probes(vol, cell, monkeypatch)
    # bit for bit: every group's clamp-cost curve, base and identity error
    assert plain_curves == port_curves and len(port_curves) >= 1
    assert ours == theirs
    if config == "drifting":
        assert ours[0] > 8


def test_the_plain_probes_constants_are_the_ports():
    import inspect

    from flowdenoising_tpu_torch.core import autodisp as port

    assert (autodisp.D_LADDER, autodisp.ADJ_LADDER, autodisp.BENEFIT_TOL,
            autodisp.N_PAIRS, autodisp.UNTRACKED_FRAC) == (
        port._D_LADDER, port._ADJ_LADDER, port._BENEFIT_TOL, port._N_PAIRS,
        port._UNTRACKED_FRAC)
    extent = inspect.signature(port.probe_displacement).parameters[
        "probe_extent"].default
    assert autodisp.EXTENT == extent
    for h, w in [(96, 96), (160, 512), (512, 160), (300, 280), (184, 630)]:
        for e in (extent, 2 * extent):
            assert autodisp.bucket(h, w, e) == port._bucket_shape(h, w, e)


def _curves(far, adj):
    """A probe whose every far group reads ``far`` and every adjacent group
    ``adj``: (curve over the ladder, base, ident) of a clamp cost that
    falls by ``step`` a rung to 0."""
    def fake(groups, ladders, flow, device):
        out = []
        for ladder in ladders:
            start, step, base, ident = far if ladder[0] == 4 else adj
            out.append(([base + max(start - i * step, 0.0)
                         for i in range(len(ladder))], base, ident))
        return out
    return fake


@pytest.mark.parametrize("far,adj", [
    ((4.3, 0.9, 23.0, 31.0), (1.0, 0.5, 2.0, 9.0)),    # pick by the benefit
    ((0.9, 0.2, 1.0, 10.0), (0.0, 0.0, 9.6, 10.0)),    # adjacent untracked
    ((0.0, 0.0, 9.5, 10.0), (0.2, 0.1, 2.0, 9.0)),     # far untracked
    ((0.16, 0.0, 1.0, 9.0), (0.17, 0.0, 1.0, 9.0)),    # at the tolerance
    ((9.0, 0.1, 1.0, 20.0), (9.0, 0.1, 1.0, 20.0)),    # past the ladders
])
def test_the_plain_probe_picks_as_the_port_picks(far, adj, monkeypatch):
    from flowdenoising_tpu_torch.core import autodisp as port

    cell = tiny("czii.auto", (12, 40, 48))
    vol = volumes.volume(cell.config, 1, 0, CPU).numpy()
    monkeypatch.setattr(port, "_run_probe", _curves(far, adj))
    monkeypatch.setattr(autodisp, "run_probe", _curves(far, adj))
    assert autodisp.probe(vol, cell.config["sigma"], cell.flow, CPU) == \
        port.probe_displacement(vol, Program(cell, CPU).cfg, device="cpu")


def _probe_skipped(program):
    # the CLI's fixed default D 8 and FlowConfig's adjacent 4, no probe
    program.resolve = lambda vol, cfg, device=None: cfg
    return program


def test_a_sound_auto_run_is_correct_and_names_both_picks(drifting, capsys):
    result, compared = run(drifting, 2**31 + 5, 0.0, False, CPU, 0.0)
    assert result["correct"] and result["failed"] == 0
    assert compared["pick_gap"] == {"value": 0, "limit": 0}
    assert compared["max_err"]["value"] == 0.0
    err = capsys.readouterr().err
    assert "the program's [(" in err and "the plain probe's (" in err


def test_a_program_that_skips_the_probe_is_not_correct(drifting):
    program = Program(drifting, CPU)
    seed = 2**31 + 5
    vol = volumes.pool(drifting.config, drifting.traffic, seed, CPU)[
        volumes.sampled(drifting.traffic, seed)]
    assert autodisp.probe(vol, drifting.config["sigma"], drifting.flow,
                          CPU)[0] > 8
    result, compared = run(drifting, seed, 0.0, False, CPU, 0.0,
                           _probe_skipped(program))
    assert not result["correct"]
    assert result["failed"] >= 1
    assert compared["pick_gap"]["value"] > 0
    assert any(compared[k]["value"] > compared[k]["limit"]
               for k in ("max_err", "rms_err"))


def test_volumes_repeat_from_the_seed_and_differ_across_the_pool():
    cell = tiny("epfl.solve", (6, 40, 40))
    big = 2**31 + 12345
    a = volumes.pool(cell.config, cell.traffic, big, CPU)
    b = volumes.pool(cell.config, cell.traffic, big, CPU)
    assert len(a) == 4 and all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], a[1])
    m = tiny("czii.compose", (6, 40, 40))
    c = volumes.pool(m.config, m.traffic, big, CPU)
    assert all(np.array_equal(x, y) for x, y in
               zip(c, volumes.pool(m.config, m.traffic, big, CPU)))
    assert all(x.dtype == np.float32 for x in a + c)
    assert not np.array_equal(c[0], c[1])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["epfl.solve", "czii.compose",
                                      "czii.solve", "epfl.compose",
                                      "czii.auto"])
def test_the_tf32_control_is_not_correct_on_the_card(workload):
    # at the cell's own size: TF32's error grows with the volume, and at
    # a cut size a control can read under the cell's limits
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 products exist only there")
    from benchmarks import compare

    cell = spec.load(workload)
    cuda = torch.device("cuda", 0)
    vol = volumes.volume(cell.config, 9, 0, cuda).cpu().numpy()
    out = Program(cell, cuda)(vol)
    ref = reference(cell, vol, cuda)
    ctl = reference(cell, vol, cuda, tf32=True).cpu().numpy()
    assert compare.judge([out], ref, cell.limits)[1] == 0
    assert compare.judge([ctl], ref, cell.limits)[1] == 1


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -3.0 - 2 ** -9])
    assert plain.to_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                                         1.0, -3.0 - 2 ** -9]

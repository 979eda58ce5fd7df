"""The ``-v 2`` stage reports of the port: the measured report's stage
split of a Kineto Chrome trace (a synthetic one, shaped like the trace
``torch.profiler`` writes on the card), the reconstructed report on the
CPU, and the CLI's default invocation with ``-v 2 --device cpu``, which
probes the bound, resolves presmooth and, with no device event in its
trace, logs the reconstruction."""

import contextlib
import json
import logging
import os
import re
import tempfile

import numpy as np
import pytest
import torch

from conftest import make_blob_volume

from flowdenoising_tpu_torch import cli
from flowdenoising_tpu_torch.config import FilterConfig, FlowConfig
from flowdenoising_tpu_torch.core.pipeline import denoise
from flowdenoising_tpu_torch.io.mrc import read_mrc, write_mrc
from flowdenoising_tpu_torch.kernels import get_gaussian_kernels
from flowdenoising_tpu_torch.utils.stage_report import device_stage_report
from flowdenoising_tpu_torch.utils.trace_report import (
    measured_stage_report, traced_run)

torch.set_num_threads(1)

STAGES = {"OFE_solve", "compose", "warping", "OFE_expansion", "elementwise",
          "async_copies"}


def _kernel(name, ts, dur, pid=0, tid=7, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur,
            "args": {"device": pid, "stream": tid, "correlation": int(ts)}}


def _write(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"schemaVersion": 1, "traceEvents": events}))
    return str(path)


def test_measured_report_groups_kernels(tmp_path, caplog):
    caplog.set_level("INFO")
    anon = "(anonymous namespace)::{}(float const*, float const*, int, int)"
    ew = ("void at::native::vectorized_elementwise_kernel<4, "
          "at::native::CUDAFunctor_add<float> >(int, float*)")
    events = [
        {"name": "process_name", "ph": "M", "ts": 0.0, "pid": 0, "tid": 0,
         "args": {"name": "python3"}},
        {"name": "thread_name", "ph": "M", "ts": 0.0, "pid": 0, "tid": 7,
         "args": {"name": "stream 7 "}},
        # flow-solve kernels: K-umuf, K-um, K-uf; compose kernels:
        # K-compose, K-compose-run
        _kernel(anon.format("umuf_kernel"), 2000.5, 3_000_000),
        _kernel(anon.format("compose_kernel"), 5000.0, 500_000),
        _kernel("void " + anon.format("compose_run_kernel<__nv_bfloat16>"),
                5500.0, 250_000),
        _kernel(anon.format("um_kernel"), 6000.0, 250_000),
        _kernel(anon.format("uf_kernel"), 7000.0, 250_000),
        # K-sample
        _kernel(anon.format("sample_kernel"), 8000.0, 1_000_000),
        # the expansion range on the card, and two kernels inside it
        {"ph": "X", "cat": "gpu_user_annotation", "name": "OFE_expansion",
         "pid": 0, "tid": 7, "ts": 100.0, "dur": 900.0,
         "args": {"External id": 20}},
        _kernel(ew, 100.0, 400_000),
        _kernel(ew, 600.25, 100_000),
        # the same range on the host covers a later kernel: not counted
        {"ph": "X", "cat": "user_annotation", "name": "OFE_expansion",
         "pid": 118, "tid": 118, "ts": 9000.0, "dur": 5000.0,
         "args": {"External id": 20}},
        _kernel(ew, 9500.0, 125_000),
        # copies
        _kernel("Memcpy HtoD (Pageable -> Device)", 50.0, 2_000_000,
                cat="gpu_memcpy"),
        _kernel("Memset (Device)", 60.0, 500_000, cat="gpu_memset"),
        # host events are ignored
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 118,
         "tid": 118, "ts": 10.0, "dur": 9_000_000, "args": {}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 118, "tid": 118, "ts": 11.0, "dur": 7_000_000, "args": {}},
    ]
    totals = measured_stage_report(_write(tmp_path, events))
    assert set(totals) == STAGES
    want = {"OFE_solve": 3.5, "compose": 0.75, "warping": 1.0,
            "OFE_expansion": 0.5, "elementwise": 0.125, "async_copies": 2.5}
    for key, secs in want.items():
        assert totals[key] == pytest.approx(secs, abs=1e-12), key
    assert "MEASURED" in caplog.text


def test_measured_report_reads_the_split_routes_ranges(tmp_path):
    # a bf16 pass with no bound: its compose chain and its gathers are
    # plain PyTorch kernels inside the OFE_solve and warping ranges; its
    # solves, K-umuf-split (both flow forms), are OFE_solve by name, as K-uf
    # (the -v 2 reconstruction) is
    ew = ("void at::native::vectorized_elementwise_kernel<4, "
          "at::native::CUDAFunctor_add<c10::BFloat16> >(int, float*)")
    gather = "void at::native::_scatter_gather_elementwise_kernel<128, 8>(int)"
    split = ("void (anonymous namespace)::umuf_split_kernel<{}>(__nv_bfloat16 "
             "const*, __nv_bfloat16 const*, {} const*, float*, int)")
    events = [
        {"ph": "X", "cat": "gpu_user_annotation", "name": "OFE_solve",
         "pid": 0, "tid": 7, "ts": 100.0, "dur": 900.0, "args": {}},
        _kernel(ew, 100.0, 3_000_000),
        _kernel(gather, 400.0, 1_000_000),
        _kernel("void (anonymous namespace)::uf_kernel(float const*)", 1000.0,
                500_000),
        _kernel(split.format("__nv_bfloat16", "__nv_bfloat16"), 1200.0, 125_000),
        _kernel(split.format("float", "float"), 1500.0, 625_000),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "warping",
         "pid": 0, "tid": 7, "ts": 2000.0, "dur": 500.0, "args": {}},
        _kernel(gather, 2000.0, 2_000_000),
        _kernel(ew, 3000.0, 250_000),
    ]
    totals = measured_stage_report(_write(tmp_path, events))
    want = {"OFE_solve": 5.25, "warping": 2.0, "OFE_expansion": 0.0,
            "elementwise": 0.25, "async_copies": 0.0}
    for key, secs in want.items():
        assert totals[key] == pytest.approx(secs, abs=1e-12), key


def test_measured_report_finds_each_kernels_range(tmp_path):
    # a thousand ranges on two devices, shuffled, with kernels at their
    # ends, between them and on a device without ranges; each kernel lands
    # in the range around it on its own device
    ew = "void at::native::vectorized_elementwise_kernel<4>(int, float*)"
    names = {"OFE_solve": "OFE_solve", "warping": "warping",
             "OFE_expansion": "OFE_expansion", "fdt.compose": "compose"}
    rng = np.random.default_rng(0)
    events, want = [], dict.fromkeys(STAGES, 0.0)
    for i in range(1000):
        pid, lo = i % 2, 100.0 * (i // 2)
        name = list(names)[i % len(names)]
        stage = names[name]
        events.append({"ph": "X", "cat": "gpu_user_annotation", "name": name,
                       "pid": pid, "tid": 7, "ts": lo, "dur": 60.0, "args": {}})
        for ts, where in ((lo, stage), (lo + 60.0, stage),
                          (lo + 80.0, "elementwise")):
            dur = int(rng.integers(1, 1000))
            events.append(_kernel(ew, ts, dur, pid=pid))
            want[where] += dur / 1e6
        events.append(_kernel(ew, lo + 30.0, 7, pid=2))
        want["elementwise"] += 7 / 1e6
    events = [events[i] for i in rng.permutation(len(events))]
    totals = measured_stage_report(_write(tmp_path, events))
    for key, secs in want.items():
        assert totals[key] == pytest.approx(secs, abs=1e-9), key


def test_measured_report_logs_the_drains_and_the_idle_after_them(
        tmp_path, caplog):
    """Each gap between device events counts whole toward the drain span it
    began in; a gap that began outside every drain counts nowhere."""
    caplog.set_level("INFO")
    ew = "void at::native::vectorized_elementwise_kernel<4>(int, float*)"

    def drain(site, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": "fdt.drain." + site,
                "pid": 118, "tid": 118, "ts": ts, "dur": dur, "args": {}}

    events = [
        # device work at 0-100, 150-300, 400-500, 700-800 and 900-1000 ms
        _kernel(ew, 0.0, 100_000),
        _kernel("Memcpy HtoD (Pageable -> Device)", 150_000.0, 150_000,
                cat="gpu_memcpy"),
        _kernel(ew, 400_000.0, 100_000),
        _kernel(ew, 700_000.0, 100_000),
        _kernel(ew, 900_000.0, 100_000),
        drain("resize_matrix", 90_000.0, 30_000.0),    # 100-150: 50 ms
        drain("resize_matrix", 290_000.0, 20_000.0),   # 300-400: 100 ms
        drain("blur_index", 480_000.0, 40_000.0),      # 500-700: 200 ms
        drain("mem_info", 850_000.0, 100_000.0),       # 800-900 began before
    ]
    assert measured_stage_report(_write(tmp_path, events)) is not None
    lines = [r.getMessage() for r in caplog.records]
    assert any(re.search(r"drains\s+4\s+resize_matrix 2, blur_index 1, "
                         r"mem_info 1$", m) for m in lines), lines
    assert any(re.search(r"idle after\s+0.3500s\s+resize_matrix 0.1500s, "
                         r"blur_index 0.2000s, mem_info 0.0000s$", m)
               for m in lines), lines


def test_measured_report_none_without_device_kernels(tmp_path):
    assert measured_stage_report(None) is None
    assert measured_stage_report(str(tmp_path / "missing.json")) is None
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1,
               "tid": 1, "ts": 0.0, "dur": 5.0, "args": {}},
              _kernel("Memcpy HtoD (Pageable -> Device)", 1.0, 4.0,
                      cat="gpu_memcpy")]
    assert measured_stage_report(_write(tmp_path, events)) is None


def test_traced_cpu_run_has_no_device_event():
    with traced_run() as state:
        denoise(torch.ones(4, 16, 16), FilterConfig(
            sigma=(1.0, 1.0, 1.0), flow=FlowConfig(levels=1, min_size=8)))
    try:
        with open(state["path"]) as f:
            cats = {e.get("cat") for e in json.load(f)["traceEvents"]}
        assert "user_annotation" in cats and "kernel" not in cats
        assert measured_stage_report(state["path"]) is None
    finally:
        os.remove(state["path"])


def test_traced_run_exports_in_its_own_phase(tmp_path, monkeypatch):
    """The profiler's stop and the trace export run once, inside
    ``export_phase()``, after the block; a block that raises stops the
    profiler and writes no trace."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    seen = []

    @contextlib.contextmanager
    def phase():
        seen.append("enter")
        yield
        seen.append("exit")

    with traced_run(phase) as state:
        torch.ones(8).add_(1)
        assert seen == [] and "path" not in state
    assert seen == ["enter", "exit"]
    assert [str(p) for p in tmp_path.glob("fdt_trace_*")] == [state["path"]]
    os.remove(state["path"])
    with pytest.raises(ValueError), traced_run(phase):
        raise ValueError("the block failed")
    assert seen == ["enter", "exit"]
    assert not list(tmp_path.glob("fdt_trace_*"))


@pytest.mark.parametrize("tap_mode", ["solve", "compose"])
def test_reconstructed_report_on_cpu(tap_mode, caplog):
    caplog.set_level("INFO")
    cfg = FilterConfig(sigma=(1.0, 1.0, 1.0),
                       flow=FlowConfig(levels=2, min_size=8, tap_mode=tap_mode))
    totals = device_stage_report((6, 24, 20), cfg, get_gaussian_kernels(cfg.sigma),
                                 device="cpu")
    assert set(totals) == {"OFE_expansion", "OFE_solve", "pyramid", "warping",
                           "convolution"}
    assert all(v >= 0 for v in totals.values())
    assert totals["OFE_solve"] > 0 and totals["warping"] > 0
    assert "reconstructed" in caplog.text and "K-um + K-uf" in caplog.text


def test_cli_default_flow_setup_v2_on_cpu(tmp_path, monkeypatch, capsys):
    """``-v 2`` with the default flow setup: the probe picks the bound,
    presmooth auto is resolved, the filter runs profiled, the trace holds no
    device event, so the reconstruction is logged and labelled; the trace
    file is removed; the output is the denoise at the resolved config."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    # the CLI points the root logger at this test's captured stderr; put
    # the handlers back afterwards
    root = logging.getLogger()
    monkeypatch.setattr(root, "handlers", list(root.handlers))
    monkeypatch.setattr(root, "level", root.level)
    vol = make_blob_volume(8, 40, 36, seed=5)
    vol = vol + np.random.default_rng(3).normal(0, 60, vol.shape).astype(np.float32)
    src, dst = tmp_path / "in.mrc", tmp_path / "out.mrc"
    write_mrc(src, vol)
    rc = cli.main(["-i", str(src), "-o", str(dst), "-s", "1", "1", "1",
                   "-l", "2", "--flow_presmooth", "auto", "-v", "2",
                   "--device", "cpu"])
    assert rc == 0
    log = capsys.readouterr().err
    picked = re.search(r"max_displacement=(\d+), adjacent_displacement=(\d+)", log)
    presmooth = re.search(r"presmooth=([0-9.]+)", log)
    assert picked and presmooth, log
    assert "[stages] reconstructed" in log and "MEASURED" not in log
    assert "[profile] probe" in log and "[profile] trace_export" in log
    assert not list(tmp_path.glob("fdt_trace_*"))
    cfg = FilterConfig(sigma=(1.0, 1.0, 1.0), flow=FlowConfig(
        levels=2, max_displacement=int(picked[1]),
        adjacent_displacement=int(picked[2]), presmooth=float(presmooth[1])))
    out, _ = read_mrc(dst)
    np.testing.assert_array_equal(out, denoise(torch.from_numpy(vol), cfg).numpy())

"""The port's tracing helpers and matmul_precision on the CPU, and the CLI
cases of tests/test_cli.py that no other test of the port covers: the
reference's flags, the GPU variant's flags, --show_fingerprint, and a
missing input or output directory."""

import json

import numpy as np
import pytest
import torch

from conftest import make_blob_volume

from flowdenoising_tpu_torch.cli import build_parser, main
from flowdenoising_tpu_torch.config import FilterConfig, FlowConfig
from flowdenoising_tpu_torch.core.pipeline import denoise
from flowdenoising_tpu_torch.io.mrc import read_mrc, write_mrc
from flowdenoising_tpu_torch.ops.farneback import farneback_flow, matmul_precision
from flowdenoising_tpu_torch.ops.resize import _MATMUL_PRECISIONS
from flowdenoising_tpu_torch.utils.tracing import annotate, device_trace

torch.set_num_threads(1)


def test_device_trace_writes_one_trace_with_the_range(tmp_path):
    vol = make_blob_volume(6, 24, 24, seed=3)
    cfg = FilterConfig(sigma=(0.5, 0.5, 0.5),
                       flow=FlowConfig(levels=0, max_displacement=4))
    log_dir = tmp_path / "trace"
    with device_trace(str(log_dir)) as state:
        with annotate("api_phase"):
            out = denoise(vol, cfg, device="cpu")
    assert out.shape == vol.shape
    files = list(log_dir.iterdir())
    assert [str(f) for f in files] == [state["path"]]
    events = json.loads(files[0].read_text())["traceEvents"]
    marks = [e for e in events if e.get("name") == "api_phase"]
    assert marks and all(e.get("ph") == "X" for e in marks)
    # the denoise's operations lie inside the range
    lo, hi = marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]
    inside = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
              and lo <= e["ts"] <= hi]
    assert len(inside) > 10


def test_device_trace_raises_what_the_block_raises(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with device_trace(str(tmp_path)):
            1 / 0
    assert list(tmp_path.iterdir()) == []


def test_annotate_without_a_trace_is_a_no_op():
    with annotate("outside"):
        x = torch.ones(3) * 2
    assert float(x.sum()) == 6.0


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("caller", ["ieee", "tf32"])
def test_matmul_precision_restores_the_callers_setting(precision, caller):
    saved = [b.fp32_precision for b in _MATMUL_PRECISIONS]
    try:
        for b in _MATMUL_PRECISIONS:
            b.fp32_precision = caller
        with matmul_precision(FlowConfig(precision=precision)):
            inside = [b.fp32_precision for b in _MATMUL_PRECISIONS]
        after = [b.fp32_precision for b in _MATMUL_PRECISIONS]
    finally:
        for b, p in zip(_MATMUL_PRECISIONS, saved):
            b.fp32_precision = p
    assert inside == (["ieee"] * 2 if precision == "float32" else [caller] * 2)
    assert after == [caller] * 2


def test_matmul_precision_changes_no_output():
    r = np.random.default_rng(5)
    ref = torch.from_numpy((r.normal(size=(2, 40, 40)) * 50).astype(np.float32))
    tgt = torch.roll(ref, 1, dims=-1)
    cfg = FlowConfig(levels=2, min_size=8)
    plain = farneback_flow(ref, tgt, cfg)
    with matmul_precision(cfg):
        pinned = farneback_flow(ref, tgt, cfg)
    torch.testing.assert_close(pinned, plain, atol=0, rtol=0)


# tests/test_cli.py's cases, on the port's CLI

def test_parser_reference_flags():
    p = build_parser()
    args = p.parse_args(["-i", "a.mrc", "-o", "b.mrc", "-s", "2.0", "1.0", "3.0",
                         "-l", "2", "-w", "9", "-v", "1", "-n", "-m",
                         "-p", "8", "--recompute_flow"])
    assert args.input == "a.mrc"
    assert [float(s) for s in args.sigma] == [2.0, 1.0, 3.0]
    assert args.levels == 2 and args.winsize == 9
    assert args.no_OF and args.memory_map and args.recompute_flow


def test_parser_gpu_variant_flags(tmp_path):
    # the GPU variant's extra flags are accepted (the device is --device's)
    args = build_parser().parse_args(["--use_GPU", "--use_threads", "-p", "4"])
    assert args.use_GPU and args.use_threads
    vol = make_blob_volume(4, 16, 16, seed=14)
    src, dst = tmp_path / "in.mrc", tmp_path / "out.mrc"
    write_mrc(src, vol)
    rc = main(["-i", str(src), "-o", str(dst), "-n", "-s", "0.5",
               "--use_GPU", "--use_threads", "-p", "4", "--device", "cpu"])
    assert rc == 0
    out, _ = read_mrc(dst)
    assert out.shape == vol.shape


def test_cli_fingerprint(capsys, tmp_path):
    vol = make_blob_volume(4, 16, 16, seed=13)
    src, dst = tmp_path / "in.mrc", tmp_path / "out.mrc"
    write_mrc(src, vol)
    main(["-i", str(src), "-o", str(dst), "-n", "-s", "0.5",
          "--show_fingerprint", "--device", "cpu"])
    assert "fingerprint =" in capsys.readouterr().out


def test_cli_missing_input_friendly_error(tmp_path):
    with pytest.raises(SystemExit, match="not found"):
        main(["-i", str(tmp_path / "nope.mrc"), "-o", str(tmp_path / "o.mrc"),
              "-n", "--device", "cpu"])
    vol = make_blob_volume(4, 16, 16, seed=20)
    src = tmp_path / "in.mrc"
    write_mrc(src, vol)
    with pytest.raises(SystemExit, match="output directory"):
        main(["-i", str(src), "-o", str(tmp_path / "no_dir" / "o.mrc"), "-n",
              "--device", "cpu"])

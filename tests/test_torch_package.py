"""Package-level properties of the port: it imports neither JAX nor the JAX
package, its kernel layer imports nothing above it, its CLI runs every flag
combination of the JAX CLI and never drops to the CPU, its configuration
round-trips the JAX package's, and its kernels are built for Hopper
(sm_90a)."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowdenoising_tpu.config import Boundary as JBoundary
from flowdenoising_tpu.config import FilterConfig as JFilterConfig
from flowdenoising_tpu.config import FlowConfig as JFlowConfig

from flowdenoising_tpu_torch import cli
from flowdenoising_tpu_torch.config import FilterConfig, FlowConfig, from_reference
from flowdenoising_tpu_torch.io.mrc import write_mrc
from flowdenoising_tpu_torch.ops.compose import compose_tap
from flowdenoising_tpu_torch.ops.cuda import build
from flowdenoising_tpu_torch.ops.farneback import (
    farneback_flow, umuf_iterate, update_flow, update_matrices)
from flowdenoising_tpu_torch.ops.warp import displace_sample

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import flowdenoising_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flowdenoising_tpu"))
print("LOADED", len([n for n in sys.modules if n.startswith(pkg.__name__)]))
print("BAD", bad)
"""


def test_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert int(out.stdout.split("LOADED ")[1].split()[0]) >= 20


PACKAGE = REPO / "flowdenoising_tpu_torch"


def _imports(path: Path) -> list[str]:
    """Every module or name ``path`` imports from the package, imports
    inside functions included, as dotted paths."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            out += [f"{node.module}.{a.name}" for a in node.names]
    return [n for n in out if n.startswith(PACKAGE.name + ".")]


def test_the_kernel_layer_imports_nothing_above_it():
    # ops/cuda only launches: it reaches nothing of the package outside
    # itself but the span helpers; nothing outside ops reaches round the
    # ops layer into it
    cuda = f"{PACKAGE.name}.ops.cuda"
    allowed = (cuda + ".", f"{PACKAGE.name}.utils.tracing.")
    bad = []
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(PACKAGE).parts
        for name in _imports(path):
            if rel[:2] == ("ops", "cuda"):
                if not (name + ".").startswith(allowed):
                    bad.append(f"{'/'.join(rel)}: {name}")
            elif rel[0] != "ops" and (name + ".").startswith(cuda + "."):
                bad.append(f"{'/'.join(rel)}: {name}")
    assert not bad, bad


@pytest.fixture
def mrc_in(tmp_path):
    path = tmp_path / "in.mrc"
    write_mrc(path, np.zeros((4, 8, 8), np.float32))
    return path


def test_default_device_cuda_raises_without_cuda(mrc_in, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test checks a host without it")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["-i", str(mrc_in), "-o", str(tmp_path / "out.mrc")])
    assert not (tmp_path / "out.mrc").exists()


@pytest.mark.parametrize("flags", [
    ["--precision", "bfloat16"], ["--dtype", "bfloat16"],
    ["--max_displacement", "0", "--precision", "bfloat16"],
    ["--max_displacement", "0", "--dtype", "bfloat16"],
    ["--max_displacement", "0", "--dtype", "bfloat16", "--tap_flow", "compose"]])
def test_bf16_flags_run(flags, mrc_in, tmp_path):
    # ported (ROADMAP A9); precision bfloat16 with no bound is the float32
    # path, as in the JAX package; dtype bfloat16 with no bound the split
    # iteration in bf16 (tests/test_torch_bf16_nobound.py)
    out = tmp_path / "o.mrc"
    assert cli.main(["-i", str(mrc_in), "-o", str(out), "--device", "cpu",
                     "--max_displacement", "4", *flags]) == 0
    assert out.exists()


@pytest.mark.parametrize("flags,message", [
    (["--max_displacement", "bogus"], "integer or 'auto'"),
    (["--flow_presmooth", "bogus"], "number or 'auto'"),
])
def test_bad_auto_flag_values_exit(flags, message, mrc_in, tmp_path):
    with pytest.raises(SystemExit, match=message):
        cli.main(["-i", str(mrc_in), "-o", str(tmp_path / "o.mrc"),
                  "--device", "cpu", *flags])


def test_library_refuses_unported_settings():
    # nothing is left unported (ROADMAP A9's bf16 with no bound was the
    # last): the library runs every setting, and a flow of a plain pair
    # comes back finite and float32
    r = np.random.default_rng(0)
    ref = torch.from_numpy(r.normal(size=(2, 40, 40)).astype(np.float32) * 50)
    tgt = torch.roll(ref, 1, dims=-1)
    for cfg in (FlowConfig(dtype="bfloat16", max_displacement=None),
                FlowConfig(dtype="bfloat16", precision="bfloat16"),
                FlowConfig(precision="bfloat16", max_displacement=None),
                FlowConfig(presmooth=1.0), FlowConfig(),
                FlowConfig(tap_mode="compose", symmetric_adjacent=True,
                           adjacent_displacement=2)):
        flow = farneback_flow(ref, tgt, cfg)
        assert flow.shape == (2, 40, 40, 2) and flow.dtype == torch.float32
        assert bool(flow.isfinite().all()), cfg


@pytest.mark.parametrize("jcfg", [
    JFilterConfig(),
    JFilterConfig(sigma=(1.0, 2.0, 3.0), boundary=JBoundary.MEAN, use_flow=False,
                  slab_size=7,
                  flow=JFlowConfig(levels=2, winsize=7, max_displacement=None,
                                   use_initial_flow=False, min_size=8)),
    JFilterConfig(flow=JFlowConfig(tap_mode="compose", symmetric_adjacent=True,
                                   adjacent_displacement=3)),
    JFilterConfig(flow=JFlowConfig(dtype="bfloat16", precision="bfloat16")),
])
def test_from_reference_round_trips(jcfg):
    cfg = from_reference(jcfg)
    assert isinstance(cfg, FilterConfig) and isinstance(cfg.flow, FlowConfig)
    for f in dataclasses.fields(JFlowConfig):
        assert getattr(cfg.flow, f.name) == getattr(jcfg.flow, f.name), f.name
    assert cfg.boundary.value == jcfg.boundary.value
    assert (cfg.sigma, cfg.use_flow, cfg.slab_size) == (
        tuple(jcfg.sigma), jcfg.use_flow, jcfg.slab_size)
    # same fields and defaults as the JAX package's
    assert ([(f.name, f.default) for f in dataclasses.fields(FlowConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JFlowConfig)])
    assert from_reference(jcfg.flow) == cfg.flow


def test_nvcc_command_targets_sm_90a():
    srcs = build.sources()
    assert [s.name for s in srcs] == ["compose.cu", "polyexp.cu", "resize.cu",
                                      "sample.cu", "uf.cu", "um.cu", "umuf.cu",
                                      "umuf_split.cu"]
    for src in srcs:
        cmd = build.compile_command(src, Path("x.o"))
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-c" in cmd and cmd[-1] == str(src)
    cmd = build.link_command([Path("a.o"), Path("b.o")], Path("x.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and cmd[-2:] == ["a.o", "b.o"]
    lib = build.library_path()
    assert lib.parent == REPO / "build" / "flowdenoising_tpu_torch"
    assert lib.name.startswith("libfdt_kernels-") and lib.suffix == ".so"


def test_library_name_follows_the_shared_headers(monkeypatch, tmp_path):
    # umuf.cu and um.cu share farneback.cuh: an edit of the header alone
    # must name a new library, so no stale build is reused
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path()
    (tmp_path / "h.cuh").write_text("// two\n")
    assert build.library_path() != first
    assert [s.name for s in build.sources()] == ["k.cu"]


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "nvcc_path", lambda: str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(build, "library_path", lambda: tmp_path / "lib.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_wrappers_refuse_other_devices():
    # no kernel and no silent substitute for a device that is neither CPU
    # nor CUDA
    src = torch.zeros(1, 4, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        displace_sample(src, src, src, 2)
    r = torch.zeros(1, 5, 4, 4, device="meta")
    f = torch.zeros(1, 2, 4, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        umuf_iterate(r, r, f, 1, 2, 5)
    with pytest.raises(ValueError, match="no kernel"):
        compose_tap(f, f, src, src, 0.5, 2, 0, 0)
    with pytest.raises(ValueError, match="no kernel"):
        update_matrices(r, r, f, 2)
    with pytest.raises(ValueError, match="no kernel"):
        update_flow(r, 5)

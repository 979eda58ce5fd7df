"""Package-level properties of the port: it imports neither JAX nor the JAX
package, its CLI refuses what it has not ported and never drops to the CPU,
its configuration round-trips the JAX package's, and its kernels are built
for Hopper (sm_90a)."""

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
from flowdenoising_tpu_torch.ops.cuda import build
from flowdenoising_tpu_torch.ops.cuda.sample import displace_sample
from flowdenoising_tpu_torch.ops.cuda.umuf import umuf_iterate

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


@pytest.mark.parametrize("flags,item", [
    (["--max_displacement", "auto"], "A8"),
    (["--flow_presmooth", "1.0"], "A8"),
    (["--flow_presmooth", "auto"], "A8"),
    (["--tap_flow", "compose"], "A9"),
    (["--symmetric_adjacent"], "A9"),
    (["--precision", "bfloat16"], "A9"),
    (["--dtype", "bfloat16"], "A9"),
    (["--stream"], "A10"),
    (["--checkpoint_dir", "ck"], "A10"),
    (["--devices", "2"], "A11"),
    (["--coordinator", "localhost:1234"], "A11"),
])
def test_unported_flags_exit_naming_roadmap_item(flags, item, mrc_in, tmp_path):
    with pytest.raises(SystemExit, match=item):
        cli.main(["-i", str(mrc_in), "-o", str(tmp_path / "o.mrc"),
                  "--device", "cpu", *flags])


def test_library_refuses_unported_settings():
    with pytest.raises(NotImplementedError, match="A9"):
        FlowConfig(tap_mode="compose").check_ported()
    with pytest.raises(NotImplementedError, match="A9"):
        FlowConfig(precision="bfloat16").check_ported()
    with pytest.raises(NotImplementedError, match="A8"):
        FlowConfig(presmooth=1.0).check_ported()
    FlowConfig().check_ported()


@pytest.mark.parametrize("jcfg", [
    JFilterConfig(),
    JFilterConfig(sigma=(1.0, 2.0, 3.0), boundary=JBoundary.MEAN, use_flow=False,
                  slab_size=7,
                  flow=JFlowConfig(levels=2, winsize=7, max_displacement=None,
                                   use_initial_flow=False, min_size=8)),
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
    assert [s.name for s in srcs] == ["sample.cu", "umuf.cu"]
    cmd = build.nvcc_command(srcs, Path("x.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and cmd[-2:] == [str(s) for s in srcs]
    lib = build.library_path()
    assert lib.parent == REPO / "build" / "flowdenoising_tpu_torch"
    assert lib.name.startswith("libfdt_kernels-") and lib.suffix == ".so"


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

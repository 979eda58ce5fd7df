"""The port's native runtime (``flowdenoising_tpu_torch/runtime``, libfdio)
and its NumPy path: the cases of tests/test_runtime.py against the port's
modules, then the native and NumPy paths of the port's MRC reader and
writer against each other (the same array, the same file bytes), the
native calls counted, and where the library is built and loaded from."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from flowdenoising_tpu_torch import runtime
from flowdenoising_tpu_torch.io.mrc import read_mrc, read_mrc_f32, write_mrc
from flowdenoising_tpu_torch.io.volume import read_volume

REPO = Path(__file__).resolve().parents[1]


def test_stats_matches_numpy():
    x = np.random.default_rng(0).normal(size=30000).astype(np.float32) * 37 + 5
    mn, mx, mean, rms = runtime.stats_f32(x)
    assert abs(mn - x.min()) < 1e-4
    assert abs(mx - x.max()) < 1e-4
    assert abs(mean - x.mean()) < 1e-3
    assert abs(rms - x.std()) < 1e-3


@pytest.mark.parametrize("dtype,mode", [(np.int8, 0), (np.int16, 1),
                                        (np.float32, 2), (np.uint16, 6),
                                        (np.float16, 12)])
def test_read_mrc_f32_all_modes(tmp_path, dtype, mode):
    r = np.random.default_rng(mode)
    if np.issubdtype(dtype, np.floating):
        vol = r.normal(size=(3, 8, 8)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        vol = r.integers(info.min, info.max, size=(3, 8, 8)).astype(dtype)
    p = tmp_path / "v.mrc"
    write_mrc(p, vol)
    f32 = read_mrc_f32(p)
    np.testing.assert_array_equal(f32, vol.astype(np.float32))
    raw, hdr = read_mrc(p)
    assert hdr.mode == mode


def test_native_or_fallback_consistency(tmp_path):
    # whichever path is active, the public API result is identical
    vol = (np.random.default_rng(9).normal(size=(4, 16, 16)) * 900).astype(np.int16)
    p = tmp_path / "w.mrc"
    write_mrc(p, vol)
    a = read_mrc_f32(p)
    b, _ = read_mrc(p)
    np.testing.assert_array_equal(a, b.astype(np.float32))


@pytest.fixture
def numpy_path(monkeypatch):
    """Run the NumPy path: the library as on a host that cannot build it."""
    monkeypatch.setattr(runtime, "_load", lambda: None)


def _native_run(tmp_path, vol, name):
    """Write ``vol`` and read it back as float32 on the native path, with
    its library calls counted."""
    runtime.reset_native_calls()
    p = tmp_path / name
    write_mrc(p, vol)
    out = read_mrc_f32(p, n_threads=3)
    return p, out, dict(runtime.NATIVE_CALLS)


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.float16])
def test_native_and_numpy_paths_agree(tmp_path, monkeypatch, dtype):
    assert runtime.native_available(), "g++ builds the library here"
    vol = (np.random.default_rng(11).normal(size=(5, 33, 47)) * 300 + 20).astype(dtype)
    native_file, native, calls = _native_run(tmp_path, vol, "native.mrc")
    float32 = dtype == np.float32
    # reads convert natively in every mode; stats and raw writes are float32's
    assert calls == {"read_convert": 1, "write_raw": int(float32),
                     "stats": int(float32)}
    monkeypatch.setattr(runtime, "_load", lambda: None)
    runtime.reset_native_calls()
    write_mrc(tmp_path / "numpy.mrc", vol)
    plain = read_volume(tmp_path / "numpy.mrc", as_f32=True)
    assert runtime.NATIVE_CALLS == dict.fromkeys(calls, 0)
    assert native.dtype == plain.dtype == np.float32
    np.testing.assert_array_equal(native, plain)
    np.testing.assert_array_equal(native, vol.astype(np.float32))
    assert native_file.read_bytes() == (tmp_path / "numpy.mrc").read_bytes()


def test_numpy_path_without_a_library(tmp_path, numpy_path):
    vol = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    runtime.reset_native_calls()
    write_mrc(tmp_path / "v.mrc", vol)
    np.testing.assert_array_equal(read_mrc_f32(tmp_path / "v.mrc"), vol)
    assert not runtime.native_available()
    assert runtime.read_convert_f32(str(tmp_path / "v.mrc"), 1024, 24, 2) is None
    assert runtime.write_raw(str(tmp_path / "w.mrc"), b"", vol) is False
    assert sum(runtime.NATIVE_CALLS.values()) == 0


def test_build_failure_raises_and_load_falls_back(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(runtime, "SOURCE", bad)
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        runtime.build()
    runtime._load.cache_clear()
    try:
        assert runtime._load() is None
    finally:
        monkeypatch.undo()
        runtime._load.cache_clear()
    assert runtime.native_available()


_LOADED = """
import numpy as np
from flowdenoising_tpu_torch import runtime
from flowdenoising_tpu_torch.io.mrc import read_mrc_f32, write_mrc
write_mrc("v.mrc", np.ones((2, 3, 4), np.float32))
read_mrc_f32("v.mrc")
print("CALLS", runtime.NATIVE_CALLS)
print("MAPPED", sorted({line.split()[-1] for line in open("/proc/self/maps")
                        if "libfdio" in line}))
"""


def test_library_is_built_and_loaded_from_the_ports_build_dir(tmp_path):
    lib = runtime.library_path()
    assert lib.parent == REPO / "build" / "flowdenoising_tpu_torch"
    assert lib.name.startswith("libfdio-") and lib.suffix == ".so"
    # a fresh process, from another directory: the library mapped is the
    # port's build, never the JAX package's runtime/native/libfdio.so
    out = subprocess.run([sys.executable, "-c", _LOADED], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert "'read_convert': 1, 'write_raw': 1, 'stats': 1" in out.stdout
    mapped = ast.literal_eval(out.stdout.split("MAPPED ")[1].strip())
    assert mapped == [str(lib)], mapped
    assert not any("flowdenoising_tpu/runtime" in m for m in mapped)

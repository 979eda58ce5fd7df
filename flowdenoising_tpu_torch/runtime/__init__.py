"""Native host runtime (``libfdio``, ctypes) with a NumPy path.

Counterpart of the JAX package's ``flowdenoising_tpu/runtime``, with its
own copy of the source: ``native/fdio.cpp`` provides the host-side data
path of the CLI -- MRC payload decode with dtype conversion, raw writes,
and single-pass volume statistics.  At first use it is compiled with
``g++ -O3 -fPIC -shared -std=c++17 -pthread`` (the JAX package's Makefile
flags) into ``build/flowdenoising_tpu_torch/libfdio-<hash>.so`` at the root
of the checkout, named by a hash of the source and the flags; a build for
the same source is reused.  Where it cannot be built (a host with no
compiler), every entry point takes its NumPy path, with the same results:
the NumPy statistics are taken in float64, as the library takes them, so
both write the same MRC header.  ``build()`` raises instead, for a caller
that requires the library.

``NATIVE_CALLS`` counts the library calls of each entry point, as
``ops.cuda.LAUNCHES`` counts kernel launches, so a run shows which path its
I/O took.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "fdio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "flowdenoising_tpu_torch"
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]

# entry point -> library calls since the last reset_native_calls()
NATIVE_CALLS = {"read_convert": 0, "write_raw": 0, "stats": 0}


def reset_native_calls() -> None:
    for name in NATIVE_CALLS:
        NATIVE_CALLS[name] = 0


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfdio-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this source is already built; raises
    RuntimeError with the compiler's output when it cannot."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXXFLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"libfdio: {' '.join(cmd)} failed: {e}") from e
    try:
        if proc.returncode != 0:
            raise RuntimeError(f"libfdio: g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.cache
def _load() -> ctypes.CDLL | None:
    """The built library with its C signatures set, or None where it
    cannot be built or loaded (the NumPy path)."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError) as e:
        logging.debug(f"native runtime unavailable, using NumPy: {e}")
        return None
    lib.fd_read_convert.restype = ctypes.c_int
    lib.fd_read_convert.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.fd_write_raw.restype = ctypes.c_int
    lib.fd_write_raw.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.fd_stats_f32.restype = ctypes.c_int
    lib.fd_stats_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double)]
    return lib


def native_available() -> bool:
    return _load() is not None


def read_convert_f32(path: str, offset: int, count: int, mode: int,
                     n_threads: int | None = None) -> np.ndarray | None:
    """Read ``count`` voxels of an MRC payload as float32 via the native
    library (``n_threads`` converting, default one a CPU); returns None
    when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(count, dtype=np.float32)
    nt = n_threads if n_threads is not None else (os.cpu_count() or 1)
    rc = lib.fd_read_convert(
        path.encode(), offset, count, mode,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nt)
    if rc != 0:
        raise IOError(f"fd_read_convert({path}) failed with code {rc}")
    NATIVE_CALLS["read_convert"] += 1
    return out


def write_raw(path: str, header: bytes, data: np.ndarray) -> bool:
    """Write ``header`` and then ``data`` as float32 to ``path`` via the
    native library; False when the library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    data = np.ascontiguousarray(data, dtype=np.float32)
    hdr = np.frombuffer(header, dtype=np.uint8)
    rc = lib.fd_write_raw(
        path.encode(),
        hdr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(header),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), data.size)
    if rc != 0:
        raise IOError(f"fd_write_raw({path}) failed with code {rc}")
    NATIVE_CALLS["write_raw"] += 1
    return True


def stats_f32(data: np.ndarray):
    """(min, max, mean, rms) of a non-empty array, in one pass where the
    library is built; else NumPy's, its mean and rms in float64 too."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.float32)
    if lib is None:
        return (float(data.min()), float(data.max()),
                float(data.mean(dtype=np.float64)),
                float(data.std(dtype=np.float64)))
    out = np.empty(4, dtype=np.float64)
    rc = lib.fd_stats_f32(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), data.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise IOError(f"fd_stats_f32 failed with code {rc}")
    NATIVE_CALLS["stats"] += 1
    return tuple(out.tolist())

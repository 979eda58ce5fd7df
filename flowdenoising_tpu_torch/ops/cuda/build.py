"""Build and load the hand-written CUDA kernels.

The sources ``flowdenoising_tpu_torch/csrc/*.cu`` expose a plain C
interface.  At first use they are compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library,
``build/flowdenoising_tpu_torch/libfdt_kernels-<hash>.so`` at the root of
the checkout, named by a hash of the sources and the command, and loaded
with ctypes.  A build for the same sources is reused; nothing is compiled
when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "flowdenoising_tpu_torch"

# -fmad=false: no multiply-add contraction, so the kernels round as the
# plain PyTorch versions' separate multiplies and adds do.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every exported function: (argtypes, restype).
SIGNATURES = {
    "fdt_sample": ([_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_longlong, _F, _I,
                    _P], _I),
    "fdt_umuf_step": ([_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _F, _P], _I),
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def nvcc_command(srcs: list[Path], out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), *map(str, srcs)]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfdt_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this source hash is already built.

    The compiler's report (``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept beside the library as ``<name>.log``.  Raises
    RuntimeError with the compiler's output when nvcc fails.
    """
    out = library_path()
    if out.exists():
        return out
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    nvcc = nvcc_path()
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (looked for {nvcc}); the CUDA "
                           "kernels are built on a machine with the CUDA "
                           "toolkit")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(nvcc_command(srcs, tmp), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernel library, with every function's C signature set."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(rc: int, name: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")

"""Build and load the hand-written CUDA kernels.

The sources ``flowdenoising_tpu_torch/csrc/*.cu`` expose a plain C
interface (``*.cuh``: device code they share).  At first use they are compiled by ``nvcc`` for Hopper
(``sm_90a``), one compiler process per source, all started together, and
linked into one shared library,
``build/flowdenoising_tpu_torch/libfdt_kernels-<hash>.so`` at the root of
the checkout, named by a hash of the sources and the commands, and loaded
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
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xptxas",
                 "-v", "-Xcompiler", "-fPIC", "-c"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_COMPOSE = ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P], _I)
_COMPOSE_RUN = ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _I, _P], _I)
_UMUF = ([_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _F, _I, _I, _I, _I, _P],
         _I)
_UM = ([_P, _P, _P, _P, _I, _I, _I, _F, _I, _P], _I)
# C signature of every exported function: (argtypes, restype).  A *_bf16
# entry is its kernel's packed form: the same arguments, the sampling source
# bfloat16.
SIGNATURES = {
    "fdt_compose_step": _COMPOSE,
    "fdt_compose_step_bf16": _COMPOSE,
    "fdt_compose_run": _COMPOSE_RUN,
    "fdt_compose_run_bf16": _COMPOSE_RUN,
    "fdt_compose_run_split": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P], _I),
    "fdt_polyexp": ([_P, _P, _P, _I, _I, _I, _I, _P, _I, _P], _I),
    "fdt_polyexp_scratch": ([_I, _I, _I, _I], ctypes.c_longlong),
    "fdt_pyr_blur": ([_P, _P, _P, _I, _I, _I, _P, _I, _P], _I),
    "fdt_pyr_blur_scratch": ([_I, _I, _I, _I], ctypes.c_longlong),
    "fdt_resize": ([_P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _P], _I),
    "fdt_sample": ([_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_longlong, _F, _I,
                    _P], _I),
    "fdt_sample_split": ([_P, _P, _P, _I, _P, _P, _F, _I, _I, _I, _I,
                          ctypes.c_longlong, _P], _I),
    "fdt_umuf": _UMUF,
    "fdt_umuf_bf16": _UMUF,
    "fdt_umuf_smem": ([_I, _I, _I, _I, _I, _I], ctypes.c_longlong),
    "fdt_umuf_split": ([_P, _P, _P, _I, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I,
                        _P], _I),
    "fdt_update_flow": ([_P, _P, _I, _I, _I, _I, _F, _P], _I),
    "fdt_update_flow_smem": ([_I], ctypes.c_longlong),
    "fdt_update_matrices": _UM,
    "fdt_update_matrices_bf16": _UM,
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def compile_command(src: Path, obj: Path) -> list[str]:
    return [nvcc_path(), *COMPILE_FLAGS, "-o", str(obj), str(src)]


def link_command(objs: list[Path], out: Path) -> list[str]:
    return [nvcc_path(), *ARCH_FLAGS, "-shared", "-o", str(out),
            *map(str, objs)]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):   # the sources and headers
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
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        procs = [subprocess.Popen(compile_command(src, obj),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        report = "".join(logs)
        for src, proc, log in zip(srcs, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({proc.returncode}):\n{log}")
        link = subprocess.run(link_command(objs, tmp), capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        out.with_suffix(".log").write_text(report + link.stdout + link.stderr)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
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

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
    """The built kernel library (``ops.cuda.entry`` sets each C entry's
    signature)."""
    return ctypes.CDLL(str(build()))

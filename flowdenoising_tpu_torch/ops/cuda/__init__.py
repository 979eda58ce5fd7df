"""Launchers of the hand-written CUDA kernels for Hopper, and their launch
counts.

Each module here wraps one kernel source (``csrc/*.cu``): it checks its
operands, plans the launch, launches on the current stream and counts.  It
runs only on the card and holds no plain version; the ``ops`` layer
chooses between a kernel and its plain PyTorch version
(``ops.device.use_kernel``).

``ENTRIES`` lists the library's C entries with their arguments and the form
each launch counts under in ``LAUNCHES``.  A run resets ``LAUNCHES`` and
reads it afterwards to see which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flowdenoising_tpu_torch.ops.cuda import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_COMPOSE = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P]
_COMPOSE_RUN = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _I, _P]
_UMUF = [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _F, _I, _I, _I, _P]
_UM = [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P]
# C entry -> (argument types, form).  A launcher takes the stream last,
# returns a CUDA error code and counts under its form; a size query
# (form None) returns bytes or floats as a long long.  A *_bf16 entry is its
# kernel's packed form: the same arguments, the sampling source bfloat16.
ENTRIES = {
    "fdt_compose_step": (_COMPOSE, "compose"),
    "fdt_compose_step_bf16": (_COMPOSE, "compose_bf16"),
    "fdt_compose_run": (_COMPOSE_RUN, "compose_run"),
    "fdt_compose_run_bf16": (_COMPOSE_RUN, "compose_run_bf16"),
    "fdt_compose_run_split": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
                              "compose_run_split"),
    "fdt_polyexp": ([_P, _P, _P, _I, _I, _I, _I, _P, _I, _P], "polyexp"),
    "fdt_polyexp_scratch": ([_I, _I, _I, _I], None),
    "fdt_pyr_blur": ([_P, _P, _P, _I, _I, _I, _P, _I, _P], "pyr_blur"),
    "fdt_pyr_blur_scratch": ([_I, _I, _I, _I], None),
    "fdt_resize": ([_P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _P], "resize"),
    "fdt_sample": ([_P, _P, _P, _P, _I, _I, _I, _I, _L, _F, _I, _P], "sample"),
    "fdt_sample_split": ([_P, _P, _P, _I, _P, _P, _F, _I, _I, _I, _I, _L, _P],
                         "sample_split"),
    "fdt_umuf": (_UMUF, "umuf"),
    "fdt_umuf_bf16": (_UMUF, "umuf_bf16"),
    "fdt_umuf_smem": ([_I, _I, _I, _I, _I, _I], None),
    "fdt_umuf_strip_smem": ([_I, _I, _I, _I], None),
    "fdt_umuf_split": ([_P, _P, _P, _I, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I,
                        _P], "umuf_split"),
    "fdt_update_flow": ([_P, _P, _I, _I, _I, _I, _F, _P], "uf"),
    "fdt_update_flow_smem": ([_I], None),
    "fdt_update_matrices": (_UM, "um"),
    "fdt_update_matrices_bf16": (_UM, "um_bf16"),
}

# kernel form -> number of launches since the last reset_launches()
LAUNCHES = {form: 0 for _, form in ENTRIES.values() if form}

# the most blocks a grid's y dimension takes, the batch of most kernels
MAX_BATCH = 65535


def reset_launches() -> None:
    for form in LAUNCHES:
        LAUNCHES[form] = 0


@functools.cache
def entry(name: str):
    """The C entry ``name`` of the kernel library, built at first use, with
    its C signature set."""
    argtypes, form = ENTRIES[name]
    fn = getattr(build.load_library(), name)
    fn.argtypes = argtypes
    fn.restype = _I if form else _L
    return fn


def launch(name: str, device: torch.device, *args) -> None:
    """Run the launcher ``name`` with ``args`` on the current stream of
    ``device``, raise on the CUDA error it returns, and count the launch
    under its form."""
    rc = entry(name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    LAUNCHES[ENTRIES[name][1]] += 1


def check_operands(what: str, operands, strided: tuple = (),
                   batch: int | None = None) -> None:
    """Raise ValueError unless the first operand is on a CUDA device and
    every ``(name, tensor, dtypes)`` of ``operands`` has one of ``dtypes``,
    lies on that device and is contiguous (unless named in ``strided``);
    and unless ``batch`` (where given) fits a grid's y dimension."""
    device = operands[0][1].device
    if device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {device}; the "
                         "kernels run on the card")
    for name, t, dtypes in operands:
        contiguous = name not in strided
        if (t.dtype not in dtypes or t.device != device
                or (contiguous and not t.is_contiguous())):
            raise ValueError(f"{what}: {name} must be "
                             f"{'contiguous ' if contiguous else ''}"
                             f"{' or '.join(map(str, dtypes))} on {device}; "
                             f"got {t.dtype} on {t.device}")
    if batch is not None and batch > MAX_BATCH:
        raise ValueError(f"{what}: batch {batch} exceeds the grid's "
                         f"{MAX_BATCH}")


def planes(what: str, img: torch.Tensor) -> torch.Tensor:
    """A float32 (..., H, W) tensor on the card as a contiguous (B, H, W)
    stack; raises ValueError for other operands."""
    check_operands(what, [("img", img, (torch.float32,))], strided=("img",))
    if img.dim() < 2:
        raise ValueError(f"{what}: expected a (..., H, W) tensor, got "
                         f"{tuple(img.shape)}")
    return img.reshape((-1,) + tuple(img.shape[-2:])).contiguous()

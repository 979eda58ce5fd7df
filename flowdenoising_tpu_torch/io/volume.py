"""Extension-dispatched volume read/write.

Reproduces the reference's sniffing rules: input is MRC when the extension
*contains* "mrc" case-insensitively (flowdenoising.py:466), output is MRC on
an exact "mrc"/"MRC" match (flowdenoising.py:539); everything else is TIFF.
"""

from __future__ import annotations

import os

import numpy as np

from flowdenoising_tpu_torch.io.mrc import read_mrc, read_mrc_f32, write_mrc
from flowdenoising_tpu_torch.io.tiff import read_tiff, write_tiff


def _ext(path) -> str:
    return str(path).split(".")[-1]


def is_mrc_input(path) -> bool:
    return "mrc" in _ext(path).lower()


def is_mrc_output(path) -> bool:
    return _ext(path) in ("mrc", "MRC")


def read_volume(path: str | os.PathLike, memory_map: bool = False,
                as_f32: bool = False) -> np.ndarray:
    """Read a volume as (Z, Y, X).  MRC keeps its stored dtype (like
    mrcfile.open(...).data); TIFF is cast to float32 (flowdenoising.py:475).

    ``as_f32`` requests a float32 array directly.
    """
    if is_mrc_input(path):
        if as_f32 and not memory_map:
            return read_mrc_f32(path)
        data, _ = read_mrc(path, memory_map=memory_map)
        return data.astype(np.float32) if as_f32 and data.dtype != np.float32 else data
    data = read_tiff(path)
    if memory_map and not as_f32 and isinstance(data, np.ndarray) \
            and data.base is not None:
        # contiguous native TIFF pages come back as ONE mmap-backed view;
        # streamed mode consumes it in stored dtype (per-window conversion),
        # same as MRC memmaps -- a >RAM stack never materializes
        return data
    return data.astype(np.float32)


def write_volume(path: str | os.PathLike, data: np.ndarray,
                 quantize: bool = False, voxel_size=None) -> None:
    """Write a volume; MRC as float32 (flowdenoising.py:544).

    TIFF: float32 by default (main-CLI semantics).  ``quantize`` applies the
    sequential variant's integer output quantization -- uint8 when
    max < 256 else uint16 (reference ``flowdenoising_sequential.py:566-571``).
    ``voxel_size`` ((vx, vy, vz) Angstroms) is written into the MRC CELLA so
    downstream tools keep the pixel calibration (the reference drops it);
    ignored for TIFF.
    """
    data = np.asarray(data)
    if is_mrc_output(path):
        write_mrc(path, np.asarray(data, dtype=np.float32),
                  voxel_size=voxel_size)
    elif quantize:
        dt = np.uint8 if np.max(data) < 256 else np.uint16
        write_tiff(path, data.astype(dt))
    else:
        write_tiff(path, np.asarray(data, dtype=np.float32))

"""Native MRC2014 volume I/O (the counterpart of
``flowdenoising_tpu/io/mrc.py``).

Replaces the reference's use of the ``mrcfile`` package
(reference ``flowdenoising.py:466-475, 541-545``): read returns the
data array in (Z, Y, X) order exactly as ``mrcfile.open(...).data`` does, and
``write_mrc`` mirrors ``mrcfile.new(...).set_data(float32)`` semantics
(mode 2, dmin/dmax/dmean/rms statistics, little-endian machine stamp).

The reader optionally memory-maps the payload (the ``-m/--memory_map`` CLI
flag) and delegates the dtype conversion of a payload read as float32, and
the statistics and the write of a float32 volume, to the native C++ runtime
when it is built (``flowdenoising_tpu_torch.runtime``), NumPy otherwise.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from flowdenoising_tpu_torch import runtime

_HEADER_BYTES = 1024
# MRC mode -> numpy dtype
_MODE_DTYPES = {
    0: np.dtype(np.int8),
    1: np.dtype(np.int16),
    2: np.dtype(np.float32),
    6: np.dtype(np.uint16),
    12: np.dtype(np.float16),
}
_DTYPE_MODES = {v: k for k, v in _MODE_DTYPES.items()}


@dataclasses.dataclass
class MrcHeader:
    nx: int
    ny: int
    nz: int
    mode: int
    nsymbt: int = 0
    cella: tuple[float, float, float] = (0.0, 0.0, 0.0)
    dmin: float = 0.0
    dmax: float = -1.0
    dmean: float = -2.0
    rms: float = -1.0
    little_endian: bool = True
    mx: int = 0   # sampling grid (words 8-10); 0 -> fall back to map size
    my: int = 0
    mz: int = 0

    @property
    def dtype(self) -> np.dtype:
        dt = _MODE_DTYPES[self.mode]
        return dt.newbyteorder("<" if self.little_endian else ">")

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.nz, self.ny, self.nx)

    @property
    def voxel_size(self) -> tuple[float, float, float] | None:
        """(vx, vy, vz) in Angstroms = CELLA / sampling grid (MX, MY, MZ —
        NOT the map size: a cropped sub-volume keeps the source grid, so
        dividing by NX/NY/NZ would mis-scale it), or None when the header
        carries no cell."""
        if not any(self.cella):
            return None
        mx = self.mx or self.nx
        my = self.my or self.ny
        mz = self.mz or self.nz
        return (self.cella[0] / max(mx, 1),
                self.cella[1] / max(my, 1),
                self.cella[2] / max(mz, 1))


def _parse_header(buf: bytes) -> MrcHeader:
    machst = buf[212:214]
    little = machst not in (b"\x11\x11",)
    e = "<" if little else ">"
    nx, ny, nz, mode = struct.unpack(e + "4i", buf[0:16])
    mx, my, mz = struct.unpack(e + "3i", buf[28:40])
    nsymbt = struct.unpack(e + "i", buf[92:96])[0]
    cella = struct.unpack(e + "3f", buf[40:52])
    dmin, dmax, dmean = struct.unpack(e + "3f", buf[76:88])
    rms = struct.unpack(e + "f", buf[216:220])[0]
    if mode not in _MODE_DTYPES:
        raise ValueError(f"unsupported MRC mode {mode}")
    return MrcHeader(nx=nx, ny=ny, nz=nz, mode=mode, nsymbt=nsymbt, cella=cella,
                     dmin=dmin, dmax=dmax, dmean=dmean, rms=rms, little_endian=little,
                     mx=mx, my=my, mz=mz)


def read_mrc_header(path: str | os.PathLike) -> MrcHeader:
    """Parse just the 1024-byte header of an MRC file."""
    with open(path, "rb") as f:
        return _parse_header(f.read(_HEADER_BYTES))


def read_mrc(path: str | os.PathLike, memory_map: bool = False):
    """Read an MRC file -> (data (Z, Y, X), MrcHeader).

    With ``memory_map`` the payload is a read-only np.memmap (mirrors
    ``mrcfile.mmap``, flowdenoising_sequential.py:510-515).
    """
    with open(path, "rb") as f:
        hdr = _parse_header(f.read(_HEADER_BYTES))
    offset = _HEADER_BYTES + hdr.nsymbt
    count = hdr.nx * hdr.ny * hdr.nz
    if memory_map:
        data = np.memmap(path, dtype=hdr.dtype, mode="r", offset=offset, shape=hdr.shape)
    else:
        data = np.fromfile(path, dtype=hdr.dtype, count=count, offset=offset)
        if data.size != count:
            raise ValueError(f"truncated MRC payload in {path}: "
                             f"expected {count} voxels, got {data.size}")
        data = data.reshape(hdr.shape)
    return data, hdr


def read_mrc_f32(path: str | os.PathLike, n_threads: int | None = None) -> np.ndarray:
    """Read an MRC volume directly as float32 (Z, Y, X), using the native
    C++ decode/convert path when libfdio is built (single copy, fused dtype
    conversion on ``n_threads`` threads), NumPy otherwise."""
    with open(path, "rb") as f:
        hdr = _parse_header(f.read(_HEADER_BYTES))
    offset = _HEADER_BYTES + hdr.nsymbt
    count = hdr.nx * hdr.ny * hdr.nz
    if hdr.little_endian:
        flat = runtime.read_convert_f32(str(path), offset, count, hdr.mode,
                                        n_threads=n_threads)
        if flat is not None:
            return flat.reshape(hdr.shape)
    data = np.fromfile(path, dtype=hdr.dtype, count=count, offset=offset)
    return data.reshape(hdr.shape).astype(np.float32)


def build_mrc_header(nx: int, ny: int, nz: int, mode: int,
                     dmin: float, dmax: float, dmean: float, rms: float,
                     voxel_size=None) -> bytes:
    """Minimal little-endian MRC2014 header (mrcfile-compatible)."""
    hdr = bytearray(_HEADER_BYTES)
    struct.pack_into("<4i", hdr, 0, nx, ny, nz, mode)
    struct.pack_into("<3i", hdr, 28, nx, ny, nz)            # MX, MY, MZ
    if voxel_size is not None:
        vx, vy, vz = (voxel_size,) * 3 if np.isscalar(voxel_size) else voxel_size
        struct.pack_into("<3f", hdr, 40, nx * vx, ny * vy, nz * vz)
    struct.pack_into("<3f", hdr, 52, 90.0, 90.0, 90.0)      # CELLB
    struct.pack_into("<3i", hdr, 64, 1, 2, 3)               # MAPC/R/S
    struct.pack_into("<3f", hdr, 76, dmin, dmax, dmean)
    struct.pack_into("<i", hdr, 88, 0)                      # ISPG (image stack: 0)
    struct.pack_into("<i", hdr, 92, 0)                      # NSYMBT
    struct.pack_into("<i", hdr, 108, 20140)                 # NVERSION
    hdr[208:212] = b"MAP "
    hdr[212:216] = b"\x44\x44\x00\x00"                      # little-endian stamp
    struct.pack_into("<f", hdr, 216, rms)
    struct.pack_into("<i", hdr, 220, 1)                     # NLABL
    label = b"Created by flowdenoising_tpu_torch"
    hdr[224:224 + len(label)] = label
    return bytes(hdr)


def write_mrc(path: str | os.PathLike, data: np.ndarray, voxel_size=None) -> None:
    """Write (Z, Y, X) data as a minimal MRC2014 file (mrcfile-compatible)."""
    data = np.ascontiguousarray(data)
    if data.ndim != 3:
        raise ValueError(f"expected 3-D volume, got shape {data.shape}")
    dt = np.dtype(data.dtype).newbyteorder("=")
    if dt.newbyteorder("<") not in _DTYPE_MODES and dt not in _DTYPE_MODES:
        raise ValueError(f"unsupported dtype for MRC: {data.dtype}")
    mode = _DTYPE_MODES[np.dtype(dt.base.name)]
    nz, ny, nx = data.shape

    if data.size and mode == 2:
        dmin, dmax, dmean, rms = runtime.stats_f32(data)
    elif data.size:
        dmin = float(data.min())
        dmax = float(data.max())
        dmean = float(data.mean())
        rms = float(data.std())
    else:
        dmin, dmax, dmean, rms = 0.0, -1.0, -2.0, -1.0

    hdr = build_mrc_header(nx, ny, nz, mode, dmin, dmax, dmean, rms,
                           voxel_size)

    if mode == 2 and data.dtype.byteorder in ("=", "<", "|"):
        if runtime.write_raw(str(path), bytes(hdr), data):
            return
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        data.astype(data.dtype.newbyteorder("<"), copy=False).tofile(f)

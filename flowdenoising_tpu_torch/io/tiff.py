"""Multi-page TIFF volume I/O (native baseline codec, PIL fallback); a copy
of ``flowdenoising_tpu/io/tiff.py``.

Replaces the reference's ``skimage.io.imread/imsave(plugin="tifffile")``
(reference ``flowdenoising.py:475,548``).  Pages map to Z slices.

The native path writes/reads uncompressed baseline TIFF with a correct
SampleFormat tag, so the dtypes the reference variants produce (float32
always from the main CLI; uint8/uint16 quantization from the sequential
variant, reference ``flowdenoising_sequential.py:566-571``) and the
dtypes microscopy stacks commonly carry (int16 signed counts) round-trip
exactly.  PIL is only consulted for files the native parser can't decode
(compressed / tiled / multi-sample), because PIL silently promotes int16
pages to int32 and can't write signed 16-bit at all.

BigTIFF (version 43, 64-bit offsets) is read transparently and written
automatically whenever the payload would overflow classic TIFF's 32-bit
offsets (volumes >= ~4 GB) -- the regime tifffile's ``bigtiff=True`` covers
for the reference.  Reads are mmap-backed: single-strip pages (what this
writer produces) come back as zero-copy views of the mapping, so opening a
>RAM stack does not materialize it.
"""

from __future__ import annotations

import mmap
import os
import struct

import numpy as np

# (BitsPerSample, SampleFormat) -> dtype.  SampleFormat: 1=uint, 2=int, 3=ieee.
_FMT_TO_DTYPE = {
    (8, 1): np.dtype(np.uint8),
    (8, 2): np.dtype(np.int8),
    (16, 1): np.dtype(np.uint16),
    (16, 2): np.dtype(np.int16),
    (32, 1): np.dtype(np.uint32),
    (32, 2): np.dtype(np.int32),
    (32, 3): np.dtype(np.float32),
    (64, 3): np.dtype(np.float64),
}
_DTYPE_TO_FMT = {v: k for k, v in _FMT_TO_DTYPE.items()}

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
             12: "d", 16: "Q", 17: "q", 18: "Q"}


def _read_ifd_entries(buf, off: int, e: str, big: bool):
    """One IFD: returns (entries, next_ifd_offset).  Classic TIFF entries
    are 12 bytes with 32-bit counts/offsets; BigTIFF entries are 20 bytes
    with 64-bit counts/offsets and a u64 entry count."""
    if big:
        (count,) = struct.unpack_from(e + "Q", buf, off)
        base, esize, cfmt, ofmt, osize = off + 8, 20, "HHQ", "Q", 8
    else:
        (count,) = struct.unpack_from(e + "H", buf, off)
        base, esize, cfmt, ofmt, osize = off + 2, 12, "HHI", "I", 4
    entries = {}
    for i in range(count):
        tag, typ, n = struct.unpack_from(e + cfmt, buf, base + esize * i)
        vo = base + esize * i + (4 + osize)
        size = _TYPE_SIZES.get(typ, 1) * n
        if size > osize:
            (vo,) = struct.unpack_from(e + ofmt, buf, vo)
        if typ in _TYPE_FMT:
            vals = struct.unpack_from(e + str(n) + _TYPE_FMT[typ], buf, vo)
        else:
            vals = ()
        entries[tag] = vals
    (nxt,) = struct.unpack_from(e + ofmt, buf, base + esize * count)
    return entries, nxt


def _read_tiff_native(path) -> np.ndarray | None:
    """Parse an uncompressed striped single-sample TIFF (classic or BigTIFF).

    Returns None when the file needs a general decoder (compression,
    tiling, multi-sample, palettes), in which case the PIL path takes over.
    The file is memory-mapped; a page stored as ONE contiguous strip (the
    layout this module writes) becomes a zero-copy view of the mapping.
    """
    f = open(path, "rb")
    try:
        if os.fstat(f.fileno()).st_size < 16:
            return None
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    finally:
        f.close()
    order = bytes(buf[:2])
    if order == b"II":
        e = "<"
    elif order == b"MM":
        e = ">"
    else:
        return None
    (magic,) = struct.unpack_from(e + "H", buf, 2)
    if magic == 42:
        big = False
        (off,) = struct.unpack_from(e + "I", buf, 4)
    elif magic == 43:
        big = True
        osize, zero = struct.unpack_from(e + "HH", buf, 4)
        if osize != 8 or zero != 0:
            return None
        (off,) = struct.unpack_from(e + "Q", buf, 8)
    else:
        return None

    raw = np.frombuffer(buf, dtype=np.uint8)  # zero-copy view of the map
    pages = []
    descs = []  # (offset, h, w, dt) for single-strip pages, else None
    while off:
        entries, off = _read_ifd_entries(buf, off, e, big)
        w = entries.get(256, (0,))[0]
        h = entries.get(257, (0,))[0]
        bits = entries.get(258, (1,))
        comp = entries.get(259, (1,))[0]
        spp = entries.get(277, (1,))[0]
        fmt = entries.get(339, (1,))[0]
        strip_offs = entries.get(273, ())
        strip_counts = entries.get(279, ())
        if (comp != 1 or spp != 1 or 322 in entries or not strip_offs
                or len(set(bits)) != 1 or (bits[0], fmt) not in _FMT_TO_DTYPE):
            return None
        dt = _FMT_TO_DTYPE[(bits[0], fmt)].newbyteorder(e)
        if not strip_counts:
            strip_counts = (h * w * dt.itemsize,)
        if len(strip_offs) == 1:
            o = strip_offs[0]
            page = raw[o:o + h * w * dt.itemsize].view(dt)[:h * w]
            descs.append((o, h, w, dt))
        else:
            data = b"".join(
                bytes(buf[o:o + c]) for o, c in zip(strip_offs, strip_counts))
            page = np.frombuffer(data, dtype=dt, count=h * w)
            descs.append(None)
        page = page.reshape(h, w)
        if e == ">":
            page = page.astype(dt.newbyteorder("="))
        pages.append(page)
    if not pages:
        return None
    if len(pages) == 1:
        return pages[0]
    # Pages stored back-to-back (this module's own layout): ONE zero-copy
    # view over the whole payload -- a >RAM stack opens without
    # materializing (np.stack below would copy).
    if e == "<" and all(d is not None for d in descs):
        o0, h, w, dt = descs[0]
        pb = h * w * dt.itemsize
        if all(d[1:] == (h, w, dt) for d in descs) and \
                all(d[0] == o0 + z * pb for z, d in enumerate(descs)):
            nz = len(descs)
            return raw[o0:o0 + nz * pb].view(dt).reshape(nz, h, w)
    return np.stack(pages, axis=0)


def _read_tiff_pil(path) -> np.ndarray:
    from PIL import Image
    # Volumes can legitimately be huge; the decompression-bomb guard is not
    # meaningful for scientific stacks we open locally.
    Image.MAX_IMAGE_PIXELS = None
    img = Image.open(path)
    pages = []
    i = 0
    while True:
        try:
            img.seek(i)
        except EOFError:
            break
        pages.append(np.asarray(img))
        i += 1
    if not pages:
        raise ValueError(f"no pages in TIFF {path}")
    return pages[0] if len(pages) == 1 else np.stack(pages, axis=0)


def read_tiff(path: str | os.PathLike) -> np.ndarray:
    """Read a (multi-page) TIFF as (Z, Y, X) (single page -> 2-D).

    Matches skimage.io.imread page stacking; dtype is preserved (including
    signed int16, which PIL would promote to int32).  Classic TIFF and
    BigTIFF are handled transparently.
    """
    data = _read_tiff_native(path)
    if data is None:
        data = _read_tiff_pil(path)
    return data


# Classic TIFF offsets are u32; leave slack for header + IFD tables.
_CLASSIC_LIMIT = 2 ** 32 - (1 << 20)


def write_tiff(path: str | os.PathLike, data: np.ndarray,
               force_bigtiff: bool = False) -> None:
    """Write a (Z, Y, X) array as an uncompressed multi-page TIFF (single
    page for 2-D input).  Supported dtypes: uint8/int8/uint16/int16/uint32/
    int32/float32/float64 -- one strip per page, little-endian.

    Volumes whose payload would overflow classic TIFF's 32-bit offsets are
    written as BigTIFF (version 43) automatically; ``force_bigtiff`` pins
    that layout for testing.
    """
    data = np.asarray(data)
    if data.ndim == 2:
        data = data[None]
    if data.ndim != 3:
        raise ValueError(f"expected 2-D or 3-D data, got shape {data.shape}")
    dt = np.dtype(data.dtype.newbyteorder("="))
    if dt not in _DTYPE_TO_FMT:
        raise ValueError(f"unsupported dtype for TIFF: {data.dtype}")
    bits, fmt = _DTYPE_TO_FMT[dt]
    nz, h, w = data.shape
    page_bytes = h * w * dt.itemsize
    data = np.ascontiguousarray(data.astype(dt.newbyteorder("<"), copy=False))
    # Layout: header | page payloads | IFDs.  The LAST IFD's offset is the
    # largest pointer in the file, so the classic/BigTIFF switch must count
    # the IFD tables too, not just the payload.
    tags = [256, 257, 258, 259, 262, 273, 277, 278, 279, 339]
    classic_ifd = 2 + 12 * len(tags) + 4
    big = force_bigtiff or \
        (8 + page_bytes * nz + classic_ifd * nz) >= _CLASSIC_LIMIT
    if big:
        header = 16
        ifd_size = 8 + 20 * len(tags) + 8
    else:
        header = 8
        ifd_size = classic_ifd
    data_off = header
    ifd0 = data_off + page_bytes * nz

    with open(path, "wb") as f:
        if big:
            f.write(struct.pack("<2sHHHQ", b"II", 43, 8, 0, ifd0))
        else:
            f.write(struct.pack("<2sHI", b"II", 42, ifd0))
        # stream pages (avoids a second full copy of >RAM volumes)
        for z in range(nz):
            f.write(data[z].tobytes())
        for z in range(nz):
            # (type, value); offsets/counts use LONG8 in BigTIFF
            off_t = 16 if big else 4
            entries = {
                256: (4, w), 257: (4, h), 258: (3, bits), 259: (3, 1),
                262: (3, 1), 273: (off_t, data_off + z * page_bytes),
                277: (3, 1), 278: (4, h), 279: (off_t, page_bytes),
                339: (3, fmt),
            }
            nxt = ifd0 + (z + 1) * ifd_size if z + 1 < nz else 0
            if big:
                f.write(struct.pack("<Q", len(entries)))
                for tag in tags:
                    typ, val = entries[tag]
                    f.write(struct.pack("<HHQQ", tag, typ, 1, val))
                f.write(struct.pack("<Q", nxt))
            else:
                f.write(struct.pack("<H", len(entries)))
                for tag in tags:
                    typ, val = entries[tag]
                    f.write(struct.pack("<HHII", tag, typ, 1, val))
                f.write(struct.pack("<I", nxt))

"""The port's MRC / TIFF volume I/O (``flowdenoising_tpu_torch/io``):
round-trips and header compliance, every case of tests/test_io.py with its
parametrisation, run against the port's modules.  The port's I/O is plain
Python and NumPy (with the native runtime's fast paths,
tests/test_torch_runtime.py), so the cases are the JAX package's own."""

import numpy as np
import pytest

from flowdenoising_tpu_torch.io.mrc import read_mrc, write_mrc
from flowdenoising_tpu_torch.io.tiff import read_tiff, write_tiff
from flowdenoising_tpu_torch.io.volume import read_volume, write_volume, is_mrc_input, is_mrc_output


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.int8, np.uint16, np.float16])
def test_mrc_roundtrip(tmp_path, dtype):
    r = np.random.default_rng(0)
    if np.issubdtype(dtype, np.floating):
        vol = r.normal(size=(5, 7, 9)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        vol = r.integers(info.min, info.max, size=(5, 7, 9)).astype(dtype)
    path = tmp_path / "t.mrc"
    write_mrc(path, vol)
    back, hdr = read_mrc(path)
    assert hdr.shape == (5, 7, 9)
    np.testing.assert_array_equal(back, vol)


def test_mrc_header_stats(tmp_path):
    vol = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    path = tmp_path / "s.mrc"
    write_mrc(path, vol)
    _, hdr = read_mrc(path)
    assert hdr.mode == 2
    assert hdr.dmin == 0.0
    assert hdr.dmax == 23.0
    assert abs(hdr.dmean - vol.mean()) < 1e-5
    assert hdr.little_endian


def test_mrc_memory_map(tmp_path):
    vol = np.random.default_rng(1).normal(size=(4, 6, 8)).astype(np.float32)
    path = tmp_path / "m.mrc"
    write_mrc(path, vol)
    back, _ = read_mrc(path, memory_map=True)
    np.testing.assert_array_equal(np.asarray(back), vol)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.uint16])
def test_tiff_roundtrip(tmp_path, dtype):
    r = np.random.default_rng(2)
    if dtype == np.float32:
        vol = r.normal(size=(3, 10, 12)).astype(dtype)
    else:
        vol = r.integers(0, np.iinfo(dtype).max, size=(3, 10, 12)).astype(dtype)
    path = tmp_path / "t.tif"
    write_tiff(path, vol)
    back = read_tiff(path)
    assert back.shape == (3, 10, 12)
    np.testing.assert_array_equal(back, vol)


def test_extension_sniffing():
    # input: substring match (reference flowdenoising.py:466)
    assert is_mrc_input("a.mrc") and is_mrc_input("a.MRC") and is_mrc_input("a.mrcs")
    assert not is_mrc_input("a.tif")
    # output: exact match (reference flowdenoising.py:539)
    assert is_mrc_output("a.mrc") and is_mrc_output("a.MRC")
    assert not is_mrc_output("a.mrcs")


def test_volume_dispatch_roundtrip(tmp_path):
    vol = np.random.default_rng(3).normal(size=(4, 8, 8)).astype(np.float32)
    for name in ("v.mrc", "v.tif"):
        p = tmp_path / name
        write_volume(p, vol)
        back = read_volume(p)
        np.testing.assert_allclose(np.asarray(back, np.float32), vol, rtol=1e-6)


def test_mrc_interop_with_cv2_style_volume(tmp_path):
    # int16 volume like a real tomogram; float32 output like the reference
    vol = (np.random.default_rng(4).normal(size=(3, 5, 5)) * 1000).astype(np.int16)
    p = tmp_path / "tomo.mrc"
    write_mrc(p, vol)
    back, hdr = read_mrc(p)
    assert hdr.mode == 1
    np.testing.assert_array_equal(back, vol)


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.float64, np.int8])
def test_tiff_signed_roundtrip(tmp_path, dtype):
    # int16 pages must come back int16, not PIL's silent int32 promotion.
    r = np.random.default_rng(5)
    info = np.iinfo(dtype) if np.issubdtype(dtype, np.integer) else None
    if info:
        vol = r.integers(info.min, info.max, size=(4, 9, 11)).astype(dtype)
    else:
        vol = r.normal(size=(4, 9, 11)).astype(dtype)
    path = tmp_path / "s.tif"
    write_tiff(path, vol)
    back = read_tiff(path)
    assert back.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(back, vol)


def test_tiff_single_page(tmp_path):
    img = np.arange(20, dtype=np.uint16).reshape(4, 5)
    write_tiff(tmp_path / "p.tif", img)
    back = read_tiff(tmp_path / "p.tif")
    assert back.shape == (4, 5) and back.dtype == np.uint16
    np.testing.assert_array_equal(back, img)


def test_tiff_pil_interop(tmp_path):
    # Files our codec writes must open in a stock reader, and PIL-written
    # files must read through the fallback path.
    from PIL import Image
    vol = np.random.default_rng(6).integers(0, 255, size=(3, 8, 9)).astype(np.uint8)
    write_tiff(tmp_path / "ours.tif", vol)
    img = Image.open(tmp_path / "ours.tif")
    pages = []
    for i in range(3):
        img.seek(i)
        pages.append(np.asarray(img))
    np.testing.assert_array_equal(np.stack(pages), vol)

    frames = [Image.fromarray(vol[i]) for i in range(3)]
    frames[0].save(tmp_path / "pil.tif", save_all=True,
                   append_images=frames[1:], format="TIFF", compression="tiff_lzw")
    back = read_tiff(tmp_path / "pil.tif")  # compressed -> PIL fallback
    np.testing.assert_array_equal(back, vol)


def test_tiff_quantized_output(tmp_path):
    # Reference sequential variant's quantized write: uint8 if max < 256
    # else uint16 (flowdenoising_sequential.py:566-571).
    v8 = np.random.default_rng(7).uniform(0, 200, size=(3, 6, 6)).astype(np.float32)
    write_volume(tmp_path / "q8.tif", v8, quantize=True)
    assert read_tiff(tmp_path / "q8.tif").dtype == np.uint8
    np.testing.assert_array_equal(read_tiff(tmp_path / "q8.tif"), v8.astype(np.uint8))

    v16 = v8 * 50
    write_volume(tmp_path / "q16.tif", v16, quantize=True)
    assert read_tiff(tmp_path / "q16.tif").dtype == np.uint16
    np.testing.assert_array_equal(read_tiff(tmp_path / "q16.tif"), v16.astype(np.uint16))

    # MRC output ignores quantize (reference always writes float32 MRC)
    write_volume(tmp_path / "q.mrc", v16, quantize=True)
    _, hdr = read_mrc(tmp_path / "q.mrc")
    assert hdr.mode == 2


def test_read_volume_as_f32(tmp_path):
    # as_f32 requests the fused native decode/convert path (CLI data path).
    vol = (np.random.default_rng(8).normal(size=(3, 5, 7)) * 500).astype(np.int16)
    write_mrc(tmp_path / "i16.mrc", vol)
    out = read_volume(tmp_path / "i16.mrc", as_f32=True)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, vol.astype(np.float32))


def test_bigtiff_roundtrip(tmp_path):
    """BigTIFF (version 43, 64-bit offsets) round-trips every supported
    dtype; the auto-switch threshold is exercised via force_bigtiff."""
    import struct
    from flowdenoising_tpu_torch.io.tiff import read_tiff, write_tiff
    rng = np.random.default_rng(5)
    for dt in (np.uint8, np.int16, np.uint16, np.float32, np.float64):
        vol = (rng.normal(scale=50, size=(5, 19, 23)) + 100).astype(dt)
        p = tmp_path / f"big_{np.dtype(dt).name}.tif"
        write_tiff(p, vol, force_bigtiff=True)
        with open(p, "rb") as f:
            hdr = f.read(4)
        assert struct.unpack("<2sH", hdr) == (b"II", 43)
        out = read_tiff(p)
        assert out.dtype == np.dtype(dt)
        np.testing.assert_array_equal(out, vol)


def test_bigtiff_single_page(tmp_path):
    from flowdenoising_tpu_torch.io.tiff import read_tiff, write_tiff
    img = np.arange(7 * 11, dtype=np.float32).reshape(7, 11)
    p = tmp_path / "one.tif"
    write_tiff(p, img, force_bigtiff=True)
    out = read_tiff(p)
    assert out.ndim == 2
    np.testing.assert_array_equal(out, img)


def test_tiff_multipage_zero_copy_view(tmp_path):
    """Contiguous same-shape pages come back as ONE mmap-backed view (no
    materialization of the stack)."""
    from flowdenoising_tpu_torch.io.tiff import read_tiff, write_tiff
    vol = np.arange(4 * 8 * 8, dtype=np.int16).reshape(4, 8, 8)
    p = tmp_path / "v.tif"
    write_tiff(p, vol)
    out = read_tiff(p)
    np.testing.assert_array_equal(out, vol)
    assert out.base is not None  # a view of the mapping, not a copy


def test_voxel_size_uses_sampling_grid():
    """A cropped map (NX < MX) must derive voxel size from the sampling
    grid MX/MY/MZ, not the map size (MRC2014 semantics)."""
    from flowdenoising_tpu_torch.io.mrc import MrcHeader
    hdr = MrcHeader(nx=512, ny=512, nz=100, mode=2,
                    cella=(7680.0, 7680.0, 1500.0),
                    mx=1024, my=1024, mz=200)
    np.testing.assert_allclose(hdr.voxel_size, (7.5, 7.5, 7.5))
    # grid absent (0): fall back to map size
    hdr2 = MrcHeader(nx=512, ny=512, nz=100, mode=2,
                     cella=(3840.0, 3840.0, 750.0))
    np.testing.assert_allclose(hdr2.voxel_size, (7.5, 7.5, 7.5))


def test_classic_tiff_limit_counts_ifd_tables(tmp_path, monkeypatch):
    """The classic/BigTIFF switch must account for the IFD tables: the
    last IFD's offset is the largest pointer in the file."""
    import struct
    import flowdenoising_tpu_torch.io.tiff as T
    vol = np.zeros((10, 8, 8), np.uint8)   # payload 640 B, 10 IFDs a 126 B
    # limit between payload-only and payload+IFDs: must choose BigTIFF
    monkeypatch.setattr(T, "_CLASSIC_LIMIT", 8 + 640 + 5 * 126)
    p = tmp_path / "edge.tif"
    T.write_tiff(p, vol)
    with open(p, "rb") as f:
        assert struct.unpack("<2sH", f.read(4)) == (b"II", 43)
    np.testing.assert_array_equal(T.read_tiff(p), vol)

"""The port's data plane (``data/native.py`` over ``csrc/dataplane.cpp``)
against the JAX package's native plane (libpng, ``native/libdataplane.so``)
and against PIL.

Tolerances: against the JAX plane bit for bit (the same fixed-point resize
and normalisation, on the same pixels: libpng's and the port's PNG decode
must agree exactly); against PIL within 1 LSB at uint8, the bar of
tests/test_native.py:35 (the fixed-point bilinear against Pillow's).
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from computervision_codes_tpu.data import native as jax_native
from computervision_codes_tpu.data.synthetic import (
    write_mjpeg_avi as jax_write_mjpeg_avi,
)
from computervision_codes_tpu_torch.data import native, synthetic
from computervision_codes_tpu_torch.data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)

SIZES = [(37, 53), (24, 40), (80, 100)]  # identity, down, up


@pytest.fixture(scope="module")
def png_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("png")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        arr = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
        p = str(d / f"f{i}.png")
        Image.fromarray(arr).save(p)
        paths.append(p)
    return paths


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("threads", [1, 3])
def test_decode_matches_jax_plane(png_files, size, threads):
    got = native.decode_batch_u8(png_files, size, n_threads=threads)
    want = jax_native.decode_batch_u8(png_files, size, n_threads=threads)
    assert got.dtype == np.uint8 and got.shape == (4,) + size + (3,)
    np.testing.assert_array_equal(got, want)
    got = native.decode_batch(png_files, size, n_threads=threads)
    want = jax_native.decode_batch(png_files, size, n_threads=threads)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", SIZES)
def test_decode_within_one_lsb_of_pil(png_files, size):
    got = native.decode_batch_u8(png_files, size)
    for i, p in enumerate(png_files):
        want = np.asarray(Image.open(p).resize(size[::-1], Image.BILINEAR))
        assert np.abs(got[i].astype(int) - want).max() <= 1


def test_uint8_path_matches_float_path(png_files):
    """decode_batch_u8 + host-side normalisation == decode_batch (float)."""
    u8 = native.decode_batch_u8(png_files, (24, 40))
    flt = native.decode_batch(png_files, (24, 40))
    normed = (u8.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    np.testing.assert_allclose(normed, flt, atol=1e-6)


def test_resize_matches_jax_plane_and_pil(png_files):
    """resize_u8 is the JAX plane's resize (compared through its decode of
    the same pixels) and within 1 LSB of PIL's bilinear."""
    pixels = np.asarray(Image.open(png_files[0]))
    for size in SIZES:
        got = native.resize_u8(pixels, size)
        np.testing.assert_array_equal(
            got, jax_native.decode_batch_u8(png_files[:1], size)[0])
        want = np.asarray(Image.fromarray(pixels).resize(size[::-1],
                                                          Image.BILINEAR))
        assert np.abs(got.astype(int) - want).max() <= 1


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filter_rows(rows: np.ndarray, bpp: int) -> bytes:
    """Filter each scanline with type (row index mod 5): every filter in
    every image."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        t = y % 5
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        if t == 0:
            pred = np.zeros_like(row)
        elif t == 1:
            pred = a
        elif t == 2:
            pred = b
        elif t == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        out.append(t)
        out += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def _scanlines(samples: np.ndarray, bit_depth: int) -> np.ndarray:
    """(h, w, ch) samples -> (h, rowbytes) packed bytes."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if bit_depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if bit_depth == 8:
        return flat.astype(np.uint8)
    per = 8 // bit_depth
    pad = (-flat.shape[1]) % per
    flat = np.pad(flat, ((0, 0), (0, pad))).reshape(h, -1, per)
    shifts = bit_depth * np.arange(per - 1, -1, -1)
    return (flat << shifts).sum(-1).astype(np.uint8)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _encode_png(samples, bit_depth, color_type, interlace, palette=None):
    h, w, ch = samples.shape
    bpp = max(1, ch * bit_depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            data += _filter_rows(_scanlines(sub, bit_depth), bpp)
    png = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, bit_depth, color_type, 0, 0, interlace))
    if palette is not None:
        png += _chunk(b"PLTE", palette.tobytes())
    png += _chunk(b"tEXt", b"Comment\x00ancillary, skipped")
    # the image data split over two IDAT chunks
    z = zlib.compress(data)
    png += _chunk(b"IDAT", z[:len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:])
    return png + _chunk(b"IEND", b"")


FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
           (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("color_type,bit_depth", FORMATS)
def test_png_formats_match_libpng(tmp_path, color_type, bit_depth,
                                  interlace):
    """Every PNG colour type and bit depth, plain and Adam7-interlaced,
    every row filter: the port's decode equals libpng's (the JAX plane)
    bit for bit, at the file's size and resized."""
    rng = np.random.default_rng(color_type * 100 + bit_depth)
    h, w = 13, 11  # odd sizes leave Adam7 passes partly empty
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    top = 2 ** bit_depth
    palette = None
    if color_type == 3:
        n_pal = min(top, 7)  # indices past the palette too
        palette = rng.integers(0, 256, (n_pal, 3)).astype(np.uint8)
    samples = rng.integers(0, top, (h, w, ch))
    path = tmp_path / "x.png"
    path.write_bytes(_encode_png(samples, bit_depth, color_type, interlace,
                                 palette))
    for size in ((h, w), (7, 9)):
        got = native.decode_batch_u8([str(path)], size)
        want = jax_native.decode_batch_u8([str(path)], size)
        np.testing.assert_array_equal(got, want)


def test_writer_filters_decode_to_the_pixels(tmp_path):
    """synthetic.write_png with each filter type and the adaptive default:
    the port's decode, PIL's and libpng's all read the pixels written."""
    img = np.random.default_rng(3).integers(0, 256, (17, 23, 3)).astype(
        np.uint8)
    for ft in (0, 1, 2, 3, 4, None):
        p = synthetic.write_png(str(tmp_path / f"f{ft}.png"), img,
                                filter_type=ft)
        np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
        np.testing.assert_array_equal(
            native.decode_batch_u8([p], (17, 23))[0], img)
        np.testing.assert_array_equal(
            jax_native.decode_batch_u8([p], (17, 23))[0], img)
    # a flat frame inflates about 1,000-fold, near deflate's most: not
    # refused by read_png's bound on the header's size
    flat = np.full((1000, 1000, 3), 9, np.uint8)
    p = synthetic.write_png(str(tmp_path / "flat.png"), flat, level=9)
    np.testing.assert_array_equal(
        native.decode_batch_u8([p], (1000, 1000))[0], flat)


def test_writer_adaptive_rows_equal_pils(tmp_path):
    """write_png's default rows (each row's filter type and its bytes, once
    inflated) equal those of PIL's encoder, exactly, on a frame whose upper
    half is smooth and lower half noise, so that every type is chosen."""
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:48, 0:64]
    smooth = np.stack([128 + 100 * np.sin(xx / 7 + yy / 9),
                       128 + 80 * np.cos(yy / 5 + xx / 11), xx * 2.0], -1)
    img = np.concatenate([smooth[:24] + rng.integers(-3, 4, (24, 64, 3)),
                          rng.integers(0, 256, (24, 64, 3))])
    img = np.clip(img, 0, 255).astype(np.uint8)
    mine = synthetic.write_png(str(tmp_path / "mine.png"), img)
    pils = str(tmp_path / "pil.png")
    Image.fromarray(img).save(pils)
    rows = [np.frombuffer(native.read_png(p).data, np.uint8).reshape(48, -1)
            for p in (mine, pils)]
    np.testing.assert_array_equal(rows[0], rows[1])
    assert set(rows[0][:, 0]) == {0, 1, 2, 4}


def test_failures_raise_ioerror(png_files, tmp_path):
    with pytest.raises(IOError):
        native.decode_batch(png_files + ["/nonexistent.png"], (8, 8))
    data = open(png_files[0], "rb").read()
    bad_crc = bytearray(data)
    bad_crc[len(data) // 2] ^= 0xFF  # inside the image data
    def with_ihdr(body: bytes) -> bytes:  # data's IHDR replaced, CRC valid
        return (data[:8] + struct.pack(">I", len(body)) + b"IHDR" + body
                + struct.pack(">I", zlib.crc32(b"IHDR" + body)) + data[33:])

    ihdr = data[16:29]
    cases = {"crc": bytes(bad_crc), "truncated": data[:len(data) // 2],
             "not_png": b"GIF89a" + data[6:],
             "ihdr_length": with_ihdr(ihdr + b"\0"),
             "huge": with_ihdr(struct.pack(">II", 2 ** 31 - 1, 2 ** 31 - 1)
                               + ihdr[8:])}
    for name, blob in cases.items():
        p = tmp_path / f"{name}.png"
        p.write_bytes(blob)
        with pytest.raises(IOError):
            native.decode_batch_u8([str(p)], (8, 8))


def test_jpeg_needs_libjpeg(tmp_path):
    """JPEG stills (by extension or by content) and MJPEG containers raise,
    naming libjpeg, where the JAX plane decodes them."""
    arr = np.random.default_rng(1).integers(0, 256, (32, 32, 3)).astype(
        np.uint8)
    jpg = str(tmp_path / "x.jpg")
    Image.fromarray(arr).save(jpg, quality=95)
    lying = str(tmp_path / "y.png")
    Image.fromarray(arr).save(lying, format="JPEG")
    for p in (jpg, lying):
        assert jax_native.decode_batch_u8([p], (16, 16)).shape == (1, 16,
                                                                   16, 3)
        with pytest.raises(RuntimeError, match="libjpeg"):
            native.decode_batch_u8([p], (16, 16))
    frames = np.random.default_rng(2).integers(0, 256, (3, 24, 40, 3)).astype(
        np.uint8)
    avi = jax_write_mjpeg_avi(str(tmp_path / "v.avi"), frames)
    raw = tmp_path / "v.mjpg"
    raw.write_bytes(b"".join(open(jpg, "rb").read() for _ in range(2)))
    for p in (avi, str(raw)):
        with jax_native.VideoReader(p) as vr:
            assert vr.read_u8([0], (16, 16)).shape == (1, 16, 16, 3)
        with pytest.raises(RuntimeError, match="libjpeg"):
            native.VideoReader(p)
    assert not native.video_supported()
    with pytest.raises(RuntimeError, match="libjpeg"):
        synthetic.write_mjpeg_avi(str(tmp_path / "w.avi"), frames)


def test_route_names_what_it_decodes():
    assert "PNG" in native.route() and "no libjpeg" in native.route()

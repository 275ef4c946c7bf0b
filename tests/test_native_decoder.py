"""Native C++ TIFF decoder vs PIL on the reference fixtures."""

import glob
import io

import numpy as np
import pytest
from PIL import Image

from colormipsearch_tpu.io import native_decoder
from tests.conftest import reference_fixture

FIXDIR = ("/root/reference/colormipsearch-api/src/test/resources/"
          "colormipsearch/api/imageprocessing")
CDSDIR = ("/root/reference/colormipsearch-api/src/test/resources/"
          "colormipsearch/api/cdsearch")


@pytest.fixture(scope="module", autouse=True)
def require_native():
    if not native_decoder.available():
        pytest.skip("native decoder unavailable (no toolchain)")


def _pil_rgb(data):
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"))


def all_fixture_tiffs():
    return sorted(glob.glob(f"{FIXDIR}/*.tif") + glob.glob(f"{CDSDIR}/*.tif"))


@pytest.mark.parametrize("path", all_fixture_tiffs(),
                         ids=lambda p: p.rsplit("/", 1)[-1][:40])
def test_decode_matches_pil(path):
    data = open(path, "rb").read()
    arr = native_decoder.decode_tiff(data)
    if arr is None:
        pytest.skip("unsupported fixture variant for the native path")
    ref = _pil_rgb(data)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, -1).astype(np.uint8)
    np.testing.assert_array_equal(arr, ref)


def test_row_range_decode():
    reference_fixture(FIXDIR)
    path = all_fixture_tiffs()[0]
    data = open(path, "rb").read()
    full = native_decoder.decode_tiff(data)
    if full is None:
        pytest.skip("unsupported fixture")
    part = native_decoder.decode_tiff(data, y0=10, y1=42)
    np.testing.assert_array_equal(part, full[10:42])


def test_packbits_reference_semantics():
    # literal run of 3 + replicate run of 4 + literal 1
    encoded = bytes([2, 1, 2, 3, 0xFD, 9, 0, 7])
    out = np.zeros(8, np.uint8)
    pos = native_decoder.packbits_uncompress(encoded, out)
    assert pos == 8
    np.testing.assert_array_equal(out, [1, 2, 3, 9, 9, 9, 9, 7])
    # partial range [start, end): bytes before start stay untouched; a
    # replicate run that STARTS before `end` is written to completion —
    # the reference's loop only tests `pos < end` per control byte
    # (ImageArrayUtils.packBitsUncompress:228-252), so position 6 is
    # written here even though end == 6
    out2 = np.zeros(8, np.uint8)
    native_decoder.packbits_uncompress(encoded, out2, 0, 3, 6)
    np.testing.assert_array_equal(out2, [0, 0, 0, 9, 9, 9, 9, 0])


def test_batch_decode():
    """Threaded TIFF batch decode.  The shipped fixture set has no two
    same-shape RGB TIFFs, so same-shape blobs are SYNTHESIZED by
    re-encoding the first decodable RGB fixture plus random CDM-like
    planes at its shape (uncompressed + PackBits) — the batch path must
    never silently skip (ADVICE r3 weak #7)."""
    blobs, shape = [], None
    for p in all_fixture_tiffs():
        d = open(p, "rb").read()
        info = native_decoder.tiff_info(d)
        if info and info[2] == 3 and info[3] == 8:
            blobs.append(d)
            shape = info[:2]
            break
    if shape is None:
        w, h = 160, 120
    else:
        w, h = shape
    rng = np.random.default_rng(29)
    for compression in (None, "packbits"):
        arr = np.zeros((h, w, 3), np.uint8)
        ys = rng.integers(0, h, 800)
        xs = rng.integers(0, w, 800)
        arr[ys, xs] = rng.integers(1, 256, (800, 3))
        buf = io.BytesIO()
        kw = {"compression": compression} if compression else {}
        Image.fromarray(arr).save(buf, format="TIFF", **kw)
        d = buf.getvalue()
        if native_decoder.tiff_info(d) is not None:
            blobs.append(d)
    assert len(blobs) >= 2
    arena, ok = native_decoder.decode_tiff_batch(
        blobs, width=w, height=h, channels=3)
    assert ok.all()
    for i, d in enumerate(blobs):
        np.testing.assert_array_equal(arena[i], _pil_rgb(d))


def test_coo_select_equals_numpy():
    """Threaded sparse foreground select (the sparse-upload host half)
    must equal the numpy nonzero path, including threshold edges, an
    all-black image, and a fully-lit image."""
    rng = np.random.default_rng(31)
    arena = np.zeros((5, 17, 23, 3), np.uint8)
    for i in range(4):
        n = 60
        ys, xs = rng.integers(0, 17, n), rng.integers(0, 23, n)
        arena[i, ys, xs] = rng.integers(0, 256, (n, 3))
    arena[1, 0, 0] = (20, 20, 20)   # at threshold: dead
    arena[1, 0, 1] = (0, 0, 21)     # just above: live
    arena[3] = 0                    # all black
    arena[4] = 200                  # fully lit
    res = native_decoder.coo_select(arena, 20)
    assert res is not None
    pos, tidx, rgb = res
    flat = arena.reshape(5, -1, 3)
    live = flat.max(axis=2) > 20
    rtidx, rpos = np.nonzero(live)
    np.testing.assert_array_equal(tidx, rtidx)
    np.testing.assert_array_equal(pos, rpos)
    np.testing.assert_array_equal(rgb, flat[rtidx, rpos])
    assert not (tidx == 3).any() and (tidx == 4).sum() == 17 * 23


def test_read_image_uses_native(tmp_path):
    reference_fixture(CDSDIR)
    from colormipsearch_tpu.io.image import read_image

    path = all_fixture_tiffs()[0]
    img = read_image(path)
    ref = _pil_rgb(open(path, "rb").read())
    np.testing.assert_array_equal(img.as_rgb(), ref)


def _png_bytes(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["rgb", "gray8", "gray16", "rgba"])
def test_png_decode_matches_pil(kind):
    rng = np.random.default_rng(17)
    h, w = 93, 141  # odd sizes exercise filter edge cases
    if kind == "rgb":
        arr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        img = Image.fromarray(arr)
        expect = arr
    elif kind == "gray8":
        arr = rng.integers(0, 256, (h, w)).astype(np.uint8)
        img = Image.fromarray(arr)
        expect = arr
    elif kind == "gray16":
        arr = rng.integers(0, 1 << 16, (h, w)).astype(np.uint16)
        img = Image.fromarray(arr)
        expect = arr
    else:  # rgba: alpha dropped like PIL convert("RGB")
        arr = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
        img = Image.fromarray(arr, mode="RGBA")
        expect = arr[..., :3]
    data = _png_bytes(img)
    got = native_decoder.decode_img(data)
    assert got is not None
    np.testing.assert_array_equal(got, expect)
    info = native_decoder.img_info(data)
    assert info[:2] == (w, h)


def test_png_sparse_cdm_like():
    """Sparse CDM-like content (mostly black) hits filter type 0/2 runs."""
    rng = np.random.default_rng(3)
    h, w = 120, 200
    arr = np.zeros((h, w, 3), np.uint8)
    ys, xs = rng.integers(0, h, 500), rng.integers(0, w, 500)
    arr[ys, xs] = rng.integers(1, 256, (500, 3))
    data = _png_bytes(Image.fromarray(arr))
    np.testing.assert_array_equal(native_decoder.decode_img(data), arr)


def test_png_unsupported_falls_back():
    """Palette PNGs are not handled natively; read_image falls to PIL."""
    from colormipsearch_tpu.io.image import read_image

    rng = np.random.default_rng(5)
    arr = rng.integers(0, 256, (40, 50, 3)).astype(np.uint8)
    pal = Image.fromarray(arr).quantize(colors=16)
    data = _png_bytes(pal)
    assert native_decoder.decode_img(data) is None  # palette -> None
    img = read_image(data)  # PIL fallback path
    np.testing.assert_array_equal(
        img.as_rgb(), np.asarray(pal.convert("RGB")))


def test_png_read_image_gradient_roundtrip(tmp_path):
    """The gradientScores variant flow: 16-bit gradient PNG decodes
    natively to the same values PIL produces."""
    from colormipsearch_tpu.io.image import ImageType, read_image

    rng = np.random.default_rng(11)
    grad = rng.integers(0, 65536, (77, 131)).astype(np.uint16)
    p = tmp_path / "t_gradient.png"
    Image.fromarray(grad).save(p)
    img = read_image(str(p))
    assert img.type is ImageType.GRAY16
    np.testing.assert_array_equal(img.pixels, grad)


def test_png_batch_decode():
    rng = np.random.default_rng(23)
    h, w = 64, 96
    arrs = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            for _ in range(6)]
    blobs = [_png_bytes(Image.fromarray(a)) for a in arrs]
    blobs.append(b"not an image")
    res = native_decoder.decode_img_batch(
        blobs, width=w, height=h, channels=3)
    assert res is not None
    arena, ok = res
    assert ok[:6].all() and not ok[6]
    for i, a in enumerate(arrs):
        np.testing.assert_array_equal(arena[i], a)


def test_palette_tiff_rejected():
    """Palette (photometric=3) TIFF pixels are colormap indices; the
    native path must reject them so the PIL fallback maps the colors."""
    img = Image.new("P", (6, 4))
    img.putpalette([i for rgb in [(255, 0, 0)] * 256 for i in rgb])
    buf = io.BytesIO()
    img.save(buf, format="TIFF")
    assert native_decoder.decode_tiff(buf.getvalue()) is None
    assert native_decoder.tiff_info(buf.getvalue()) is None


def test_decode_tiff_invalid_row_range():
    """y0 >= y1 (or out-of-range) returns None, not an exception."""
    arr = np.zeros((10, 8, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="TIFF")
    data = buf.getvalue()
    assert native_decoder.decode_tiff(data, y0=5, y1=5) is None
    assert native_decoder.decode_tiff(data, y0=9, y1=4) is None
    assert native_decoder.decode_tiff(data, y0=0, y1=99) is None


def test_batch_decode_flags_mismatched_dimensions():
    """A valid blob with the WRONG dimensions must be flagged, not
    tight-packed into the arena slot (silent scramble)."""
    good = np.arange(6 * 4 * 3, dtype=np.uint8).reshape(4, 6, 3)
    small = np.ones((2, 3, 3), np.uint8)
    blobs = []
    for arr in (good, small, good):
        b = io.BytesIO()
        Image.fromarray(arr).save(b, format="PNG")
        blobs.append(b.getvalue())
    res = native_decoder.decode_img_batch(blobs, width=6, height=4,
                                          channels=3)
    assert res is not None
    arena, ok = res
    assert list(ok) == [True, False, True]
    np.testing.assert_array_equal(arena[0], good)
    np.testing.assert_array_equal(arena[2], good)


def test_oversized_header_rejected():
    """Crafted PNG header with ~4 GiB declared dimensions is rejected
    up-front (the size cap), not decoded into wrapped-counter garbage."""
    # minimal PNG: signature + IHDR claiming 40000x40000 RGB
    import struct
    import zlib as _zlib

    ihdr = struct.pack(">IIBBBBB", 40000, 40000, 8, 2, 0, 0, 0)
    chunk = b"IHDR" + ihdr
    png = (b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + chunk +
           struct.pack(">I", _zlib.crc32(chunk)))
    assert native_decoder.img_info(png) is None
    assert native_decoder.decode_img(png) is None

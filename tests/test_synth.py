"""The seeded synthetic library, the stdlib PNG writer, decoding without
Pillow, and where compiled kernels and host artifacts are cached."""

import importlib.util
import os
import sys

import numpy as np
import pytest

from colormipsearch_tpu import synth
from colormipsearch_tpu.io.png import encode_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fg(rgb):
    return (rgb > 20).any(axis=-1)


def test_target_is_deterministic_for_a_seed():
    a = synth.target_image(7, 3)
    assert a.shape == (synth.HEIGHT, synth.WIDTH, 3)
    assert a.dtype == np.uint8
    np.testing.assert_array_equal(a, synth.target_image(7, 3))
    assert not np.array_equal(a, synth.target_image(8, 3))
    assert not np.array_equal(a, synth.target_image(7, 4))


def test_mask_spec_is_deterministic_for_a_seed():
    assert synth.mask_spec(1, 5, 100) == synth.mask_spec(1, 5, 100)
    specs = [synth.mask_spec(1, m, 100) for m in range(8)]
    assert len({s.source for s in specs}) > 1


def test_target_foreground_share_is_about_six_percent():
    shares = [_fg(synth.target_image(0, t)).mean() for t in range(12)]
    assert 0.045 < np.mean(shares) < 0.075, shares
    assert all(0.02 < s < 0.10 for s in shares), shares


def test_target_colours_come_from_the_depth_lut():
    """Every foreground pixel is a depth-LUT colour scaled by a
    brightness in [0.45, 1]: its brightest channel is LUT-max scaled."""
    rgb = synth.target_image(0, 1)
    px = rgb[_fg(rgb)].astype(np.int32)
    assert px.max(axis=-1).min() >= int(0.45 * 255) - 1


@pytest.mark.parametrize("m", range(8))
def test_mask_is_a_placed_cut_of_its_source(m):
    """Undoing the mask's mirror and shift puts every mask pixel on the
    same colour in its source target (except where later paths of the
    target overdraw it)."""
    spec = synth.mask_spec(0, m, 16)
    mask = synth.mask_image(0, spec)
    target = synth.target_image(0, spec.source)
    assert spec.mirrored == (m % 4 == 1)
    assert (spec.shift != (0, 0)) == (m % 4 == 2)
    assert spec.shift in [(0, 0)] + synth._SHIFTS
    back = mask[:, ::-1] if spec.mirrored else mask
    dx, dy = spec.shift
    back = np.roll(back, (-dy, -dx), axis=(0, 1))
    on = _fg(back)
    assert on.sum() > 200
    agree = (back[on] == target[on]).all(axis=-1).mean()
    assert agree > 0.8, agree
    assert _fg(mask).sum() < _fg(target).sum()


def test_write_library_layout(tmp_path):
    specs = synth.write_library(str(tmp_path), seed=2, n_masks=3,
                                n_targets=4, workers=2)
    assert [s.index for s in specs] == [0, 1, 2]
    assert sorted(os.listdir(tmp_path / "targets")) == [
        synth.target_name(t) + ".png" for t in range(4)]
    assert sorted(os.listdir(tmp_path / "masks")) == [
        synth.mask_name(m) + ".png" for m in range(3)]
    from colormipsearch_tpu.io.image import read_image

    got = read_image(str(tmp_path / "targets"
                         / (synth.target_name(2) + ".png"))).pixels
    np.testing.assert_array_equal(got, synth.target_image(2, 2))


def _png_cases():
    rng = np.random.default_rng(0)
    return {
        "rgb8": rng.integers(0, 256, (37, 53, 3)).astype(np.uint8),
        "gray8": rng.integers(0, 256, (19, 23)).astype(np.uint8),
        "gray16": rng.integers(0, 1 << 16, (29, 31)).astype(np.uint16),
    }


@pytest.mark.parametrize("kind", ["rgb8", "gray8", "gray16"])
def test_png_roundtrip_native(kind):
    from colormipsearch_tpu.io import native_decoder

    if not native_decoder.available():
        pytest.skip("native decoder unavailable (no toolchain)")
    arr = _png_cases()[kind]
    got = native_decoder.decode_img(encode_png(arr))
    np.testing.assert_array_equal(got.reshape(arr.shape), arr)


@pytest.mark.parametrize("kind", ["rgb8", "gray8", "gray16"])
def test_png_roundtrip_pillow(kind):
    image = pytest.importorskip("PIL.Image")
    import io

    arr = _png_cases()[kind]
    with image.open(io.BytesIO(encode_png(arr, level=9))) as img:
        got = np.asarray(img)
    np.testing.assert_array_equal(got.astype(arr.dtype), arr)


def test_png_rejects_other_layouts():
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4), np.float32))


def _without_pillow(monkeypatch):
    """Block every PIL module, and check that io.image still imports:
    a fresh copy loads under another name, so the real module (whose
    ImageType other modules hold) is left alone."""
    for name in [n for n in sys.modules if n == "PIL"
                 or n.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)
    import colormipsearch_tpu.io.image as image_mod

    spec = importlib.util.spec_from_file_location(
        "_image_without_pillow", image_mod.__file__)
    fresh = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, fresh)
    spec.loader.exec_module(fresh)
    return image_mod


@pytest.mark.parametrize("kind", ["rgb8", "gray16"])
def test_image_decodes_png_without_pillow(monkeypatch, tmp_path, kind):
    from colormipsearch_tpu.io import native_decoder

    if not native_decoder.available():
        pytest.skip("native decoder unavailable (no toolchain)")
    image_mod = _without_pillow(monkeypatch)
    arr = _png_cases()[kind]
    path = tmp_path / "x.png"
    write_png(path, arr)
    got = image_mod.read_image(str(path))
    np.testing.assert_array_equal(got.pixels, arr)
    assert got.type is (image_mod.ImageType.RGB if kind == "rgb8"
                        else image_mod.ImageType.GRAY16)


def test_image_decodes_tiff_without_pillow(monkeypatch, tmp_path):
    from colormipsearch_tpu.io import native_decoder

    if not native_decoder.available():
        pytest.skip("native decoder unavailable (no toolchain)")
    image_mod = _without_pillow(monkeypatch)
    arr = _png_cases()["rgb8"]
    h, w = arr.shape[:2]
    # minimal uncompressed little-endian baseline RGB TIFF
    import struct

    entries = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, 1, 8),
               (259, 3, 1, 1), (262, 3, 1, 2), (273, 4, 1, 0),
               (277, 3, 1, 3), (278, 3, 1, h), (279, 4, 1, arr.nbytes)]
    ifd_off = 8
    data_off = ifd_off + 2 + 12 * len(entries) + 4
    ifd = struct.pack("<H", len(entries))
    for tag, typ, cnt, val in entries:
        if tag == 273:
            val = data_off
        fmt = "<HHIHH" if typ == 3 else "<HHII"
        ifd += struct.pack(fmt, tag, typ, cnt, val, *(
            [0] if typ == 3 else []))
    blob = b"II*\x00" + struct.pack("<I", ifd_off) + ifd \
        + struct.pack("<I", 0) + arr.tobytes()
    path = tmp_path / "x.tif"
    path.write_bytes(blob)
    np.testing.assert_array_equal(
        image_mod.read_image(str(path)).pixels, arr)


def test_image_without_pillow_names_the_file(monkeypatch, tmp_path):
    image_mod = _without_pillow(monkeypatch)
    path = tmp_path / "x.bmp"
    path.write_bytes(b"BM" + bytes(64))
    with pytest.raises(ValueError, match="x.bmp"):
        image_mod.read_image(str(path))


def test_precompute_variants_writes_pngs_without_pillow(monkeypatch,
                                                        tmp_path):
    from colormipsearch_tpu.io import native_decoder

    if not native_decoder.available():
        pytest.skip("native decoder unavailable (no toolchain)")
    image_mod = _without_pillow(monkeypatch)
    rgb = synth.target_image(0, 0, shape=(60, 90))
    lib = tmp_path / "lib"
    lib.mkdir()
    write_png(lib / "t0_CDM.png", rgb)
    from colormipsearch_tpu.cli.main import main

    assert main(["precomputeVariants", "-i", str(lib),
                 "-od", str(tmp_path / "v")]) == 0
    grad = image_mod.read_image(
        str(tmp_path / "v" / "grad" / "t0_CDM_gradient.png"))
    zgap = image_mod.read_image(
        str(tmp_path / "v" / "zgap" / "t0_CDM_20pxRGB.png"))
    assert grad.type is image_mod.ImageType.GRAY16 \
        or grad.type is image_mod.ImageType.GRAY8
    assert grad.pixels.shape == (60, 90)
    from colormipsearch_tpu.oracle.shape import dilate_rgb, mask_rgb

    np.testing.assert_array_equal(zgap.pixels,
                                  dilate_rgb(mask_rgb(rgb, 20), 20))


def test_compile_cache_in_checkout_when_unset(monkeypatch):
    import jax

    from colormipsearch_tpu.utils import caches

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".cache", "jax")
    assert caches.compilation_cache_dir() == want
    before = jax.config.jax_compilation_cache_dir
    try:
        assert caches.enable_compilation_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_wins_and_no_path_is_set(monkeypatch,
                                                   tmp_path):
    import jax

    from colormipsearch_tpu.utils import caches

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert caches.enable_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself; the program sets no other path
    assert jax.config.jax_compilation_cache_dir == before


def test_artifact_cache_in_checkout(monkeypatch, tmp_path):
    from colormipsearch_tpu.utils import caches

    monkeypatch.delenv("COLORMIPSEARCH_TPU_CACHE", raising=False)
    assert caches.artifact_dir() == os.path.join(REPO, ".cache")
    monkeypatch.setenv("COLORMIPSEARCH_TPU_CACHE", str(tmp_path / "a"))
    assert caches.artifact_dir() == str(tmp_path / "a")


def _installed_caches(tmp_path):
    """utils/caches.py loaded from an install tree with no checkout
    around it (no pyproject.toml at the package's parent)."""
    src = os.path.join(REPO, "colormipsearch_tpu", "utils", "caches.py")
    dst = tmp_path / "site" / "colormipsearch_tpu" / "utils" / "caches.py"
    dst.parent.mkdir(parents=True)
    dst.write_bytes(open(src, "rb").read())
    spec = importlib.util.spec_from_file_location("_installed_caches",
                                                  dst)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_installed_package_keeps_no_cache_without_the_variables(
        monkeypatch, tmp_path):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("COLORMIPSEARCH_TPU_CACHE", raising=False)
    caches = _installed_caches(tmp_path)
    assert caches.CHECKOUT_CACHE is None
    before = jax.config.jax_compilation_cache_dir
    assert caches.compilation_cache_dir() is None
    assert caches.enable_compilation_cache() is None
    assert jax.config.jax_compilation_cache_dir == before
    assert caches.artifact_dir() is None
    assert sorted(os.listdir(tmp_path / "site")) == ["colormipsearch_tpu"]
    monkeypatch.setenv("COLORMIPSEARCH_TPU_CACHE", str(tmp_path / "a"))
    assert caches.artifact_dir() == str(tmp_path / "a")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "j"))
    assert caches.compilation_cache_dir() == str(tmp_path / "j")


def test_slice_table_without_artifact_dir_stays_in_memory(monkeypatch):
    from colormipsearch_tpu.ops import slice_lut

    built = []
    monkeypatch.setattr(slice_lut, "artifact_dir", lambda: None)
    monkeypatch.setattr(slice_lut, "_lut_mem", None)
    monkeypatch.setattr(slice_lut, "build_slice_lut",
                        lambda: built.append(1) or
                        np.zeros(1 << 24, np.uint16))
    lut = slice_lut.get_slice_lut()
    assert lut.shape == (1 << 24,) and built == [1]
    assert slice_lut.get_slice_lut() is lut and built == [1]


def test_native_decoder_without_artifact_dir_is_unavailable(monkeypatch):
    from colormipsearch_tpu.io import native_decoder
    from colormipsearch_tpu.utils import caches

    monkeypatch.setattr(caches, "artifact_dir", lambda: None)
    assert native_decoder._build_lib() is None


def test_write_library_in_processes_matches_in_process(tmp_path,
                                                       monkeypatch):
    """Large libraries are drawn in spawned processes kept off the
    card; the files equal the in-process drawing and the caller's
    environment is left as it was."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu,keep")
    shape = (48, 80)
    specs = synth.write_library(str(tmp_path / "p"), seed=4, n_masks=8,
                                n_targets=60, shape=shape, workers=2)
    assert os.environ["JAX_PLATFORMS"] == "cpu,keep"
    synth.write_library(str(tmp_path / "s"), seed=4, n_masks=8,
                        n_targets=60, shape=shape, workers=1)
    for kind in ("masks", "targets"):
        names = sorted(os.listdir(tmp_path / "p" / kind))
        assert names == sorted(os.listdir(tmp_path / "s" / kind))
        for n in names:
            assert ((tmp_path / "p" / kind / n).read_bytes()
                    == (tmp_path / "s" / kind / n).read_bytes()), n
    assert len(specs) == 8

"""End-to-end gradientScores CLI test with synthesized variants."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tests.conftest import MASK_TIF, TARGET_TIF, reference_fixture


@pytest.fixture()
def pipeline_dirs(tmp_path):
    reference_fixture(MASK_TIF, TARGET_TIF)
    from colormipsearch_tpu.io.image import read_image
    from colormipsearch_tpu.oracle.shape import dilate_rgb, mask_rgb

    lib = tmp_path / "lib"
    grad_dir = tmp_path / "grad"
    zgap_dir = tmp_path / "zgap"
    for d in (lib, grad_dir, zgap_dir):
        d.mkdir()
    shutil.copy(MASK_TIF, lib / Path(MASK_TIF).name)
    shutil.copy(TARGET_TIF, lib / Path(TARGET_TIF).name)

    # synthesized target variants: 16-bit gradient + 20px zgap
    t_rgb = read_image(TARGET_TIF).as_rgb()
    rng = np.random.default_rng(0)
    grad = rng.integers(0, 400, t_rgb.shape[:2]).astype(np.uint16)
    stem = Path(TARGET_TIF).stem
    Image.fromarray(grad).save(grad_dir / f"{stem}_gradient.png")
    zgap = dilate_rgb(mask_rgb(t_rgb, 20), 20)
    Image.fromarray(zgap).save(zgap_dir / f"{stem}_20pxRGB.png")
    return tmp_path


def run_cli(*argv):
    from colormipsearch_tpu.cli.main import main
    assert main([str(a) for a in argv]) == 0


def test_gradient_scores_cli(tmp_path, pipeline_dirs):
    base = pipeline_dirs
    inputs = base / "inputs"
    run_cli("createColorDepthSearchDataInput", "-i", base / "lib",
            "-l", "gslib", "--gradients-location", base / "grad",
            "--zgap-location", base / "zgap",
            "-od", inputs, "--output-filename", "all.json")
    data = json.loads((inputs / "all.json").read_text())
    targets = [d for d in data if "LPLC2" not in d["mipId"]]
    masks = [d for d in data if "LPLC2" in d["mipId"]]
    assert "GradientImage" in targets[0]["computeFiles"]
    assert "ZGapImage" in targets[0]["computeFiles"]
    (inputs / "masks.json").write_text(json.dumps(masks))
    (inputs / "targets.json").write_text(json.dumps(targets))

    out = base / "results"
    run_cli("colorDepthSearch", "-m", inputs / "masks.json",
            "-i", inputs / "targets.json",
            "--maskThreshold", 20, "--dataThreshold", 20,
            "--pixColorFluctuation", 1.0, "--xyShift", 2, "--mirrorMask",
            "-od", out, "--perMaskSubdir", "masks")

    run_cli("gradientScores", "--matches", out / "masks",
            "--maskThreshold", 20, "--mirrorMask",
            "--processing-tag", "gs-run",
            "-od", out, "--perMaskSubdir", "masks")

    doc = json.loads(
        (out / "masks" / f"{Path(MASK_TIF).stem}.json").read_text())
    [res] = doc["results"]
    assert res["matchingPixels"] == 87
    assert res["gradientAreaGap"] >= 0
    assert res["highExpressionArea"] >= 0
    assert res["normalizedScore"] > 0

    # cross-check against the float64 oracle
    from colormipsearch_tpu.io.image import read_image
    from colormipsearch_tpu.oracle.pixel import label_regions_mask
    from colormipsearch_tpu.oracle.shape import (
        ShapeMatchOracle,
        normalized_score,
    )

    mask_rgb_img = read_image(MASK_TIF).as_rgb()
    t_rgb = read_image(TARGET_TIF).as_rgb()
    h, w = mask_rgb_img.shape[:2]
    region = label_regions_mask(w, h)
    grad = np.asarray(Image.open(
        base / "grad" / f"{Path(TARGET_TIF).stem}_gradient.png"))
    zgap = read_image(
        str(base / "zgap" / f"{Path(TARGET_TIF).stem}_20pxRGB.png")).as_rgb()
    oracle = ShapeMatchOracle(mask_rgb_img, 20, mirror=True,
                              excluded_region=region)
    ref = oracle.score(t_rgb, grad, zgap)
    assert res["gradientAreaGap"] == ref.gradient_area_gap
    assert res["highExpressionArea"] == ref.high_expression_area
    expected_norm = normalized_score(
        87, ref.gradient_area_gap, ref.high_expression_area, 87,
        ref.negative_score)
    assert res["normalizedScore"] == pytest.approx(expected_norm, rel=1e-6)


def test_precompute_variants_roundtrip(tmp_path):
    """precomputeVariants output feeds gradientScores: the generated
    zgap must be bit-identical to the on-the-fly dilation fallback, so
    scoring with precomputed variants == scoring without them."""
    reference_fixture(TARGET_TIF)
    from colormipsearch_tpu.io.image import read_image
    from colormipsearch_tpu.oracle.shape import dilate_rgb, mask_rgb

    lib = tmp_path / "lib"
    lib.mkdir()
    shutil.copy(TARGET_TIF, lib / Path(TARGET_TIF).name)
    run_cli("precomputeVariants", "-i", lib, "-od", tmp_path / "var",
            "--maskThreshold", 20, "--negativeRadius", 20)
    stem = Path(TARGET_TIF).stem
    grad_f = tmp_path / "var" / "grad" / f"{stem}_gradient.png"
    zgap_f = tmp_path / "var" / "zgap" / f"{stem}_20pxRGB.png"
    assert grad_f.exists() and zgap_f.exists()

    t_rgb = read_image(str(TARGET_TIF)).as_rgb()
    zgap = read_image(str(zgap_f)).as_rgb()
    expected = dilate_rgb(mask_rgb(t_rgb, 20), 20)
    assert (zgap == expected).all()

    grad = np.asarray(Image.open(grad_f))
    assert grad.dtype == np.uint16 or grad.dtype == np.int32
    fg = (t_rgb > 20).any(axis=-1)
    assert (np.asarray(grad)[fg] == 0).all()   # zero on foreground
    assert np.asarray(grad)[~fg].max() > 0     # grows off-signal


def test_find_variant_nested_and_pattern_fallback(tmp_path):
    """Variant lookup parity with the reference's recursive location
    index + contains-stem pattern fallback
    (mips/FileDataUtils.lookupVariantFileData,
    CreateCDSDataInputCmd.java:418-424): variants nested in
    sub-directories are found, and names that only CONTAIN the
    searchable stem still match when no suffix-derived candidate does."""
    from colormipsearch_tpu.io import mips as mips_io
    from colormipsearch_tpu.model import FileData

    mips_io._dir_entry_index.cache_clear()
    loc = tmp_path / "gradients"
    nested = loc / "segmented_gradient" / "sub"
    nested.mkdir(parents=True)
    # exact suffix-derived candidate, but nested two levels deep
    (nested / "n1_CDM_grad.png").write_bytes(b"x")
    fd = mips_io.find_variant(
        FileData("lib/n1_CDM.tif"), [str(loc)], "_grad")
    assert fd is not None and fd.file_name.endswith(
        "segmented_gradient/sub/n1_CDM_grad.png")

    # no exact suffix candidate -> contains-stem fallback; the variant
    # suffix must still appear in the name (a different variant type
    # must NOT match)
    (nested / "prefix-n2_CDM_grad-objective.tif").write_bytes(b"x")
    (nested / "prefix-n2_CDM_20pxRGB.tif").write_bytes(b"x")
    mips_io._dir_entry_index.cache_clear()
    fd2 = mips_io.find_variant(
        FileData("lib/n2_CDM.png"), [str(loc)], "_grad")
    assert fd2 is not None and "prefix-n2_CDM_grad-objective" in \
        fd2.file_name

    # zip locations: same fallback over entry names
    import zipfile as zf

    zpath = tmp_path / "grads.zip"
    with zf.ZipFile(zpath, "w") as z:
        z.writestr("deep/dir/xx_n3_CDM_grad_yy.png", b"x")
    fd3 = mips_io.find_variant(
        FileData("lib/n3_CDM.png"), [str(zpath)], "_grad")
    assert fd3 is not None and \
        fd3.entry_name == "deep/dir/xx_n3_CDM_grad_yy.png"

    # a genuinely absent variant still misses
    assert mips_io.find_variant(
        FileData("lib/absent_CDM.png"), [str(zpath)], "_grad") is None


def test_find_variant_collision_prefers_mip_parent(tmp_path):
    """Same-basename variants for different libraries resolve to the one
    whose relative path shares the MIP's parent directory (the
    component the v2 reference's ancestor-walk probes)."""
    from colormipsearch_tpu.io import mips as mips_io
    from colormipsearch_tpu.model import FileData

    loc = tmp_path / "grads"
    for lib in ("libA", "libB"):
        d = loc / f"{lib}_gradient"
        d.mkdir(parents=True)
        (d / "n_CDM_gradient.png").write_bytes(b"x")
    mips_io._dir_entry_index.cache_clear()
    fd = mips_io.find_variant(
        FileData("data/libB/n_CDM.png"), [str(loc)], "_gradient")
    assert fd is not None and "libB_gradient" in fd.file_name
    fd = mips_io.find_variant(
        FileData("data/libA/n_CDM.png"), [str(loc)], "_gradient")
    assert fd is not None and "libA_gradient" in fd.file_name


def test_gradient_scores_golden_381229(tmp_path):
    """The verify-recipe gradientScores golden: fixture pair + seeded
    synthesized gradient (rng(0), 0..400 uint16) and zgap
    (dilate(mask(target,20), r=20)) must give gradientAreaGap 381229,
    highExpressionArea 0, normalizedScore 100.0 (single match -> max
    normalization)."""
    reference_fixture(MASK_TIF, TARGET_TIF)
    import shutil

    from colormipsearch_tpu.io.image import read_image
    from colormipsearch_tpu.oracle.shape import dilate_rgb, mask_rgb

    lib = tmp_path / "lib"
    grad = tmp_path / "grad"
    zgap = tmp_path / "zgap"
    for d in (lib, grad, zgap):
        d.mkdir()
    shutil.copy(MASK_TIF, lib / Path(MASK_TIF).name)
    shutil.copy(TARGET_TIF, lib / Path(TARGET_TIF).name)
    t_rgb = read_image(TARGET_TIF).as_rgb()
    rng = np.random.default_rng(0)
    g = rng.integers(0, 400, t_rgb.shape[:2]).astype(np.uint16)
    stem = Path(TARGET_TIF).stem
    Image.fromarray(g).save(grad / f"{stem}_gradient.png")
    Image.fromarray(dilate_rgb(mask_rgb(t_rgb, 20), 20)).save(
        zgap / f"{stem}_20pxRGB.png")

    run_cli("createColorDepthSearchDataInput", "-i", lib, "-l", "glib",
            "--gradients-location", grad, "--zgap-location", zgap,
            "-od", tmp_path / "inputs", "--output-filename", "all.json")
    import json as _json
    neurons = _json.loads((tmp_path / "inputs" / "all.json").read_text())
    masks = [n for n in neurons if "LPLC2" in n["mipId"]]
    targets = [n for n in neurons if "LPLC2" not in n["mipId"]]
    (tmp_path / "inputs" / "masks.json").write_text(_json.dumps(masks))
    (tmp_path / "inputs" / "targets.json").write_text(_json.dumps(targets))
    run_cli("colorDepthSearch", "-m", tmp_path / "inputs" / "masks.json",
            "-i", tmp_path / "inputs" / "targets.json",
            "--maskThreshold", 20, "--dataThreshold", 20,
            "--pixColorFluctuation", 1.0, "--xyShift", 2, "--mirrorMask",
            "-od", tmp_path / "res", "--perMaskSubdir", "masks")
    run_cli("gradientScores", "--matches", tmp_path / "res" / "masks",
            "--maskThreshold", 20, "--mirrorMask",
            "-od", tmp_path / "res", "--perMaskSubdir", "masks")
    doc = _json.loads(
        (tmp_path / "res" / "masks" /
         "1752016801-LPLC2-RT_18U.json").read_text())
    [r] = doc["results"]
    assert r["matchingPixels"] == 87
    assert r["gradientAreaGap"] == 381229
    assert r["highExpressionArea"] == 0
    assert r["normalizedScore"] == 100.0


def test_device_store_auto_default(tmp_path, monkeypatch):
    """gradientScores auto-enables the device-resident shape store at
    >= CDS_SHAPE_STORE_DEVICE_AUTO_MASKS mask files (round-5 A/B), as
    a PER-INVOCATION engine flag (no process-env mutation), and an
    explicit CDS_SHAPE_STORE_DEVICE=0 wins over the auto-default."""
    from colormipsearch_tpu.dataio.json_io import JSONMatchesWriter
    from colormipsearch_tpu.io.image import read_image
    from colormipsearch_tpu.model import (
        CDMatch,
        ComputeFileType,
        FileData,
        Neuron,
    )
    from colormipsearch_tpu.oracle.shape import dilate_rgb, mask_rgb
    from colormipsearch_tpu.utils.metrics import GLOBAL

    rng = np.random.default_rng(5)
    h, w = 40, 64
    lib = tmp_path / "lib"
    lib.mkdir()

    def synth(path, seed):
        img = np.zeros((h, w, 3), np.uint8)
        r = np.random.default_rng(seed)
        img[r.integers(0, h, 400), r.integers(0, w, 400)] = \
            r.integers(0, 256, (400, 3))
        Image.fromarray(img).save(path)
        return img

    t_img = synth(lib / "t0.png", 1)
    grad = rng.integers(0, 400, (h, w)).astype(np.uint16)
    Image.fromarray(grad).save(lib / "t0_grad.png")
    Image.fromarray(dilate_rgb(mask_rgb(t_img, 20), 20)).save(
        lib / "t0_zgap.png")
    t_n = Neuron(mip_id="t0", published_name="t0")
    t_n.set_compute_file(ComputeFileType.InputColorDepthImage,
                         FileData(str(lib / "t0.png")))
    t_n.set_compute_file(ComputeFileType.GradientImage,
                         FileData(str(lib / "t0_grad.png")))
    t_n.set_compute_file(ComputeFileType.ZGapImage,
                         FileData(str(lib / "t0_zgap.png")))

    mdir = tmp_path / "matches"
    writer = JSONMatchesWriter(per_masks_dir=mdir)
    for i in range(4):  # 4 mask files >= threshold of 3 below
        synth(lib / f"m{i}.png", 10 + i)
        m_n = Neuron(mip_id=f"m{i}", published_name=f"m{i}")
        m_n.set_compute_file(ComputeFileType.InputColorDepthImage,
                             FileData(str(lib / f"m{i}.png")))
        writer.write([CDMatch(mask_image=m_n, matched_image=t_n,
                              matching_pixels=50,
                              matching_pixels_ratio=0.1)])
    writer.close()

    monkeypatch.setenv("CDS_SHAPE_STORE_DEVICE_AUTO_MASKS", "3")
    monkeypatch.delenv("CDS_SHAPE_STORE_DEVICE", raising=False)
    store = tmp_path / "pack"
    before = GLOBAL.get("gs.storeUploadBytes")
    # build pass populates the store; auto-default already on (4 >= 3)
    run_cli("gradientScores", "--matches", mdir, "-od", tmp_path / "o1",
            "--maskThreshold", 20, "--no-name-labels",
            "--no-colormap-labels", "--packed-variants-store", store)
    run_cli("gradientScores", "--matches", mdir, "-od", tmp_path / "o2",
            "--maskThreshold", 20, "--no-name-labels",
            "--no-colormap-labels", "--packed-variants-store", store)
    assert GLOBAL.get("gs.storeUploadBytes") > before, \
        "auto-default did not engage the device store"
    assert "CDS_SHAPE_STORE_DEVICE" not in __import__("os").environ, \
        "auto-default must not mutate the process env"

    # explicit off wins over the auto-default
    monkeypatch.setenv("CDS_SHAPE_STORE_DEVICE", "0")
    mid = GLOBAL.get("gs.storeUploadBytes")
    run_cli("gradientScores", "--matches", mdir, "-od", tmp_path / "o3",
            "--maskThreshold", 20, "--no-name-labels",
            "--no-colormap-labels", "--packed-variants-store", store)
    assert GLOBAL.get("gs.storeUploadBytes") == mid

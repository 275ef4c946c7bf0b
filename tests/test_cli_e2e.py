"""End-to-end CLI tests on the reference golden fixtures.

Mirrors the reference's own golden test
(PixelMatchColorDepthSearchAlgorithmTest: LPLC2 mask vs GMR_31G04 target,
thresholds 20/20, xyShift 2, mirror -> 87 matching pixels) but driven
through the full pipeline: createColorDepthSearchDataInput ->
colorDepthSearch -> grouped JSON results.
"""

import json
import shutil
from pathlib import Path

import pytest

from tests.conftest import MASK_TIF, TARGET_TIF, reference_fixture


@pytest.fixture()
def fixture_library(tmp_path):
    reference_fixture(MASK_TIF, TARGET_TIF)
    lib = tmp_path / "lib"
    lib.mkdir()
    shutil.copy(MASK_TIF, lib / Path(MASK_TIF).name)
    shutil.copy(TARGET_TIF, lib / Path(TARGET_TIF).name)
    return lib


def run_cli(*argv):
    from colormipsearch_tpu.cli.main import main
    assert main([str(a) for a in argv]) == 0


def test_create_input_and_search(tmp_path, fixture_library):
    inputs = tmp_path / "inputs"
    run_cli("createColorDepthSearchDataInput",
            "-i", fixture_library, "-l", "testlib",
            "--alignment-space", "JRC2018_Unisex_20x_HR",
            "-od", inputs, "--output-filename", "all.json")
    data = json.loads((inputs / "all.json").read_text())
    assert len(data) == 2
    assert all("InputColorDepthImage" in d["computeFiles"] for d in data)

    # split into masks (EM fixture) / targets (LM fixture)
    mask_stem = Path(MASK_TIF).stem
    masks = [d for d in data if d["mipId"] == mask_stem]
    targets = [d for d in data if d["mipId"] != mask_stem]
    (inputs / "masks.json").write_text(json.dumps(masks))
    (inputs / "targets.json").write_text(json.dumps(targets))

    out = tmp_path / "results"
    run_cli("colorDepthSearch",
            "-m", inputs / "masks.json", "-i", inputs / "targets.json",
            "--maskThreshold", 20, "--dataThreshold", 20,
            "--pixColorFluctuation", 1.0, "--xyShift", 2, "--mirrorMask",
            "--processing-tag", "test-run",
            "-od", out, "--perMaskSubdir", "masks",
            "--perTargetSubdir", "targets")

    mask_file = out / "masks" / f"{mask_stem}.json"
    assert mask_file.exists()
    doc = json.loads(mask_file.read_text())
    assert doc["inputImage"]["mipId"] == mask_stem
    [res] = doc["results"]
    # golden: 87 matching pixels, not mirrored
    # (reference PixelMatchColorDepthSearchAlgorithmTest.java:36-38)
    assert res["matchingPixels"] == 87
    assert res["mirrored"] is False
    assert res["image"]["mipId"] == Path(TARGET_TIF).stem
    assert res["class"] == "org.janelia.colormipsearch.model.CDMatchEntity"

    # bidirectional: per-target grouping contains the inverse match
    tgt_file = out / "targets" / f"{Path(TARGET_TIF).stem}.json"
    assert tgt_file.exists()
    tdoc = json.loads(tgt_file.read_text())
    assert tdoc["results"][0]["image"]["mipId"] == mask_stem

    # session parameters are persisted for provenance
    params = json.loads((out / "cdsParameters.json").read_text())
    assert params["params"]["xyShift"] == "2"


def test_search_local_files(tmp_path, fixture_library):
    out = tmp_path / "v2results"
    run_cli("searchLocalFiles",
            "-m", f"{fixture_library}:0:1",
            "-i", fixture_library,
            "--maskThreshold", 20, "--dataThreshold", 20,
            "--pixColorFluctuation", 1.0, "--xyShift", 2, "--mirrorMask",
            "-od", out)
    files = [f for f in sorted(out.glob("*.json"))
             if not f.name.endswith("cdsparams.json")]
    assert len(files) == 1
    assert list(out.glob("*cdsparams.json")), "v2 params record saved"
    doc = json.loads(files[0].read_text())
    # self-match + cross-match rows, sorted by score desc
    pix = [r["matchingPixels"] for r in doc["results"]]
    assert 87 in pix
    assert doc["maskId"] is not None
    for r in doc["results"]:
        assert r["sourceId"] == doc["maskId"]


def test_multi_shard_streaming(tmp_path, monkeypatch):
    """Targets spanning several shards (CDS_TARGET_TILE shrunk) must
    score identically to a single-shard run — exercises the streamed
    phase-2 loop (recorded batches x later shards) of
    find_all_matches_iter after the round-5 streaming-prep rewrite."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(11)
    h, w = 40, 64
    lib = tmp_path / "lib"
    lib.mkdir()
    for i in range(3):
        img = np.zeros((h, w, 3), np.uint8)
        n = 500
        img[rng.integers(0, h, n), rng.integers(0, w, n)] = \
            rng.integers(0, 256, (n, 3))
        Image.fromarray(img).save(lib / f"m{i}.png")
    for i in range(20):
        img = np.zeros((h, w, 3), np.uint8)
        n = 500
        img[rng.integers(0, h, n), rng.integers(0, w, n)] = \
            rng.integers(0, 256, (n, 3))
        Image.fromarray(img).save(lib / f"t{i:02d}.png")

    inputs = tmp_path / "inputs"
    run_cli("createColorDepthSearchDataInput", "-i", lib, "-l", "ms",
            "-od", inputs, "--output-filename", "all.json")
    data = json.loads((inputs / "all.json").read_text())
    (inputs / "masks.json").write_text(json.dumps(
        [d for d in data if d["mipId"].startswith("m")]))
    (inputs / "targets.json").write_text(json.dumps(
        [d for d in data if d["mipId"].startswith("t")]))

    args = ["colorDepthSearch", "-m", inputs / "masks.json",
            "-i", inputs / "targets.json",
            "--maskThreshold", 20, "--dataThreshold", 20,
            "--pixColorFluctuation", 2.0, "--xyShift", 2,
            "--mirrorMask", "--no-name-labels", "--no-colormap-labels",
            "--perMaskSubdir", "pm"]

    def rows(d):
        out = {}
        for f in sorted((d / "pm").glob("*.json")):
            doc = json.loads(f.read_text())
            out[f.name] = {(r["image"]["mipId"], r["matchingPixels"],
                            r["mirrored"]) for r in doc["results"]}
        return out

    run_cli(*args, "-od", tmp_path / "single")
    monkeypatch.setenv("CDS_TARGET_TILE", "8")  # 20 targets -> 3 shards
    run_cli(*args, "-od", tmp_path / "multi")
    single, multi = rows(tmp_path / "single"), rows(tmp_path / "multi")
    assert single and single == multi

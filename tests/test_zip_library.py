"""Zip-archive library search (BASELINE config 2: CDM subsets from zips)."""

import json
import zipfile
from pathlib import Path

import pytest

from tests.conftest import MASK_TIF, TARGET_TIF, reference_fixture


@pytest.fixture(autouse=True)
def _fixture_tiffs():
    reference_fixture(MASK_TIF, TARGET_TIF)


def run_cli(*argv):
    from colormipsearch_tpu.cli.main import main
    assert main([str(a) for a in argv]) == 0


def test_search_zip_archives(tmp_path):
    zpath = tmp_path / "targets.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        z.write(TARGET_TIF, "subdir/" + Path(TARGET_TIF).name)
        z.write(MASK_TIF, "subdir/" + Path(MASK_TIF).name)
    mdir = tmp_path / "masks"
    mdir.mkdir()
    (mdir / Path(MASK_TIF).name).write_bytes(Path(MASK_TIF).read_bytes())

    out = tmp_path / "results"
    run_cli("searchLocalFiles", "-m", mdir, "-i", zpath,
            "--maskThreshold", 20, "--dataThreshold", 20,
            "--pixColorFluctuation", 1.0, "--xyShift", 2, "--mirrorMask",
            "-od", out)
    [f] = [p for p in sorted(out.glob("*.json"))
           if not p.name.endswith("cdsparams.json")]
    doc = json.loads(f.read_text())
    pix = sorted(r["matchingPixels"] for r in doc["results"])
    assert pix == [87, 1897]
    # matched rows record the zip entry location
    zrows = [r for r in doc["results"]
             if r.get("imageArchivePath", "").endswith("targets.zip")]
    assert len(zrows) == 2
    assert all(r["imageType"] == "zipEntry" for r in zrows)


def test_create_input_from_zip(tmp_path):
    zpath = tmp_path / "lib.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        z.write(MASK_TIF, Path(MASK_TIF).name)
        z.write(TARGET_TIF, Path(TARGET_TIF).name)
    run_cli("createColorDepthSearchDataInput", "-i", f"{zpath}:0:1",
            "-l", "ziplib", "-od", tmp_path, "--output-filename", "z.json")
    data = json.loads((tmp_path / "z.json").read_text())
    assert len(data) == 1
    cf = data[0]["computeFiles"]["InputColorDepthImage"]
    assert cf["dataType"] == "zipEntry"
    assert cf["fileName"] == str(zpath)


def test_target_shard_lazy_host_rgb(tmp_path):
    """TargetShard retains no raw pixel stacks; host_rgb(t) re-decodes
    a single target (file AND zip-entry backed) bit-identically."""
    from colormipsearch_tpu.engine.cds import load_target_shards
    from colormipsearch_tpu.io.image import read_image
    from colormipsearch_tpu.io.mips import (
        list_image_files,
        neurons_from_image_files,
    )

    zpath = tmp_path / "lib.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        z.write(TARGET_TIF, Path(TARGET_TIF).name)
    files = list_image_files(str(zpath)) + [
        f for f in list_image_files(str(Path(TARGET_TIF).parent))
        if "GMR" in f.name or "LPLC2" in f.name]
    neurons = neurons_from_image_files(files)
    assert len(neurons) >= 2
    [shard] = load_target_shards(neurons)
    for i, n in enumerate(shard.neurons):
        rgb = shard.host_rgb(i)
        assert rgb.ndim == 3 and rgb.shape[2] == 3
        assert rgb.max() > 0
    # file-backed target must equal a direct decode
    direct = read_image(TARGET_TIF).as_rgb()
    idx = [i for i, n in enumerate(shard.neurons) if "GMR" in n.mip_id]
    assert any((shard.host_rgb(i) == direct).all() for i in idx)

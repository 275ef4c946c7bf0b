"""Tests for admin/migration commands."""

import json
from pathlib import Path

import pytest

from tests.conftest import reference_fixture

PPP_FIXTURES = ("/root/reference/colormipsearch-api/src/test/resources/"
                "colormipsearch/api/pppsearch")
LEGACY = ("/root/reference/colormipsearch-api/src/test/resources/"
          "colormipsearch/api/cdsearch/"
          "legacy_2757945549444349963_cdsresult.json")


def run_cli(*argv):
    from colormipsearch_tpu.cli.main import main
    assert main([str(a) for a in argv]) == 0


def test_legacy_import_fs(tmp_path):
    reference_fixture(LEGACY)
    out = tmp_path / "v3"
    run_cli("legacyImport", "-rf", LEGACY,
            "--mask-library", "FlyEM Hemibrain",
            "--target-library", "FlyLight Gen1 MCFO",
            "-od", out)
    files = sorted(out.glob("*.json"))
    assert len(files) == 1
    doc = json.loads(files[0].read_text())
    assert doc["inputImage"]["class"].endswith("EMNeuronEntity")
    assert doc["inputImage"]["publishedName"] == "359594119"
    res = doc["results"]
    assert len(res) >= 2
    # legacy attrs were mined for scores
    assert any(r.get("gradientAreaGap") for r in res)
    assert all(r["image"]["class"].endswith("LMNeuronEntity") for r in res)
    # sorted by normalized score desc
    scores = [r["normalizedScore"] for r in res]
    assert scores == sorted(scores, reverse=True)


def test_legacy_import_db(tmp_path):
    reference_fixture(LEGACY)
    cfg = tmp_path / "c.properties"
    cfg.write_text(f"Store.Path={tmp_path}/db.sqlite\n")
    run_cli("legacyImport", "-rf", LEGACY, "--results-storage", "DB",
            "--config", cfg)
    from colormipsearch_tpu.persist import Config, DaosProvider
    from colormipsearch_tpu.persist.requests import NeuronSelector

    daos = DaosProvider(Config(str(cfg)))
    ms = daos.cd_matches_dao.find_matches_by_mask(NeuronSelector())
    assert len(ms) >= 2
    assert all(m.matching_pixels > 0 for m in ms)
    daos.store.close()


def test_validate_fs(tmp_path, capsys):
    from colormipsearch_tpu.model import EMNeuron, ComputeFileType
    from colormipsearch_tpu.dataio.json_io import write_neurons_json

    good = EMNeuron(mip_id="g", published_name="1")
    bad = EMNeuron(mip_id="b", published_name="2")
    bad.set_compute_file(ComputeFileType.InputColorDepthImage,
                         "/nonexistent/x.tif")
    f = tmp_path / "n.json"
    write_neurons_json([good, bad], f)
    run_cli("validateDBData", "-i", f)
    out = capsys.readouterr().out
    stats = json.loads(out.strip().splitlines()[-1])
    assert stats["neuronsChecked"] == 2
    assert stats["neuronsWithErrors"] == 1


def test_copy_to_mips_store(tmp_path):
    from colormipsearch_tpu.model import EMNeuron, ComputeFileType
    from colormipsearch_tpu.dataio.json_io import (
        read_neurons_json,
        write_neurons_json,
    )

    img = tmp_path / "img.tif"
    img.write_bytes(b"fakeimage")
    n = EMNeuron(mip_id="m", published_name="1",
                 library_name="lib", alignment_space="AS")
    n.set_compute_file(ComputeFileType.InputColorDepthImage, str(img))
    f = tmp_path / "n.json"
    write_neurons_json([n], f)
    store = tmp_path / "store"
    run_cli("copyToMipsStore", "-i", f, "--store-dir", store)
    copied = store / "AS" / "lib" / "cdm" / "img.tif"
    assert copied.read_bytes() == b"fakeimage"
    back = read_neurons_json(f)
    assert back[0].compute_file(
        ComputeFileType.InputColorDepthImage).file_name == str(copied)


def test_convert_ppp(tmp_path):
    reference_fixture(PPP_FIXTURES)
    out = tmp_path / "ppp_v2"
    run_cli("convertPPPResults", "-rd", PPP_FIXTURES, "-od", out)
    files = sorted(out.glob("*.json"))
    assert len(files) == 2
    doc = json.loads((out / "1599747200.json").read_text())
    assert doc["maskPublishedName"] == "1599747200"
    assert doc["results"][0]["lmSlideCode"]

    trimmed = tmp_path / "ppp_top"
    run_cli("copyPPPMatches", "-i", out, "-od", trimmed, "--top", "3")
    tdoc = json.loads((trimmed / "1599747200.json").read_text())
    assert len(tdoc["results"]) == 3


def test_legacy_import_suspicious_tagging(tmp_path):
    """Neurons created by the import get --imported-neuron-tag; matches
    referencing created neurons get --suspicious-match-tag
    (ImportV2CDMatchesCmd:255-278)."""
    reference_fixture(LEGACY)
    cfg = tmp_path / "c.properties"
    cfg.write_text(f"Store.Path={tmp_path}/db.sqlite\n")
    run_cli("legacyImport", "-r", LEGACY, "--results-storage", "DB",
            "--config", cfg, "--tag", "v2import")
    from colormipsearch_tpu.persist import Config, DaosProvider
    from colormipsearch_tpu.persist.requests import NeuronSelector

    daos = DaosProvider(Config(str(cfg)))
    ms = daos.cd_matches_dao.find_matches_by_mask(NeuronSelector())
    # the store was empty, so every neuron was created -> all suspicious
    assert all("Suspicious match" in m.tags for m in ms)
    ns = daos.neuron_metadata_dao.find_neurons(NeuronSelector())
    assert all("Created by import" in n.tags for n in ns)
    daos.store.close()


def test_tag_db_mode_with_selector(tmp_path):
    """DB-backed tag with the neuron selector (TagNeuronMetadataCmd)."""
    from colormipsearch_tpu.model import EMNeuron
    from colormipsearch_tpu.persist import Config, DaosProvider
    from colormipsearch_tpu.persist.requests import NeuronSelector

    cfg = tmp_path / "c.properties"
    cfg.write_text(f"Store.Path={tmp_path}/db.sqlite\n")
    daos = DaosProvider(Config(str(cfg)))
    a = EMNeuron(mip_id="a", published_name="111", library_name="em",
                 source_ref_id="EMBody#1", tags={"seed"})
    b = EMNeuron(mip_id="b", published_name="222", library_name="em",
                 source_ref_id="EMBody#2")
    for n in (a, b):
        daos.neuron_metadata_dao.create_or_update(n)
    daos.store.close()

    run_cli("tag", "--config", cfg, "--tag", "r1",
            "--data-tags", "seed", "-l", "em")
    daos = DaosProvider(Config(str(cfg)))
    by_mip = {n.mip_id: n for n in
              daos.neuron_metadata_dao.find_neurons(NeuronSelector())}
    assert "r1" in by_mip["a"].tags
    assert "r1" not in by_mip["b"].tags
    daos.store.close()

    run_cli("tag", "--config", cfg, "--tag", "r2",
            "--source-refs", "EMBody#2")
    daos = DaosProvider(Config(str(cfg)))
    by_mip = {n.mip_id: n for n in
              daos.neuron_metadata_dao.find_neurons(NeuronSelector())}
    assert "r2" in by_mip["b"].tags and "r2" not in by_mip["a"].tags
    daos.store.close()


def test_validate_selector_and_grad_skip(tmp_path, capsys):
    """validateDBData selector flags narrow the validated set; the
    --no-grad-files-check flag skips gradient/zgap existence checks."""
    from colormipsearch_tpu.model import (
        ComputeFileType,
        EMNeuron,
        FileData,
    )
    from colormipsearch_tpu.persist import Config, DaosProvider

    cfg = tmp_path / "c.properties"
    cfg.write_text(f"Store.Path={tmp_path}/db.sqlite\n")
    daos = DaosProvider(Config(str(cfg)))
    img = tmp_path / "ok.png"
    img.write_bytes(b"x")
    good = EMNeuron(mip_id="g", published_name="1", library_name="em")
    good.set_compute_file(ComputeFileType.InputColorDepthImage,
                          FileData(str(img)))
    # gradient file missing -> error only when grad checks are on
    good.set_compute_file(ComputeFileType.GradientImage,
                          FileData(str(tmp_path / "missing_grad.png")))
    other = EMNeuron(mip_id="o", published_name="2", library_name="lm")
    for n in (good, other):
        daos.neuron_metadata_dao.create_or_update(n)
    daos.store.close()

    run_cli("validateDBData", "--results-storage", "DB", "--config", cfg,
            "-l", "em", "--no-grad-files-check")
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["neuronsChecked"] == 1
    assert rep["neuronsWithErrors"] == 0

    run_cli("validateDBData", "--results-storage", "DB", "--config", cfg,
            "-l", "em")
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["neuronsWithErrors"] == 1

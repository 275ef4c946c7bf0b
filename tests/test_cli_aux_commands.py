"""Tests for auxiliary CLI commands: PPP import, export, merge, tag,
reverse score transfer."""

import json
from pathlib import Path

import pytest

from tests.conftest import MASK_TIF, TARGET_TIF, reference_fixture

PPP_FIXTURES = ("/root/reference/colormipsearch-api/src/test/resources/"
                "colormipsearch/api/pppsearch")


def run_cli(*argv):
    from colormipsearch_tpu.cli.main import main
    assert main([str(a) for a in argv]) == 0


def test_import_ppp_results(tmp_path):
    reference_fixture(PPP_FIXTURES)
    out = tmp_path / "ppp"
    run_cli("importPPPResults", "-rd", PPP_FIXTURES,
            "--em-library", "flyem_hemibrain_1_2_1",
            "--lm-library", "FlyLight Gen1 MCFO",
            "--alignment-space", "JRC2018_Unisex_20x_HR",
            "--include-skeletons",
            "-od", out)
    files = sorted(out.glob("*.json"))
    assert len(files) >= 2
    doc = json.loads((out / "1599747200.json").read_text())
    assert doc["inputImage"]["publishedName"] == "1599747200"
    assert doc["inputImage"]["neuronType"] == "PFNp_c"
    first = doc["results"][0]
    # results sorted by rank ascending
    ranks = [r.get("rank") for r in doc["results"]]
    assert ranks == sorted(ranks)
    assert first["sourceLmName"]
    assert first["coverageScore"] is not None
    # lm name parsing: line + slide code + objective
    assert first["image"]["slideCode"]
    assert first["image"]["objective"] in ("20x", "40x", "63x")
    assert first["skeletonMatches"], "skeletons requested"


def test_export_cd_matches(tmp_path):
    # build a tiny grouped match file in the v3 shape
    from colormipsearch_tpu.model import CDMatch, EMNeuron, LMNeuron
    from colormipsearch_tpu.dataio.json_io import JSONMatchesWriter

    em = EMNeuron(mip_id="em1", published_name="12345",
                  library_name="FlyEM_Hemibrain", alignment_space="AS")
    lm = LMNeuron(mip_id="lm1", published_name="R99X99",
                  library_name="MCFO", slide_code="sc1", gender="f")
    m = CDMatch(mask_image=em, matched_image=lm, matching_pixels=87,
                matching_pixels_ratio=0.05, normalized_score=2801.1,
                mirrored=False)
    dup = CDMatch(mask_image=em, matched_image=lm, matching_pixels=50,
                  matching_pixels_ratio=0.03, normalized_score=1000.0,
                  mirrored=True)
    matches_dir = tmp_path / "matches"
    JSONMatchesWriter(per_masks_dir=matches_dir).write([m, dup])

    out = tmp_path / "export"
    run_cli("exportData", "--exported-result-type", "EM_CD_MATCHES",
            "--ignore-grad-scores",
            "--matches", matches_dir, "-od", out)
    doc = json.loads((out / "12345.json").read_text())
    assert doc["inputImage"]["type"] == "EMImage"
    assert doc["inputImage"]["id"] == "em1"
    # deduped to the best match per MIP pair
    assert len(doc["results"]) == 1
    res = doc["results"][0]
    assert res["type"] == "CDSMatch"
    assert res["normalizedScore"] == pytest.approx(2801.1)
    assert res["image"]["type"] == "LMImage"
    assert res["image"]["slideCode"] == "sc1"


def test_reverse_transfer_and_merge(tmp_path):
    from colormipsearch_tpu.dataio import v2_io

    src = v2_io.MIPMetadata(id="LM1", publishedName="lineA",
                            imageName="a/lm1.tif")
    tgt = v2_io.MIPMetadata(id="EM1", publishedName="111",
                            imageName="b/em1.tif")
    # forward LM->EM file without negative scores
    fwd = v2_io.CDSMatches(maskId="LM1", results=[
        v2_io.V2Match(source=src, target=tgt, matchingPixels=87,
                      matchingRatio=0.05)])
    fwd_dir = tmp_path / "fwd"
    v2_io.write_cds_matches(fwd, fwd_dir / "LM1.json")
    # reverse EM->LM file carrying the negative scores
    rev = v2_io.CDSMatches(maskId="EM1", results=[
        v2_io.V2Match(source=tgt, target=src, matchingPixels=87,
                      matchingRatio=0.05, gradientAreaGap=2438,
                      highExpressionArea=100,
                      normalizedGapScore=998.35)])
    rev_dir = tmp_path / "rev"
    v2_io.write_cds_matches(rev, rev_dir / "EM1.json")

    out = tmp_path / "updated"
    run_cli("gradientScoresFromMatchedResults",
            "-rf", fwd_dir / "LM1.json", "-revd", rev_dir, "-od", out)
    doc = json.loads((out / "LM1.json").read_text())
    [r] = doc["results"]
    assert r["gradientAreaGap"] == 2438
    assert r["highExpressionArea"] == 100
    assert r["normalizedGapScore"] == pytest.approx(998.35)
    assert r["normalizedScore"] == pytest.approx(998.35)


def test_merge_mips_and_group(tmp_path):
    from colormipsearch_tpu.dataio import v2_io

    a = [v2_io.MIPMetadata(id="1", publishedName="n1", imageName="x/1.tif"),
         v2_io.MIPMetadata(id="2", publishedName="n2", imageName="x/2.tif")]
    b = [v2_io.MIPMetadata(id="2", publishedName="n2", imageName="x/2.tif"),
         v2_io.MIPMetadata(id="3", publishedName="n1", imageName="x/3.tif")]
    v2_io.write_mips_json(a, tmp_path / "a.json")
    v2_io.write_mips_json(b, tmp_path / "b.json")

    run_cli("mergeMips", "-i", tmp_path / "a.json", tmp_path / "b.json",
            "--output-filename", "merged.json", "-od", tmp_path)
    merged = v2_io.read_mips_json(tmp_path / "merged.json")
    assert [m.id for m in merged] == ["1", "2", "3"]

    run_cli("groupMIPsByPublishedName", "-i", tmp_path / "merged.json",
            "-od", tmp_path / "grouped")
    g = v2_io.read_mips_json(tmp_path / "grouped" / "n1.json")
    assert sorted(m.id for m in g) == ["1", "3"]


def test_tag_command(tmp_path):
    from colormipsearch_tpu.model import EMNeuron
    from colormipsearch_tpu.dataio.json_io import (
        read_neurons_json,
        write_neurons_json,
    )

    neurons = [EMNeuron(mip_id="a", published_name="x"),
               EMNeuron(mip_id="b", published_name="y")]
    f = tmp_path / "n.json"
    write_neurons_json(neurons, f)
    run_cli("tag", "-i", f, "--tag", "v1", "--published-names", "x")
    back = read_neurons_json(f)
    tags = {n.mip_id: n.tags for n in back}
    assert tags["a"] == {"v1"}
    assert tags["b"] == set()


def test_export_ppp_matches(tmp_path):
    reference_fixture(PPP_FIXTURES)
    imported = tmp_path / "ppp"
    run_cli("importPPPResults", "-rd", PPP_FIXTURES,
            "--em-library", "hemibrain", "--lm-library", "mcfo",
            "-od", imported)
    out = tmp_path / "publish"
    run_cli("exportData", "--exported-result-type", "EM_PPP_MATCHES",
            "--matches", imported, "-od", out)
    doc = json.loads((out / "1599747200.json").read_text())
    assert doc["inputImage"]["type"] == "EMImage"
    res = doc["results"]
    assert res and res[0]["type"] == "PPPMatch"
    assert "pppmRank" in res[0]
    assert res[0]["image"]["type"] == "LMImage"


def test_export_with_published_urls(tmp_path):
    from colormipsearch_tpu.model import CDMatch, EMNeuron, LMNeuron
    from colormipsearch_tpu.dataio.json_io import JSONMatchesWriter

    em = EMNeuron(mip_id="em1", published_name="777",
                  library_name="FlyEM", alignment_space="AS")
    lm = LMNeuron(mip_id="lm1", published_name="lineQ",
                  library_name="MCFO", slide_code="sc")
    m = CDMatch(mask_image=em, matched_image=lm, matching_pixels=10,
                matching_pixels_ratio=0.1, normalized_score=5.0)
    matches_dir = tmp_path / "m"
    JSONMatchesWriter(per_masks_dir=matches_dir).write([m])
    urls = tmp_path / "urls.json"
    urls.write_text(json.dumps({
        "em1": {"CDM": "https://s3/em.png",
                "CDMThumbnail": "https://s3/em.jpg"},
        "lm1": {"CDM": "https://s3/lm.png"}}))
    out = tmp_path / "pub"
    run_cli("exportData", "--exported-result-type", "EM_CD_MATCHES",
            "--ignore-grad-scores",
            "--matches", matches_dir, "--published-urls", urls, "-od", out)
    doc = json.loads((out / "777.json").read_text())
    assert doc["inputImage"]["files"]["CDM"] == "https://s3/em.png"
    assert doc["results"][0]["image"]["files"]["CDM"] == "https://s3/lm.png"


def test_import_ppp_screenshots_and_db_resolution(tmp_path):
    """Screenshot attachment (lookupScreenshots) + DB mask resolution +
    PPPMatch processing tags (ImportPPPResultsCmd DB mode)."""
    reference_fixture(PPP_FIXTURES)
    import shutil

    from colormipsearch_tpu.model import EMNeuron, ProcessingType
    from colormipsearch_tpu.persist import Config, DaosProvider

    # stage the fixture next to a screenshots dir we control
    rd = tmp_path / "ppp_in"
    rd.mkdir()
    src = Path(PPP_FIXTURES) / "cov_scores_1599747200-PFNp_c-RT_18U.json"
    shutil.copy(src, rd / src.name)
    shots = rd / "screenshots"
    shots.mkdir()
    em_name = "1599747200-PFNp_c-RT_18U"
    lm_name = "BJD_115G11_AE_01-20190507_62_F1_REG_UNISEX_40x"
    for suffix in ("_1_raw.png", "_2_masked_raw.png", "_5_ch.png"):
        (shots / f"{em_name}-{lm_name}{suffix}").write_bytes(b"png")
    # unrelated screenshot must not attach
    (shots / f"999-{lm_name}_1_raw.png").write_bytes(b"png")

    # pre-register the EM neuron so DB resolution binds the mask ref
    db = tmp_path / "db.sqlite"
    cfg_file = tmp_path / "cfg.properties"
    cfg_file.write_text(f"Store.Path={db}\n")
    daos = DaosProvider(Config(str(cfg_file)))
    em = EMNeuron(mip_id="em-mip-1", published_name="1599747200",
                  library_name="flyem_hemibrain_1_2_1")
    daos.neuron_metadata_dao.create_or_update(em)

    out = tmp_path / "ppp_out"
    run_cli("importPPPResults", "-rd", rd,
            "--em-library", "flyem_hemibrain_1_2_1",
            "--lm-library", "FlyLight Gen1 MCFO",
            "--alignment-space", "JRC2018_Unisex_20x_HR",
            "--mips-storage", "DB", "--results-storage", "DB",
            "--processing-tag", "ppp-run-1",
            "--config", cfg_file, "-od", out)

    doc = json.loads((out / "1599747200.json").read_text())
    # the mask is the REGISTERED neuron, not a synthesized one
    assert doc["inputImage"]["entityId"] == str(em.entity_id)
    assert doc["inputImage"]["mipId"] == "em-mip-1"
    by_lm = {r["sourceLmName"]: r for r in doc["results"]}
    files = by_lm[lm_name].get("sourceImageFiles")
    assert files and set(files) == {"RAW", "MASKED_RAW", "CH"}
    assert files["RAW"].endswith(f"{em_name}-{lm_name}_1_raw.png")
    # matches landed in the DB store too
    rows = daos.ppp_matches_dao.find_all()
    assert len(rows) == len(doc["results"])
    # processing tag stamped on the registered EM neuron
    fresh = daos.neuron_metadata_dao.find_by_id(em.entity_id)
    assert "ppp-run-1" in \
        (fresh.processed_tags.get(ProcessingType.PPPMatch) or set())


def test_export_db_read_path_with_url_transforms(tmp_path):
    """exportData --results-storage DB: reads matches per mask from the
    store, applies image-store mapping (files.store) and URL transforms
    (ExportData4NBCmd.java:50-392) without intermediate files."""
    from colormipsearch_tpu.model import CDMatch, EMNeuron, LMNeuron
    from colormipsearch_tpu.persist import Config, DaosProvider

    db = tmp_path / "db.sqlite"
    cfg_file = tmp_path / "cfg.properties"
    cfg_file.write_text(f"Store.Path={db}\n")
    daos = DaosProvider(Config(str(cfg_file)))

    em = EMNeuron(mip_id="em1", published_name="12345",
                  library_name="flyem_hemibrain_1_2_1",
                  alignment_space="JRC2018_Unisex_20x_HR")
    lm = LMNeuron(mip_id="lm1", published_name="R99X99",
                  library_name="MCFO", slide_code="sc1", gender="f",
                  alignment_space="JRC2018_Unisex_20x_HR")
    daos.neuron_metadata_dao.create_or_update(em)
    daos.neuron_metadata_dao.create_or_update(lm)
    m = CDMatch(mask_image=em, matched_image=lm,
                mask_image_ref_id=em.entity_id,
                matched_image_ref_id=lm.entity_id,
                matching_pixels=87, matching_pixels_ratio=0.05,
                normalized_score=2801.1, match_found=True)
    daos.cd_matches_dao.create_or_update_all([m])

    urls = tmp_path / "urls.json"
    urls.write_text(json.dumps({
        "em1": {"CDM": "https://s3.host/bucket/v3/em/12345-cdm.png"},
        "lm1": {"CDM": "/nrs/some/local/path/lm1-cdm.png"},
    }))
    out = tmp_path / "pub"
    run_cli("exportData", "--exported-result-type", "EM_CD_MATCHES",
            "--ignore-grad-scores",
            "--results-storage", "DB", "--config", cfg_file,
            "--alignment-space", "JRC2018_Unisex_20x_HR",
            "-l", "flyem_hemibrain_1_2_1",
            "--published-urls", urls,
            "--default-relative-url-index", "2",
            "--default-image-store", "brain-store",
            "--image-stores-per-neuron-meta",
            "JRC2018_Unisex_20x_HR,MCFO:lm-store",
            "-od", out)

    doc = json.loads((out / "12345.json").read_text())
    files = doc["inputImage"]["files"]
    # https URL path /bucket/v3/em/... relativized from component
    # index 2 (Java Path.subpath semantics); store stamped by the
    # (alignmentSpace, library) mapping with the default as fallback
    assert files["CDM"] == "em/12345-cdm.png"
    assert files["store"] == "brain-store"
    [res] = doc["results"]
    tfiles = res["files"] if "files" in res else res["image"]["files"]
    # non-http path left alone without the change-non-http flag
    assert tfiles["CDM"] == "/nrs/some/local/path/lm1-cdm.png"
    assert tfiles["store"] == "lm-store"


def test_import_ppp_jacs_sample_enrichment(tmp_path):
    """--jacs-url resolves LM sample publishing names / slide codes
    (CachedDataHelper.retrieveLMSamplesByName + updateLMSampleInfo)."""
    reference_fixture(PPP_FIXTURES)
    dump = tmp_path / "dump"
    dump.mkdir()
    (dump / "data_samples_0.json").write_text(json.dumps([
        {"name": "BJD_115G11_AE_01-20190507_62_F1",
         "publishingName": "BJD_115G11", "slideCode": "20190507_62_F1"},
    ]))
    out = tmp_path / "ppp"
    run_cli("importPPPResults", "-rd", PPP_FIXTURES,
            "--em-library", "flyem_hemibrain_1_2_1",
            "--lm-library", "FlyLight Gen1 MCFO",
            "--jacs-url", f"file://{dump}",
            "-od", out)
    doc = json.loads((out / "1599747200.json").read_text())
    by_lm = {r["sourceLmName"]: r for r in doc["results"]}
    enriched = by_lm["BJD_115G11_AE_01-20190507_62_F1_REG_UNISEX_40x"]
    assert enriched["image"]["publishedName"] == "BJD_115G11"
    assert enriched["image"]["slideCode"] == "20190507_62_F1"


def test_export_score_filters(tmp_path):
    """getCDScoresFilter parity: by default only matches with
    gradientAreaGap >= 0 export; --pctPositivePixels floors the ratio."""
    from colormipsearch_tpu.model import CDMatch, EMNeuron, LMNeuron
    from colormipsearch_tpu.dataio.json_io import JSONMatchesWriter

    em = EMNeuron(mip_id="em1", published_name="777",
                  library_name="lib", alignment_space="AS")

    def lm(i):
        return LMNeuron(mip_id=f"lm{i}", published_name=f"L{i}",
                        library_name="lmlib", slide_code=f"s{i}")

    graded = CDMatch(mask_image=em, matched_image=lm(1),
                     matching_pixels=100, matching_pixels_ratio=0.05,
                     normalized_score=2000.0, gradient_area_gap=123)
    ungraded = CDMatch(mask_image=em, matched_image=lm(2),
                       matching_pixels=90, matching_pixels_ratio=0.04,
                       normalized_score=1500.0)
    low_ratio = CDMatch(mask_image=em, matched_image=lm(3),
                        matching_pixels=10, matching_pixels_ratio=0.001,
                        normalized_score=100.0, gradient_area_gap=5)
    matches_dir = tmp_path / "m"
    JSONMatchesWriter(per_masks_dir=matches_dir).write(
        [graded, ungraded, low_ratio])

    out = tmp_path / "pub"
    run_cli("exportData", "--exported-result-type", "EM_CD_MATCHES",
            "-md", matches_dir, "--pctPositivePixels", "1.0", "-od", out)
    doc = json.loads((out / "777.json").read_text())
    assert [r["image"]["id"] for r in doc["results"]] == ["lm1"]


def test_export_neuron_and_target_filters(tmp_path):
    """Neuron/target tag+term+library filters and match-tag exclusion
    (ExportData4NBCmd neuron selectors / excluded-matches-tags)."""
    from colormipsearch_tpu.model import CDMatch, EMNeuron, LMNeuron
    from colormipsearch_tpu.dataio.json_io import JSONMatchesWriter

    def em(i, **kw):
        return EMNeuron(mip_id=f"em{i}", published_name=f"N{i}",
                        library_name="emlib", alignment_space="AS", **kw)

    def lm(i, lib="lmlib", **kw):
        return LMNeuron(mip_id=f"lm{i}", published_name=f"L{i}",
                        library_name=lib, slide_code=f"s{i}", **kw)

    keep = CDMatch(mask_image=em(1, tags={"validated"}),
                   matched_image=lm(1, tags={"good"}),
                   matching_pixels=100, matching_pixels_ratio=0.05,
                   normalized_score=2000.0)
    wrong_mask_tag = CDMatch(mask_image=em(2),
                             matched_image=lm(2, tags={"good"}),
                             matching_pixels=90,
                             matching_pixels_ratio=0.04,
                             normalized_score=1500.0)
    wrong_target_lib = CDMatch(mask_image=em(3, tags={"validated"}),
                               matched_image=lm(3, lib="otherlib"),
                               matching_pixels=80,
                               matching_pixels_ratio=0.04,
                               normalized_score=1400.0)
    bad_match_tag = CDMatch(mask_image=em(4, tags={"validated"}),
                            matched_image=lm(4, tags={"good"}),
                            matching_pixels=70,
                            matching_pixels_ratio=0.04,
                            normalized_score=1300.0,
                            tags={"suspicious"})
    matches_dir = tmp_path / "m"
    JSONMatchesWriter(per_masks_dir=matches_dir).write(
        [keep, wrong_mask_tag, wrong_target_lib, bad_match_tag])

    out = tmp_path / "pub"
    run_cli("exportData", "--exported-result-type", "EM_CD_MATCHES",
            "--ignore-grad-scores", "-md", matches_dir, "-od", out,
            "--neuron-tags", "validated",
            "--target-library", "lmlib",
            "--excluded-matches-tags", "suspicious")
    assert sorted(p.name for p in out.glob("*.json")) == ["N1.json"]
    doc = json.loads((out / "N1.json").read_text())
    assert [r["image"]["id"] for r in doc["results"]] == ["lm1"]


def test_export_mips_offset_size(tmp_path):
    """--exported-mips narrows masks; --offset/--size page the exported
    published-name set in sorted order."""
    from colormipsearch_tpu.model import CDMatch, EMNeuron, LMNeuron
    from colormipsearch_tpu.dataio.json_io import JSONMatchesWriter

    matches = []
    for i in range(4):
        emn = EMNeuron(mip_id=f"em{i}", published_name=f"N{i}",
                       library_name="emlib", alignment_space="AS")
        lmn = LMNeuron(mip_id=f"lm{i}", published_name=f"L{i}",
                       library_name="lmlib", slide_code=f"s{i}")
        matches.append(CDMatch(mask_image=emn, matched_image=lmn,
                               matching_pixels=50,
                               matching_pixels_ratio=0.04,
                               normalized_score=1000.0))
    matches_dir = tmp_path / "m"
    JSONMatchesWriter(per_masks_dir=matches_dir).write(matches)

    out = tmp_path / "paged"
    run_cli("exportData", "--exported-result-type", "EM_CD_MATCHES",
            "--ignore-grad-scores", "-md", matches_dir, "-od", out,
            "--offset", "1", "--size", "2")
    assert sorted(p.name for p in out.glob("*.json")) == \
        ["N1.json", "N2.json"]

    out2 = tmp_path / "mips"
    run_cli("exportData", "--exported-result-type", "EM_CD_MATCHES",
            "--ignore-grad-scores", "-md", matches_dir, "-od", out2,
            "--exported-mips", "em3")
    assert sorted(p.name for p in out2.glob("*.json")) == ["N3.json"]


def test_ppp_lm_anatomical_area_suffix():
    """A REG_UNISEX suffix equal to the anatomical area is NOT an
    objective (ImportPPPResultsCmd.updateLMMetadata)."""
    from colormipsearch_tpu.io import ppp

    n = ppp.lm_neuron_from_ppp_name(
        "BJD_115G11_AE_01-20190507_62_F1_REG_UNISEX_VNC",
        anatomical_area="VNC")
    assert n.objective is None
    # without the area hint the suffix is kept VERBATIM like the
    # reference import (the 40x default belongs to the publish dto)
    n2 = ppp.lm_neuron_from_ppp_name(
        "BJD_115G11_AE_01-20190507_62_F1_REG_UNISEX_VNC")
    assert n2.objective == "VNC"
    n3 = ppp.lm_neuron_from_ppp_name(
        "BJD_115G11_AE_01-20190507_62_F1_REG_UNISEX_40x",
        anatomical_area="Brain")
    assert n3.objective == "40x"


def test_create_data_input_neuron_filters(tmp_path):
    """--tag / --excluded-neurons / --included-neurons on
    createColorDepthSearchDataInput."""
    reference_fixture()
    import shutil

    fix = ("/root/reference/colormipsearch-api/src/test/resources/"
           "colormipsearch/api/cdsearch")
    lib = tmp_path / "lib"
    lib.mkdir()
    for f in Path(fix).glob("*.tif"):
        shutil.copy(f, lib / f.name)

    out = tmp_path / "inputs"
    run_cli("createColorDepthSearchDataInput", "-i", lib,
            "-l", "testlib", "--alignment-space", "AS",
            "--tag", "roundA",
            "--excluded-neurons", "1752016801-LPLC2-RT_18U",
            "-od", out, "--output-filename", "filtered.json")
    docs = json.loads((out / "filtered.json").read_text())
    assert docs, "non-excluded neurons remain"
    assert all("LPLC2" not in d["mipId"] for d in docs)
    assert all("roundA" in (d.get("tags") or ()) for d in docs)

    run_cli("createColorDepthSearchDataInput", "-i", lib,
            "-l", "testlib", "--alignment-space", "AS",
            "--included-neurons", "1752016801-LPLC2-RT_18U",
            "-od", out, "--output-filename", "only.json")
    only = json.loads((out / "only.json").read_text())
    assert [d["mipId"] for d in only] == ["1752016801-LPLC2-RT_18U"]


def test_export_db_published_urls_collection(tmp_path):
    """DB export pulls uploaded URLs from the publishedURL collection by
    neuron internal id: neuron CDM/CDMThumbnail files, match
    CDMInput/CDMMatch from searchable_neurons, and drops matches where
    either side has no searchable URL (AbstractCDMatchesExporter)."""
    from colormipsearch_tpu.model import CDMatch, EMNeuron, LMNeuron
    from colormipsearch_tpu.persist import Config, DaosProvider

    db = tmp_path / "db.sqlite"
    cfg_file = tmp_path / "cfg.properties"
    cfg_file.write_text(f"Store.Path={db}\n")
    daos = DaosProvider(Config(str(cfg_file)))

    em = EMNeuron(mip_id="em1", published_name="12345",
                  library_name="emlib", alignment_space="AS")
    lm = LMNeuron(mip_id="lm1", published_name="R99X99",
                  library_name="lmlib", slide_code="sc1",
                  alignment_space="AS")
    lm2 = LMNeuron(mip_id="lm2", published_name="R11X11",
                   library_name="lmlib", slide_code="sc2",
                   alignment_space="AS")
    for n in (em, lm, lm2):
        daos.neuron_metadata_dao.create_or_update(n)
    ms = [CDMatch(mask_image=em, matched_image=t,
                  mask_image_ref_id=em.entity_id,
                  matched_image_ref_id=t.entity_id,
                  matching_pixels=87, matching_pixels_ratio=0.05,
                  normalized_score=2801.1, match_found=True)
          for t in (lm, lm2)]
    daos.cd_matches_dao.create_or_update_all(ms)
    pub = daos.store.collection("publishedURL")
    pub.insert_many([
        {"_id": em.entity_id, "uploaded": {
            "cdm": "https://s3/em1-cdm.png",
            "cdm_thumbnail": "https://s3/em1-thumb.jpg",
            "searchable_neurons": "https://s3/em1-searchable.png",
            "skeletonswc": "https://s3/em1.swc"}},
        {"_id": lm.entity_id, "uploaded": {
            "cdm": "https://s3/lm1-cdm.png",
            "searchable_neurons": "https://s3/lm1-searchable.png"}},
        # lm2 has no published URLs -> its match must be dropped
    ])

    out = tmp_path / "pub"
    run_cli("exportData", "--exported-result-type", "EM_CD_MATCHES",
            "--ignore-grad-scores",
            "--results-storage", "DB", "--config", cfg_file,
            "-l", "emlib", "-od", out)
    doc = json.loads((out / "12345.json").read_text())
    files = doc["inputImage"]["files"]
    assert files["CDM"] == "https://s3/em1-cdm.png"
    assert files["CDMThumbnail"] == "https://s3/em1-thumb.jpg"
    assert files["AlignedBodySWC"] == "https://s3/em1.swc"
    [res] = doc["results"]          # lm2 match dropped
    assert res["image"]["id"] == "lm1"
    assert res["files"]["CDMInput"] == "https://s3/em1-searchable.png"
    assert res["files"]["CDMMatch"] == "https://s3/lm1-searchable.png"


def test_export_library_name_mapping(tmp_path):
    """--config-url maps internal library ids to published display names
    (JacsDataGetter.retrieveLibraryNameMapping)."""
    from colormipsearch_tpu.model import CDMatch, EMNeuron, LMNeuron
    from colormipsearch_tpu.dataio.json_io import JSONMatchesWriter

    em = EMNeuron(mip_id="em1", published_name="777",
                  library_name="flyem_hemibrain_1_2_1",
                  alignment_space="AS")
    lm = LMNeuron(mip_id="lm1", published_name="L1",
                  library_name="internal_mcfo", slide_code="s1")
    m = CDMatch(mask_image=em, matched_image=lm, matching_pixels=50,
                matching_pixels_ratio=0.04, normalized_score=1000.0)
    matches_dir = tmp_path / "m"
    JSONMatchesWriter(per_masks_dir=matches_dir).write([m])

    cfg = tmp_path / "cdm_library.json"
    cfg.write_text(json.dumps({"config": {
        "flyem_hemibrain_1_2_1": {"name": "FlyEM_Hemibrain_v1.2.1"},
        "internal_mcfo": {"name": "FlyLight Gen1 MCFO"},
    }}))
    out = tmp_path / "pub"
    run_cli("exportData", "--exported-result-type", "EM_CD_MATCHES",
            "--ignore-grad-scores", "-md", matches_dir, "-od", out,
            "--config-url", f"file://{cfg}",
            "--image-stores-per-neuron-meta",
            # keyed on the INTERNAL name: mapping applied after store
            "AS,flyem_hemibrain_1_2_1:em-store")
    doc = json.loads((out / "777.json").read_text())
    assert doc["inputImage"]["libraryName"] == "FlyEM_Hemibrain_v1.2.1"
    assert doc["inputImage"]["files"]["store"] == "em-store"
    [res] = doc["results"]
    assert res["image"]["libraryName"] == "FlyLight Gen1 MCFO"


def test_ppp_results_scan_prefix_and_subdir(tmp_path):
    """--matches-prefix / --neuron-matches-sub-dir restrict the PPP
    results scan (ImportPPPResultsCmd)."""
    from colormipsearch_tpu.io import ppp

    base = tmp_path / "n1" / "lm_cable_agglo"
    base.mkdir(parents=True)
    good = base / "cov_scores_n1.json"
    good.write_text("{}")
    (tmp_path / "n1" / "cov_scores_stray.json").write_text("{}")
    (base / "other_scores_n1.json").write_text("{}")

    hits = ppp.find_ppp_result_files([tmp_path],
                                     sub_dir="lm_cable_agglo")
    assert hits == [good]
    hits = ppp.find_ppp_result_files([tmp_path], prefix="other_scores_")
    assert [h.name for h in hits] == ["other_scores_n1.json"]


def test_merge_results_semantics(tmp_path):
    """mergeResults parity: unconditional ratio gate (ratio 0 rows drop
    even at the 0.0 default), duplicate resolution by normalized score,
    -cleanup strips internal image paths but keeps sourceSampleRef, and
    -rf takes precedence over -rd (MergeResultsCmd.java:106-160)."""
    from colormipsearch_tpu.dataio import v2_io

    def mip(i, **kw):
        return v2_io.MIPMetadata(id=i, publishedName=f"P{i}",
                                 imageName=f"x/{i}.tif", **kw)

    src = mip("M", sampleRef="Sample#1")
    a = v2_io.CDSMatches(maskId="M", results=[
        # duplicate pair: lower pixels but higher gap score must win
        v2_io.V2Match(source=src, target=mip("T1", sampleRef="Sample#2"),
                      matchingPixels=100, matchingRatio=0.05,
                      gradientAreaGap=5, normalizedGapScore=500.0),
        v2_io.V2Match(source=src, target=mip("T2"),
                      matchingPixels=10, matchingRatio=0.0),  # ratio gate
    ])
    b = v2_io.CDSMatches(maskId="M", results=[
        v2_io.V2Match(source=src, target=mip("T1", sampleRef="Sample#2"),
                      matchingPixels=90, matchingRatio=0.04,
                      gradientAreaGap=3, normalizedGapScore=800.0),
    ])
    da, db = tmp_path / "a", tmp_path / "b"
    v2_io.write_cds_matches(a, da / "M.json")
    v2_io.write_cds_matches(b, db / "M.json")

    out = tmp_path / "merged"
    run_cli("mergeResults", "-rd", da, db, "-od", out, "-cleanup")
    doc = json.loads((out / "M.json").read_text())
    [r] = doc["results"]                     # ratio-0 row dropped
    assert r["normalizedGapScore"] == pytest.approx(800.0)  # score wins
    # cleanup: image paths gone on both sides, sourceSampleRef kept
    assert "imageName" not in r and "sourceImageName" not in r
    assert r.get("sourceSampleRef") == "Sample#1"
    assert "sampleRef" not in r

    # -rf precedence: only the explicit file is merged
    out2 = tmp_path / "merged2"
    run_cli("mergeResults", "-rd", da, "-rf", db / "M.json", "-od", out2)
    doc2 = json.loads((out2 / "M.json").read_text())
    assert [x["matchingPixels"] for x in doc2["results"]] == [90]


def test_reverse_transfer_top_flags_keep_all_rows(tmp_path):
    """The top* selection flags limit which rows get scores transferred
    but never drop rows from the output."""
    from colormipsearch_tpu.dataio import v2_io

    def mip(i, name, sc=None):
        return v2_io.MIPMetadata(id=i, publishedName=name, slideCode=sc,
                                 imageName=f"x/{i}.tif")

    src = mip("LM1", "lineA")
    fwd = v2_io.CDSMatches(maskId="LM1", results=[
        v2_io.V2Match(source=src, target=mip("EM1", "111"),
                      matchingPixels=100, matchingRatio=0.05),
        v2_io.V2Match(source=src, target=mip("EM2", "222"),
                      matchingPixels=50, matchingRatio=0.03),
    ])
    v2_io.write_cds_matches(fwd, tmp_path / "fwd" / "LM1.json")
    for em_id, em_name, gap, score in (("EM1", "111", 2438, 998.35),
                                       ("EM2", "222", 999, 500.0)):
        rev = v2_io.CDSMatches(maskId=em_id, results=[
            v2_io.V2Match(source=mip(em_id, em_name), target=src,
                          matchingPixels=100, matchingRatio=0.05,
                          gradientAreaGap=gap,
                          normalizedGapScore=score)])
        v2_io.write_cds_matches(rev, tmp_path / "rev" / f"{em_id}.json")

    out = tmp_path / "updated"
    run_cli("gradientScoresFromMatchedResults",
            "-rf", tmp_path / "fwd" / "LM1.json",
            "-revd", tmp_path / "rev", "-od", out,
            "--topPublishedNameMatches", "1")
    doc = json.loads((out / "LM1.json").read_text())
    assert len(doc["results"]) == 2          # nothing dropped
    by_id = {r["id"]: r for r in doc["results"]}
    assert by_id["EM1"]["gradientAreaGap"] == 2438   # top line updated
    assert "gradientAreaGap" not in by_id["EM2"] or \
        by_id["EM2"].get("gradientAreaGap") in (None, -1)


def test_export_lm_cd_matches(tmp_path):
    """LM_CD_MATCHES: LM masks export against EM targets (the reverse
    direction, LMCDMatchesExporter)."""
    from colormipsearch_tpu.model import CDMatch, EMNeuron, LMNeuron
    from colormipsearch_tpu.dataio.json_io import JSONMatchesWriter

    lm = LMNeuron(mip_id="lm1", published_name="R99X99",
                  library_name="MCFO", slide_code="sc1", gender="f",
                  alignment_space="AS")
    em = EMNeuron(mip_id="em1", published_name="12345",
                  library_name="FlyEM", alignment_space="AS")
    m = CDMatch(mask_image=lm, matched_image=em, matching_pixels=87,
                matching_pixels_ratio=0.05, normalized_score=2801.1)
    matches_dir = tmp_path / "m"
    JSONMatchesWriter(per_masks_dir=matches_dir).write([m])

    out = tmp_path / "pub"
    run_cli("exportData", "--exported-result-type", "LM_CD_MATCHES",
            "--ignore-grad-scores", "-md", matches_dir, "-od", out)
    doc = json.loads((out / "R99X99.json").read_text())
    assert doc["inputImage"]["type"] == "LMImage"
    assert doc["inputImage"]["slideCode"] == "sc1"
    [res] = doc["results"]
    assert res["image"]["type"] == "EMImage"
    assert res["image"]["publishedName"] == "12345"


def test_export_mips_fs_and_db(tmp_path):
    """EM_MIPS export groups per published name; the DB path reads the
    store and merges publishedURL uploads (MIPsExporter)."""
    from colormipsearch_tpu.dataio.json_io import write_neurons_json
    from colormipsearch_tpu.model import EMNeuron
    from colormipsearch_tpu.persist import Config, DaosProvider

    a = EMNeuron(mip_id="em1", published_name="777",
                 library_name="emlib", alignment_space="AS")
    b = EMNeuron(mip_id="em2", published_name="777",
                 library_name="emlib", alignment_space="AS")
    src = tmp_path / "mips.json"
    write_neurons_json([a, b], src)
    out = tmp_path / "mips_pub"
    run_cli("exportData", "--exported-result-type", "EM_MIPS",
            "--mips", src, "-od", out)
    doc = json.loads((out / "777.json").read_text())
    assert len(doc["results"]) == 2
    assert all(r["type"] == "EMImage" for r in doc["results"])

    cfg = tmp_path / "c.properties"
    cfg.write_text(f"Store.Path={tmp_path}/db.sqlite\n")
    daos = DaosProvider(Config(str(cfg)))
    daos.neuron_metadata_dao.create_or_update(a)
    daos.store.collection("publishedURL").insert_many([
        {"_id": a.entity_id,
         "uploaded": {"cdm": "https://s3/em1-cdm.png"}}])
    daos.store.close()
    out2 = tmp_path / "mips_db"
    run_cli("exportData", "--exported-result-type", "EM_MIPS",
            "--results-storage", "DB", "--config", cfg,
            "-l", "emlib", "-od", out2)
    doc = json.loads((out2 / "777.json").read_text())
    [r] = doc["results"]
    assert r["files"]["CDM"] == "https://s3/em1-cdm.png"


def test_export_ppp_matches_db(tmp_path):
    """EM_PPP_MATCHES --results-storage DB: rows come from the
    pppMatches store collection (EMPPPMatchesExporter DB path)."""
    reference_fixture(PPP_FIXTURES)
    cfg = tmp_path / "c.properties"
    cfg.write_text(f"Store.Path={tmp_path}/db.sqlite\n")
    run_cli("importPPPResults", "-rd", PPP_FIXTURES,
            "--em-library", "flyem_hemibrain_1_2_1",
            "--lm-library", "FlyLight Gen1 MCFO",
            "--alignment-space", "JRC2018_Unisex_20x_HR",
            "--mips-storage", "DB", "--results-storage", "DB",
            "--config", cfg)
    out = tmp_path / "pub"
    run_cli("exportData", "--exported-result-type", "EM_PPP_MATCHES",
            "--results-storage", "DB", "--config", cfg, "-od", out)
    files = sorted(out.glob("*.json"))
    assert files, "expected per-EM publish files from the store"
    doc = json.loads((out / "1599747200.json").read_text())
    assert doc["inputImage"]["publishedName"] == "1599747200"
    assert doc["results"]
    ranks = [r.get("pppmRank") for r in doc["results"]]
    assert ranks == sorted(ranks)


def test_export_ppp_screenshot_files(tmp_path):
    """PPP screenshot types map to publish FileTypes; uploaded URLs from
    the pppmURL collection take precedence over raw file names
    (PPPScreenshotType.java:5-10, EMPPPMatchesExporter:213-227)."""
    from colormipsearch_tpu.model import EMNeuron, PPPMatch
    from colormipsearch_tpu.persist import Config, DaosProvider

    cfg = tmp_path / "c.properties"
    cfg.write_text(f"Store.Path={tmp_path}/db.sqlite\n")
    daos = DaosProvider(Config(str(cfg)))
    em = EMNeuron(mip_id="em1", published_name="999",
                  library_name="emlib", alignment_space="AS")
    m = PPPMatch(mask_image=em, source_em_name="999-PFNp-RT",
                 source_lm_name="L1-sc_REG_UNISEX_40x", rank=1.0,
                 coverage_score=-50.0,
                 source_image_files={"CH": "999-L1_5_ch.png",
                                     "RAW": "999-L1_1_raw.png"})
    daos.ppp_matches_dao.save_all([m])
    daos.store.collection("pppmURL").insert_many([
        {"_id": m.entity_id,
         "uploadedFiles": {"CH": "https://s3/ch.png"},
         "uploadedThumbnails": {"CH": "https://s3/ch.jpg"}}])
    daos.store.close()

    out = tmp_path / "pub"
    run_cli("exportData", "--exported-result-type", "EM_PPP_MATCHES",
            "--results-storage", "DB", "--config", cfg, "-od", out)
    doc = json.loads((out / "999.json").read_text())
    [r] = doc["results"]
    assert r["files"]["CDMBest"] == "https://s3/ch.png"
    assert r["files"]["CDMBestThumbnail"] == "https://s3/ch.jpg"
    # no uploaded URL for RAW -> raw file name is used
    assert r["files"]["SignalMip"] == "999-L1_1_raw.png"


def test_v2_gradient_score_device_equals_oracle(tmp_path):
    """v2 gradientScore through the split device kernel == the float64
    oracle (and the --no-use-device oracle path), zgap fallback incl.
    (cmd_v2/CalculateNegativeScoresCmd.java:107-331)."""
    reference_fixture(MASK_TIF, TARGET_TIF)
    import shutil

    import numpy as np
    from PIL import Image


    lib = tmp_path / "lib"
    lib.mkdir()
    shutil.copy(MASK_TIF, lib / Path(MASK_TIF).name)
    shutil.copy(TARGET_TIF, lib / Path(TARGET_TIF).name)
    out = tmp_path / "v2res"
    run_cli("searchLocalFiles", "-m", f"{lib}:0:1", "-i", lib,
            "--maskThreshold", 20, "--dataThreshold", 20,
            "--pixColorFluctuation", 1.0, "--xyShift", 2, "--mirrorMask",
            "-od", out)
    [res_file] = [f for f in sorted(out.glob("*.json"))
                  if not f.name.endswith("cdsparams.json")]

    # synthesized 16-bit gradient variant; NO zgap -> dilation fallback
    from colormipsearch_tpu.io.image import read_image

    grad_dir = tmp_path / "grad"
    grad_dir.mkdir()
    rng = np.random.default_rng(1)
    t_rgb = read_image(TARGET_TIF).as_rgb()
    h, w = t_rgb.shape[:2]
    grad = rng.integers(0, 500, (h, w)).astype(np.uint16)
    for stem in (Path(TARGET_TIF).stem, Path(MASK_TIF).stem):
        Image.fromarray(grad).save(grad_dir / f"{stem}_gradient.png")

    gs_dev = tmp_path / "gs_dev"
    gs_orc = tmp_path / "gs_orc"
    common = ("-rf", res_file, "--gradientPath", grad_dir,
              "--maskThreshold", 20, "--mirrorMask")
    run_cli("gradientScore", *common, "-od", gs_dev)
    run_cli("gradientScore", *common, "--no-use-device", "-od", gs_orc)

    dev = json.loads((gs_dev / res_file.name).read_text())["results"]
    orc = json.loads((gs_orc / res_file.name).read_text())["results"]
    assert len(dev) == len(orc) == 2
    key = lambda r: r["id"]
    for d, o in zip(sorted(dev, key=key), sorted(orc, key=key)):
        assert d["gradientAreaGap"] == o["gradientAreaGap"]
        assert d["highExpressionArea"] == o["highExpressionArea"]
        assert d["gradientAreaGap"] >= 0

    # spot-check one pair against the oracle directly
    from colormipsearch_tpu.oracle.pixel import label_regions_mask
    from colormipsearch_tpu.oracle.shape import ShapeMatchOracle

    mask_rgb = read_image(MASK_TIF).as_rgb()
    region = label_regions_mask(w, h)
    oracle = ShapeMatchOracle(mask_rgb, 20, mirror=True,
                              excluded_region=region)
    ref = oracle.score(t_rgb, grad, None)
    by_target = {r["imageName"]: r for r in dev}
    row = by_target[str(lib / Path(TARGET_TIF).name)]
    assert row["gradientAreaGap"] == ref.gradient_area_gap
    assert row["highExpressionArea"] == ref.high_expression_area


def test_ppp_dto_sample_name_and_objective():
    """PPPMatchEntityTest.extractSampleNameAndObjective: the publish DTO
    strips _REG_UNISEX_ from sourceLmName, derives sourceObjective (the
    suffix when it contains NNx, else the default 40x), and the score is
    the truncated absolute coverage score (PPPMatchEntity.java:190-219)."""
    from colormipsearch_tpu.model import EMNeuron, PPPMatch
    from colormipsearch_tpu.model import dto

    em = EMNeuron(mip_id="e", published_name="577720000")
    for lm_name, want_name, want_obj in [
            ("BJD_128D10_AE_01-20171208_61_E3_REG_UNISEX_40x",
             "BJD_128D10_AE_01-20171208_61_E3", "40x"),
            ("GMR_80D06_AE_01-20190426_64_C1_REG_UNISEX_VNC",
             "GMR_80D06_AE_01-20190426_64_C1", "40x"),
            ("no_reg_marker_name", "no_reg_marker_name", "40x")]:
        m = PPPMatch(mask_image=em, source_em_name="577720000--RT_18U",
                     source_lm_name=lm_name, rank=19.5,
                     coverage_score=-83.89210580042597)
        row = dto.ppp_match_to_dto(m)
        assert row.source_lm_name == want_name, lm_name
        assert row.source_objective == want_obj, lm_name
        assert row.score == 83  # (int) Math.abs(-83.892...)


def test_raw_ppp_reader_both_fixtures_both_modes():
    """RawPPPMatchesReaderTest: both cov_scores fixtures parse in best-
    and all-skeleton modes; every row carries the file's EM neuron name
    and a non-null LM name (RawPPPMatchesReader.java:36-79)."""
    reference_fixture(PPP_FIXTURES)
    from colormipsearch_tpu.io.ppp import read_raw_ppp_matches

    for fname in ("cov_scores_1599747200-PFNp_c-RT_18U.json",
                  "cov_scores_484130600-SMP145-RT_18U.json"):
        neuron = fname.replace("cov_scores_", "").replace(".json", "")
        path = Path(PPP_FIXTURES) / fname
        for only_best in (True, False):
            rows = read_raw_ppp_matches(path, only_best_matches=only_best,
                                        include_skeletons=True)
            assert rows, (fname, only_best)
            for m in rows:
                assert m.source_em_name == neuron
                assert m.source_lm_name
            # skeleton arrays parse: at least one row has skeleton ids
            # with aligned nblast scores
            with_skels = [m for m in rows if m.skeleton_matches]
            assert with_skels, (fname, only_best)
            for m in with_skels:
                assert all(s.id for s in m.skeleton_matches)


def test_export_published_lm_images_enrichment(tmp_path):
    """LM neurons in DB exports gain VisuallyLosslessStack (sample's
    published image, alignment-space alias aware) and Gal4Expression
    (joined Gen1 rows for the area) from the publishedLMImage
    collection (PublishedLMImageMongoDao pipeline,
    ColorDepthMIP.updateLMNeuron:212-213)."""
    from colormipsearch_tpu.model import (
        CDMatch,
        EMNeuron,
        LMNeuron,
        PublishedLMImage,
    )
    from colormipsearch_tpu.persist import Config, DaosProvider

    cfg = tmp_path / "c.properties"
    cfg.write_text(f"Store.Path={tmp_path}/db.sqlite\n")
    daos = DaosProvider(Config(str(cfg)))
    em = EMNeuron(mip_id="em1", published_name="123", library_name="emlib",
                  alignment_space="AS_A")
    lm = LMNeuron(mip_id="lm1", published_name="lineZ", library_name="mcfo",
                  alignment_space="AS_A", slide_code="sc-1",
                  anatomical_area="Brain", sample_ref="Sample#42")
    daos.neuron_metadata_dao.save(em)
    daos.neuron_metadata_dao.save(lm)
    m = CDMatch(mask_image=em, matched_image=lm, matching_pixels=50,
                matching_pixels_ratio=0.05, normalized_score=9.0,
                gradient_area_gap=100, high_expression_area=5)
    m.mask_image_ref_id = em.entity_id
    m.matched_image_ref_id = lm.entity_id
    daos.cd_matches_dao.create_or_update_all([m])
    daos.published_lm_images_dao.save_all([
        # the sample's published image lives in an ALIASED space
        PublishedLMImage(sample_ref="Sample#42", original_line="lineZ",
                         area="Brain", alignment_space="AS_A_ALIAS",
                         objective="40x",
                         files={"VisuallyLosslessStack": "https://s3/z.h5j"}),
        # Gen1 GAL4 row for the same line+area (the $lookup join)
        PublishedLMImage(sample_ref="Sample#OTHER", original_line="lineZ",
                         area="Brain", alignment_space="AS_A_ALIAS",
                         release_name="Gen1 GAL4",
                         files={"ColorDepthMip1": "https://s3/gal4.png"}),
    ])
    daos.store.close()

    out = tmp_path / "pub"
    run_cli("exportData", "--exported-result-type", "EM_CD_MATCHES",
            "--results-storage", "DB", "--config", cfg,
            "--published-alignment-space-alias", "AS_A=AS_A_ALIAS",
            "-od", out)
    doc = json.loads((out / "123.json").read_text())
    [r] = doc["results"]
    assert r["image"]["files"]["VisuallyLosslessStack"] == "https://s3/z.h5j"
    assert r["image"]["files"]["Gal4Expression"] == "https://s3/gal4.png"

    # without the alias the published image is in a different space
    out2 = tmp_path / "pub2"
    run_cli("exportData", "--exported-result-type", "EM_CD_MATCHES",
            "--results-storage", "DB", "--config", cfg, "-od", out2)
    doc2 = json.loads((out2 / "123.json").read_text())
    files2 = doc2["results"][0]["image"].get("files") or {}
    assert "VisuallyLosslessStack" not in files2


def test_export_ppp_lm_3d_stack(tmp_path):
    """PPP export attaches the LM sample's VisuallyLosslessStack
    (EMPPPMatchesExporter:210, findPublishedLM3DStack)."""
    from colormipsearch_tpu.model import (
        EMNeuron,
        LMNeuron,
        PPPMatch,
        PublishedLMImage,
    )
    from colormipsearch_tpu.persist import Config, DaosProvider

    cfg = tmp_path / "c.properties"
    cfg.write_text(f"Store.Path={tmp_path}/db.sqlite\n")
    daos = DaosProvider(Config(str(cfg)))
    em = EMNeuron(mip_id="em1", published_name="888",
                  library_name="emlib", alignment_space="AS")
    lm = LMNeuron(mip_id="lm1", published_name="lineY",
                  alignment_space="AS", sample_ref="Sample#7")
    m = PPPMatch(mask_image=em, matched_image=lm,
                 source_em_name="888-X-RT",
                 source_lm_name="lineY-sc_REG_UNISEX_40x", rank=0.5,
                 coverage_score=-42.0)
    daos.ppp_matches_dao.save_all([m])
    daos.published_lm_images_dao.save_all([
        PublishedLMImage(sample_ref="Sample#7", original_line="lineY",
                         area="Brain", alignment_space="AS",
                         files={"VisuallyLosslessStack": "https://s3/y.h5j"}),
    ])
    daos.store.close()

    out = tmp_path / "pub"
    run_cli("exportData", "--exported-result-type", "EM_PPP_MATCHES",
            "--results-storage", "DB", "--config", cfg, "-od", out)
    doc = json.loads((out / "888.json").read_text())
    [r] = doc["results"]
    assert r["image"]["files"]["VisuallyLosslessStack"] == "https://s3/y.h5j"


def test_v2_mips_with_variants_fixture():
    """MIPsUtilsTest.loadMIPsWithVariants on the reference fixture: every
    MIP carries variants and a sampleRef; the variants dict resolves to
    loadable (zip-entry aware) FileData via variantAsMIP semantics."""
    reference_fixture()
    from colormipsearch_tpu.dataio.v2_io import read_mips_json

    path = ("/root/reference/colormipsearch-api/src/test/resources/"
            "colormipsearch/api/cdmips/mipsWithVariants.json")
    mips = read_mips_json(path)
    assert len(mips) > 0
    for m in mips:
        assert m.variants, m.id
        assert m.sampleRef, m.id
    m = mips[0]
    g = m.variant_file_data("gradient")
    assert g is not None
    # fixture gradients are zip entries
    assert g.file_name.endswith(".zip") and g.entry_name
    assert m.variant_file_data("nope") is None
    # offset/length paging (readMIPsFromJSON 0/-1 semantics)
    assert len(read_mips_json(path, 2, 3)) == 3


def test_v2_gradient_score_variants_dict(tmp_path):
    """v2 gradientScore resolves gradient images from the target MIP's
    own variants dictionary — no --gradientPath needed
    (MIPsUtils.getMIPVariantInfo:223-228 variantAsMIP preference)."""
    reference_fixture(MASK_TIF, TARGET_TIF)
    import shutil

    import numpy as np
    from PIL import Image

    from colormipsearch_tpu.io.image import read_image

    lib = tmp_path / "lib"
    lib.mkdir()
    shutil.copy(MASK_TIF, lib / Path(MASK_TIF).name)
    shutil.copy(TARGET_TIF, lib / Path(TARGET_TIF).name)
    out = tmp_path / "v2res"
    run_cli("searchLocalFiles", "-m", f"{lib}:0:1", "-i", lib,
            "--maskThreshold", 20, "--dataThreshold", 20,
            "--pixColorFluctuation", 1.0, "--xyShift", 2, "--mirrorMask",
            "-od", out)
    [res_file] = [f for f in sorted(out.glob("*.json"))
                  if not f.name.endswith("cdsparams.json")]

    rng = np.random.default_rng(1)
    t_rgb = read_image(TARGET_TIF).as_rgb()
    h, w = t_rgb.shape[:2]
    grad = rng.integers(0, 500, (h, w)).astype(np.uint16)
    gdir = tmp_path / "elsewhere"  # NOT passed via --gradientPath
    gdir.mkdir()
    gfile = gdir / "some_gradient_name.png"
    Image.fromarray(grad).save(gfile)

    # stamp the variants dict into the result rows' targets
    doc = json.loads(res_file.read_text())
    for r in doc["results"]:
        r["variants"] = {"gradient": str(gfile)}
    res_file.write_text(json.dumps(doc))

    gs = tmp_path / "gs"
    run_cli("gradientScore", "-rf", res_file,
            "--maskThreshold", 20, "--mirrorMask", "-od", gs)
    rows = json.loads((gs / res_file.name).read_text())["results"]
    assert rows and all(r["gradientAreaGap"] >= 0 for r in rows)


def test_v2_gradient_score_packed_store_reuse(tmp_path, monkeypatch):
    """v2 gradientScore with --packed-variants-store: the second run
    serves every target from the store (no image decode) and produces
    identical scores — same decode-once semantics as the v3 command."""
    reference_fixture(MASK_TIF, TARGET_TIF)
    import shutil

    import numpy as np
    from PIL import Image


    lib = tmp_path / "lib"
    lib.mkdir()
    shutil.copy(MASK_TIF, lib / Path(MASK_TIF).name)
    shutil.copy(TARGET_TIF, lib / Path(TARGET_TIF).name)
    out = tmp_path / "v2res"
    run_cli("searchLocalFiles", "-m", f"{lib}:0:1", "-i", lib,
            "--maskThreshold", 20, "--dataThreshold", 20,
            "--pixColorFluctuation", 1.0, "--xyShift", 2, "--mirrorMask",
            "-od", out)
    [res_file] = [f for f in sorted(out.glob("*.json"))
                  if not f.name.endswith("cdsparams.json")]

    from colormipsearch_tpu.io.image import read_image

    grad_dir = tmp_path / "grad"
    grad_dir.mkdir()
    rng = np.random.default_rng(1)
    t_rgb = read_image(TARGET_TIF).as_rgb()
    grad = rng.integers(0, 500, t_rgb.shape[:2]).astype(np.uint16)
    for stem in (Path(TARGET_TIF).stem, Path(MASK_TIF).stem):
        Image.fromarray(grad).save(grad_dir / f"{stem}_gradient.png")

    store = tmp_path / "pack"
    common = ("-rf", res_file, "--gradientPath", grad_dir,
              "--maskThreshold", 20, "--mirrorMask",
              "--packed-variants-store", store)
    first = tmp_path / "gs1"
    run_cli("gradientScore", *common, "-od", first)

    # second run: poison TARGET image decode — only the mask (the
    # grouped file's source MIP) may load
    from colormipsearch_tpu.io import mips as mips_io

    real_load = mips_io.load_image
    mask_name = Path(MASK_TIF).name

    def guarded(fd):
        if fd.name.endswith(mask_name):
            return real_load(fd)
        raise AssertionError(f"decode of {fd} despite packed store")

    monkeypatch.setattr(mips_io, "load_image", guarded)
    second = tmp_path / "gs2"
    run_cli("gradientScore", *common, "-od", second)

    a = json.loads((first / res_file.name).read_text())["results"]
    b = json.loads((second / res_file.name).read_text())["results"]
    key = lambda r: r["id"]  # noqa: E731
    for ra, rb in zip(sorted(a, key=key), sorted(b, key=key)):
        assert rb["gradientAreaGap"] == ra["gradientAreaGap"]
        assert rb["highExpressionArea"] == ra["highExpressionArea"]
        assert rb["normalizedGapScore"] == ra["normalizedGapScore"]

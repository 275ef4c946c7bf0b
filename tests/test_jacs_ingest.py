"""JACS ingest client tests (offline file:// transport)."""

import json

import pytest

from tests.conftest import reference_fixture


def run_cli(*argv):
    from colormipsearch_tpu.cli.main import main
    assert main([str(a) for a in argv]) == 0


@pytest.fixture()
def jacs_dump(tmp_path):
    """Two pages of /data/colorDepthMIPsWithSamples dumps."""
    page0 = [
        {"id": f"mip{i}", "alignmentSpace": "JRC2018_Unisex_20x_HR",
         "filepath": f"/store/cdm/img{i}.png",
         "sampleRef": f"Sample#{i}",
         "objective": "40x", "anatomicalArea": "Brain",
         "channelNumber": "2",
         "sample": {"publishingName": f"R{i:02d}A01",
                    "slideCode": f"2020_{i}", "gender": "f",
                    "line": f"line{i}"}}
        for i in range(3)
    ]
    d = tmp_path / "dump"
    d.mkdir()
    (d / "data_colorDepthMIPsWithSamples_0.json").write_text(
        json.dumps(page0))
    return d


def test_jacs_client_paging(jacs_dump):
    from colormipsearch_tpu.io.jacs import JacsClient

    client = JacsClient(f"file://{jacs_dump}")
    recs = list(client.color_depth_mips_with_samples(
        library="FlyLight Gen1 MCFO"))
    assert len(recs) == 3


def test_jacs_em_vs_lm_mapping():
    from colormipsearch_tpu.io.jacs import mip_record_to_neuron
    from colormipsearch_tpu.model import EMNeuron, LMNeuron

    em = mip_record_to_neuron(
        {"id": "x", "filepath": "/f.png", "bodyId": 12345,
         "alignmentSpace": "AS",
         "emBody": {"neuronType": "PFL1",
                    "files": {"SkeletonSWC": "/swc/107.swc",
                              "SkeletonOBJ": "/obj/107.obj"}}},
        "flyem_hemibrain_1_2_1")
    assert isinstance(em, EMNeuron)
    assert em.published_name == "12345"
    assert em.neuron_type == "PFL1"
    # skeleton compute files ride the emBody record
    # (CreateCDSDataInputCmd.java:485-491)
    from colormipsearch_tpu.model import ComputeFileType
    assert em.compute_file(ComputeFileType.SkeletonSWC).name == \
        "/swc/107.swc"
    assert em.compute_file(ComputeFileType.SkeletonOBJ).name == \
        "/obj/107.obj"

    lm = mip_record_to_neuron(
        {"id": "y", "filepath": "/g.png",
         "sample": {"publishingName": "R10A07", "slideCode": "sc",
                    "gender": "m"}},
        "FlyLight Gen1 MCFO")
    assert isinstance(lm, LMNeuron)
    assert lm.published_name == "R10A07"
    assert lm.gender == "m"


def test_create_data_input_from_jacs_cli(tmp_path, jacs_dump):
    run_cli("createColorDepthSearchDataInput",
            "--jacs-url", f"file://{jacs_dump}",
            "-l", "FlyLight Gen1 MCFO",
            "--alignment-space", "JRC2018_Unisex_20x_HR",
            "-od", tmp_path, "--output-filename", "jacs.json")
    data = json.loads((tmp_path / "jacs.json").read_text())
    assert len(data) == 3
    assert data[0]["class"].endswith("LMNeuronEntity")
    assert data[0]["slideCode"] == "2020_0"
    assert data[0]["channel"] == 2
    assert "SourceColorDepthImage" in data[0]["computeFiles"]


def test_v2_create_json_input_from_jacs(tmp_path, jacs_dump):
    """v2 createColorDepthSearchJSONInput online mode: JACS paging ->
    MIPMetadata with filters, URL relativization, and segmented-image
    substitution (CreateColorDepthSearchJSONInputCmd.java)."""
    from colormipsearch_tpu.dataio import v2_io

    # segmented-image store: LM entries key on the slide code and must
    # match the source channel (ch2 -> channel index 1) and objective
    seg = tmp_path / "seg"
    seg.mkdir()
    (seg / "2020_0-stuff-40x_ch2_CDM.png").write_bytes(b"png")
    (seg / "2020_1-stuff-40x_ch2_CDM.png").write_bytes(b"png")

    out = tmp_path / "v2out"
    run_cli("createColorDepthSearchJSONInput",
            "--jacs-url", f"file://{jacs_dump}",
            "-l", "FlyLight Gen1 MCFO",
            "--alignment-space", "JRC2018_Unisex_20x_HR",
            "--urls-relative-to", "1",
            "--excluded-names", "R02A01",
            "--output-filename", "lib.json", "-od", out)
    mips = v2_io.read_mips_json(out / "lib.json")
    names = {m.publishedName for m in mips}
    assert names == {"R00A01", "R01A01"}  # R02A01 excluded
    m0 = next(m for m in mips if m.publishedName == "R00A01")
    assert m0.slideCode == "2020_0" and m0.gender == "f"
    # /store/cdm/img0.png relativized from component 1
    assert m0.imageURL == "cdm/img0.png"

    # handling 0x2: segmented-only — unmatched MIPs are dropped
    out2 = tmp_path / "v2seg"
    run_cli("createColorDepthSearchJSONInput",
            "--jacs-url", f"file://{jacs_dump}",
            "-l", "FlyLight Gen1 MCFO",
            "--segmented-mips-variant", seg,
            "--segmented-image-handling", "0x2",
            "--output-filename", "seg.json", "-od", out2)
    seg_mips = v2_io.read_mips_json(out2 / "seg.json")
    assert {m.publishedName for m in seg_mips} == {"R00A01", "R01A01"}
    assert all(m.imageName and "_CDM.png" in m.imageName for m in seg_mips)

    # default handling 0: segmented if found, else the original MIP
    out3 = tmp_path / "v2seg0"
    run_cli("createColorDepthSearchJSONInput",
            "--jacs-url", f"file://{jacs_dump}",
            "-l", "FlyLight Gen1 MCFO",
            "--segmented-mips-variant", seg,
            "--output-filename", "seg.json", "-od", out3)
    seg0 = v2_io.read_mips_json(out3 / "seg.json")
    assert {m.publishedName for m in seg0} == \
        {"R00A01", "R01A01", "R02A01"}
    orig = next(m for m in seg0 if m.publishedName == "R02A01")
    assert "_CDM.png" not in (orig.imageName or "")

    # append mode merges without duplicating ids
    run_cli("createColorDepthSearchJSONInput",
            "--jacs-url", f"file://{jacs_dump}",
            "-l", "FlyLight Gen1 MCFO",
            "--append-output",
            "--output-filename", "lib.json", "-od", out)
    merged = v2_io.read_mips_json(out / "lib.json")
    ids = [m.id for m in merged]
    assert len(ids) == len(set(ids)) == 3  # R02A01 included this time


def test_v2_group_mips_from_jacs(tmp_path, jacs_dump):
    from colormipsearch_tpu.dataio import v2_io

    out = tmp_path / "grouped"
    run_cli("groupMIPsByPublishedName",
            "--jacs-url", f"file://{jacs_dump}",
            "-l", "FlyLight Gen1 MCFO", "-od", out)
    files = sorted((out / "by_line").glob("*.json"))
    assert [f.stem for f in files] == ["R00A01", "R01A01", "R02A01"]
    mips = v2_io.read_mips_json(files[0])
    assert mips[0].publishedName == "R00A01"


def test_jacs_library_and_mip_filters(tmp_path):
    """--included-libraries / --excluded-libraries / --mips filtering
    (CreateCDSDataInputCmd.checkLibraries:459-468)."""
    from colormipsearch_tpu.io.jacs import JacsClient, load_library_neurons

    page0 = [
        {"id": "mipA", "filepath": "/cdm/a.png", "alignmentSpace": "AS",
         "libraries": ["libX", "libY"],
         "sample": {"publishingName": "R01", "slideCode": "s1"}},
        {"id": "mipB", "filepath": "/cdm/b.png", "alignmentSpace": "AS",
         "libraries": ["libX"],
         "sample": {"publishingName": "R02", "slideCode": "s2"}},
        {"id": "mipC", "filepath": "/cdm/c.png", "alignmentSpace": "AS",
         "libraries": ["libX", "libZ"],
         "sample": {"publishingName": "R03", "slideCode": "s3"}},
    ]
    d = tmp_path / "dump"
    d.mkdir()
    (d / "data_colorDepthMIPsWithSamples_0.json").write_text(
        json.dumps(page0))
    client = JacsClient(f"file://{d}")

    both = load_library_neurons(client, library="FlyLight Gen1 MCFO",
                                included_libraries=["libX", "libY"])
    assert [n.mip_id for n in both] == ["mipA"]
    no_z = load_library_neurons(client, library="FlyLight Gen1 MCFO",
                                excluded_libraries=["libZ"])
    assert [n.mip_id for n in no_z] == ["mipA", "mipB"]
    only = load_library_neurons(client, library="FlyLight Gen1 MCFO",
                                mips=["mipB"])
    assert [n.mip_id for n in only] == ["mipB"]


def test_create_data_input_for_update(tmp_path):
    """--for-update merges into an existing output file by mipId."""
    reference_fixture()
    import shutil
    from pathlib import Path

    fix = ("/root/reference/colormipsearch-api/src/test/resources/"
           "colormipsearch/api/cdsearch")
    lib = tmp_path / "lib"
    lib.mkdir()
    for f in Path(fix).glob("*.tif"):
        shutil.copy(f, lib / f.name)

    out = tmp_path / "inputs"
    run_cli("createColorDepthSearchDataInput", "-i", lib, "-l", "tl",
            "--alignment-space", "AS",
            "--included-neurons", "1752016801-LPLC2-RT_18U",
            "-od", out, "--output-filename", "lib.json")
    assert len(json.loads((out / "lib.json").read_text())) == 1
    # second run adds the remaining neurons without dropping the first
    run_cli("createColorDepthSearchDataInput", "-i", lib, "-l", "tl",
            "--alignment-space", "AS", "--for-update",
            "--tag", "batch2",
            "-od", out, "--output-filename", "lib.json")
    docs = json.loads((out / "lib.json").read_text())
    ids = sorted(d["mipId"] for d in docs)
    assert len(ids) == len(set(ids)) and len(ids) >= 2
    assert any("LPLC2" in i for i in ids)


def test_v2_group_mips_custom_dirs_and_library_map(tmp_path, jacs_dump):
    """--lines-directory renames the LM grouping subdir; --config-url
    maps the library display name on the grouped MIPs."""
    from colormipsearch_tpu.dataio import v2_io

    cfg = tmp_path / "cdm_library.json"
    cfg.write_text(json.dumps({"config": {
        "FlyLight Gen1 MCFO": {"name": "FlyLight Gen1 MCFO Published"},
    }}))
    out = tmp_path / "grouped"
    run_cli("groupMIPsByPublishedName",
            "--jacs-url", f"file://{jacs_dump}",
            "--config-url", f"file://{cfg}",
            "-l", "FlyLight Gen1 MCFO",
            "--lines-directory", "lines", "-od", out)
    files = sorted((out / "lines").glob("*.json"))
    assert [f.stem for f in files] == ["R00A01", "R01A01", "R02A01"]
    mips = v2_io.read_mips_json(files[0])
    assert mips[0].libraryName == "FlyLight Gen1 MCFO Published"

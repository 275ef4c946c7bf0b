"""Round-trip the reference's own persisted-match fixture through our
grouping + writers (mirrors persist dataio/fs/JSONReadWriteTest)."""

import json
from pathlib import Path

from tests.conftest import reference_fixture

FIXTURE = ("/root/reference/colormipsearch-persist/src/test/resources/"
           "cdsmatches/testcdsmatches.json")


def test_reference_matches_roundtrip(tmp_path):
    reference_fixture(FIXTURE)
    from colormipsearch_tpu.dataio.json_io import (
        JSONMatchesReader,
        JSONMatchesWriter,
    )
    from colormipsearch_tpu.model import EMNeuron, LMNeuron

    matches = JSONMatchesReader.read_matches(FIXTURE)
    assert len(matches) >= 2
    for m in matches:
        assert isinstance(m.mask_image, EMNeuron)
        assert isinstance(m.matched_image, LMNeuron)
        assert m.matching_pixels > 0
        assert m.mask_image.compute_files, "computeFiles must survive"

    # group per mask + per target, write, read back, expand
    out = tmp_path / "rt"
    writer = JSONMatchesWriter(per_masks_dir=out / "masks",
                               per_targets_dir=out / "targets")
    writer.write(matches)
    mask_files = sorted((out / "masks").glob("*.json"))
    assert {f.stem for f in mask_files} == \
        {m.mask_image.mip_id for m in matches}

    back = []
    for f in mask_files:
        back.append(JSONMatchesReader.read_matches(f))
    flat = [m for grp in back for m in grp]
    assert len(flat) == len(matches)
    # pairs may repeat (different compute-file variants of the same MIPs)
    # so compare as multisets
    def multiset(ms):
        return sorted((m.mask_image.mip_id, m.matched_image.mip_id,
                       m.matching_pixels) for m in ms)
    assert multiset(flat) == multiset(matches)

    # per-target files invert mask/image
    tgt_files = sorted((out / "targets").glob("*.json"))
    assert {f.stem for f in tgt_files} == \
        {m.matched_image.mip_id for m in matches}
    tdoc = json.loads(tgt_files[0].read_text())
    assert tdoc["inputImage"]["class"].endswith("LMNeuronEntity")
    assert tdoc["results"][0]["image"]["class"].endswith("EMNeuronEntity")

    # field preservation spot checks against the raw fixture
    raw = json.loads(Path(FIXTURE).read_text())
    raw0 = raw[0]
    m0 = matches[0]
    assert m0.mask_image.mip_id == raw0["maskImage"]["mipId"]
    assert m0.matching_pixels == raw0["matchingPixels"]
    assert m0.matched_image.extra.get("sampleRef") == \
        raw0["image"].get("sampleRef") or \
        m0.matched_image.sample_ref == raw0["image"].get("sampleRef")


def test_v2_zero_scores_roundtrip():
    """gradientAreaGap 0 / normalizedGapScore 0.0 are legitimate values
    (a perfect shape match) and must survive from_json — a falsy
    fallback would rank a worst match as matchingPixels-scored."""
    from colormipsearch_tpu.dataio.v2_io import V2Match

    row = {"id": "t1", "publishedName": "x", "sourceId": "s1",
           "matchingPixels": 55, "matchingRatio": 0.01,
           "gradientAreaGap": 0, "highExpressionArea": 0,
           "normalizedGapScore": 0.0}
    m = V2Match.from_json(row)
    assert m.gradientAreaGap == 0
    assert m.highExpressionArea == 0
    assert m.normalizedGapScore == 0.0
    assert m.normalized_score == 0.0  # NOT the matchingPixels fallback


def test_neuron_json_robustness_and_heuristics():
    """Round-trip/fallback semantics from the round-2 review pass:
    unknown processedTags keys are skipped (like unknown computeFiles),
    createdDate rides `extra` and survives the round trip, and the
    class-less EM fallback uses the shared is_em_library classifier
    (MIPsHandlingUtils.isEmLibrary:116)."""
    from colormipsearch_tpu.model import EMNeuron
    from colormipsearch_tpu.model.entities import neuron_from_json

    data = {
        "class": "org.janelia.colormipsearch.model.EMNeuronEntity",
        "mipId": "123", "libraryName": "flyem_hemibrain_1_2_1",
        "processedTags": {"ColorDepthSearch": ["r1"],
                          "SomeFutureType": ["x"]},
        "createdDate": "2024-01-02T03:04:05Z",
    }
    n = neuron_from_json(data)
    assert [t.value for t in n.processed_tags] == ["ColorDepthSearch"]
    assert n.to_json()["createdDate"] == "2024-01-02T03:04:05Z"

    for lib, want_em in [("flywire_fafb_783", True),
                         ("hemibrain_1.2.1", True),
                         ("flylight_split_gal4_published", False)]:
        got = neuron_from_json({"mipId": "1", "libraryName": lib})
        assert isinstance(got, EMNeuron) is want_em, lib


def test_pppmatch_zero_ids_roundtrip():
    from colormipsearch_tpu.model.entities import PPPMatch

    d = PPPMatch(entity_id=0, session_ref_id=0).to_json()
    assert d["entityId"] == "0" and d["sessionRefId"] == "0"

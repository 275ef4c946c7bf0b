"""High-level library API tests."""

import shutil
from pathlib import Path

from tests.conftest import MASK_TIF, TARGET_TIF, reference_fixture


def test_color_depth_search_api(tmp_path):
    reference_fixture(MASK_TIF, TARGET_TIF)
    import colormipsearch_tpu as cms

    lib = tmp_path / "lib"
    lib.mkdir()
    shutil.copy(MASK_TIF, lib / Path(MASK_TIF).name)
    tgt = tmp_path / "tgt"
    tgt.mkdir()
    shutil.copy(TARGET_TIF, tgt / Path(TARGET_TIF).name)

    params = cms.CDSParams(mask_threshold=20, data_threshold=20,
                           pix_color_fluctuation=1.0, xy_shift=2,
                           mirror_mask=True,
                           with_name_label_region=True,
                           with_color_scale_region=True)
    matches = cms.color_depth_search([lib], [tgt], params)
    assert len(matches) == 1
    assert matches[0].matching_pixels == 87
    assert not matches[0].mirrored


def test_version():
    import colormipsearch_tpu as cms
    assert cms.__version__

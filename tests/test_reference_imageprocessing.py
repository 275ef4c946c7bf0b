"""Reference ImageOperationsTest flows on the reference's own fixtures.

Drives the flows of
colormipsearch-api/src/test/java/.../imageprocessing/ImageOperationsTest.java
against the same test images (minmaxTest1/2.tif, 1281324958-DNp11), with
the ImageJ RankFilters comparison replaced by a direct brute-force
circular-footprint max (the footprint itself is separately pinned to the
documented ImageJ line radii in test_oracle_shape.py).
"""

import numpy as np
import pytest

from tests.conftest import reference_fixture

from colormipsearch_tpu.io.image import read_image
from colormipsearch_tpu.oracle.pixel import label_regions_mask
from colormipsearch_tpu.oracle.shape import (
    circular_footprint,
    clear_region,
    dilate_rgb,
    gray16_no_gamma,
    rgb_signal,
)

FIXDIR = ("/root/reference/colormipsearch-api/src/test/resources/"
          "colormipsearch/api/imageprocessing")


@pytest.fixture(autouse=True)
def _fixture_dir():
    reference_fixture(FIXDIR)


def _bruteforce_dilate(img: np.ndarray, radius: float) -> np.ndarray:
    """Shifted-max dilation over the circular footprint (edge-cropped,
    like the reference's maxFilter which ignores out-of-image samples)."""
    fp = circular_footprint(radius)
    k = fp.shape[0] // 2
    h, w = img.shape[:2]
    out = np.zeros_like(img)
    for dy in range(-k, k + 1):
        for dx in range(-k, k + 1):
            if not fp[dy + k, dx + k]:
                continue
            ys = slice(max(0, -dy), min(h, h - dy))
            xs = slice(max(0, -dx), min(w, w - dx))
            ys_src = slice(max(0, dy), min(h, h + dy))
            xs_src = slice(max(0, dx), min(w, w + dx))
            np.maximum(out[ys, xs], img[ys_src, xs_src], out=out[ys, xs])
    return out


@pytest.mark.parametrize("name", ["minmaxTest1.tif", "minmaxTest2.tif"])
def test_max_filter_reference_images(name):
    """maxFilterForRGBImage: radius-10 circular max on the reference's
    own minmax fixtures (ImageOperationsTest.java:97-127)."""
    img = read_image(f"{FIXDIR}/{name}").as_rgb()
    np.testing.assert_array_equal(dilate_rgb(img, 10),
                                  _bruteforce_dilate(img, 10))


def test_max_filter_then_mirror_commutes(name="minmaxTest1.tif"):
    """maxFilterThenHorizontalMirroring == horizontalMirrorThenMaxFilter
    (ImageOperationsTest.java:129-195): the circular kernel is symmetric,
    so filter-then-flip equals flip-then-filter."""
    img = read_image(f"{FIXDIR}/{name}").as_rgb()
    np.testing.assert_array_equal(dilate_rgb(img, 10)[:, ::-1],
                                  dilate_rgb(img[:, ::-1], 10))


def test_over_expression_mask_flow():
    """overExpressesMaskExpression (ImageOperationsTest.java:22-41): clear
    label regions, build the d60-minus-d20 high-expression ring, convert
    to gray signal, count non-zero.  The reference asserts count > 0; the
    exact count is pinned here as a regression golden for the whole
    query-side shape pipeline on a real CDM."""
    img = read_image(f"{FIXDIR}/1281324958-DNp11-RT_18U_FL.tif").as_rgb()
    h, w = img.shape[:2]
    # the test's label region differs from production: x >= w-250 (not
    # w-270), y < 90
    xs = np.arange(w)[None, :]
    ys = np.arange(h)[:, None]
    region = ((xs < 330) & (ys < 100)) | ((xs >= w - 250) & (ys < 90))
    q = clear_region(img, region)
    d60 = dilate_rgb(q, 60)
    d20 = dilate_rgb(q, 20)
    # combine2: pixels present in the 20x image are masked out of the 60x
    ring = np.where((d20.astype(np.int32).sum(axis=-1) > 0)[..., None],
                    0, d60).astype(np.uint8)
    signal = rgb_signal(ring, 0)
    n = int(np.count_nonzero(signal))
    assert n > 0
    # regression golden (deterministic: integer pipeline on a fixed image)
    assert n == _OVEREXPR_GOLDEN


def test_gray16_monotone_range():
    """toGray16WithNoGammaCorrection on a real CDM: the gray16 value is
    (2(r+g+b)+3)//6, bounded by the max channel ordering
    (ColorTransformation.java:40-53,97-112)."""
    img = read_image(f"{FIXDIR}/minmaxTest1.tif").as_rgb()
    g = gray16_no_gamma(img)
    assert g.min() >= 0 and g.max() <= 255
    s = img.astype(np.int32).sum(axis=-1)
    np.testing.assert_array_equal(g, (2 * s + 3) // 6)
    # black maps to 0 exactly (the reference early-outs on 0)
    assert (g[(img == 0).all(axis=-1)] == 0).all()


def test_production_label_region_mask():
    """The production label regions (x<330,y<100 | x>=w-270,y<90) used by
    the engine (AbstractColorDepthSearchAlgorithm provider wiring)."""
    img = read_image(f"{FIXDIR}/1281324958-DNp11-RT_18U_FL.tif").as_rgb()
    h, w = img.shape[:2]
    region = label_regions_mask(w, h)
    q = clear_region(img, region)
    assert (q[:100, :330] == 0).all()
    assert (q[:90, w - 270:] == 0).all()
    # pixels outside the label regions are untouched
    np.testing.assert_array_equal(q[100:, :], img[100:, :])


# non-zero high-expression-ring pixels for the DNp11 fixture (computed
# once with the validated integer pipeline; the reference only asserts >0)
_OVEREXPR_GOLDEN = 102158

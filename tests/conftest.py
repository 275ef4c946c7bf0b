"""Test configuration.

JAX tests run on a virtual 8-device CPU mesh, so the multi-device
sharding logic is exercised without a GPU.  The env vars must be set
before jax is imported anywhere.  ``JAX_PLATFORMS`` is only defaulted:
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs the tests
marked ``gpu`` on the card, and they skip everywhere else.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

# in case a plugin imported jax before the env above applied
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402

FIXTURES = "/root/reference/colormipsearch-api/src/test/resources/colormipsearch/api"
MASK_TIF = f"{FIXTURES}/cdsearch/1752016801-LPLC2-RT_18U.tif"
TARGET_TIF = (f"{FIXTURES}/cdsearch/GMR_31G04_AE_01-20190813_66_F3-40x-Brain-"
              "JRC2018_Unisex_20x_HR-2704505419467849826-CH2-07_CDM.tif")


# the reference implementation's checkout, whose test resources some
# tests read
REFERENCE = FIXTURES.split("/colormipsearch-api/")[0]


def reference_fixture(*paths: str) -> None:
    """Skip the calling test or fixture unless the reference checkout's
    fixture files are present (they are not part of this repository)."""
    for path in paths or (REFERENCE,):
        if not os.path.exists(path):
            pytest.skip(f"reference fixture not present: {path}")


@pytest.fixture
def gpu():
    """Skip the test unless JAX runs on a GPU — decided when the test
    runs, never at import, so every xdist worker collects the same
    tests."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run: JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/)")


@pytest.fixture(scope="session")
def mask_rgb():
    from colormipsearch_tpu.io.image import read_image
    reference_fixture(MASK_TIF)
    return read_image(MASK_TIF).as_rgb()


@pytest.fixture(scope="session")
def target_rgb():
    from colormipsearch_tpu.io.image import read_image
    reference_fixture(TARGET_TIF)
    return read_image(TARGET_TIF).as_rgb()


@pytest.fixture(scope="session")
def golden_region(mask_rgb):
    """Excluded label regions used by the reference golden test."""
    h, w = mask_rgb.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    return ((xx >= w - 260) & (yy < 90)) | ((xx < 330) & (yy < 100))

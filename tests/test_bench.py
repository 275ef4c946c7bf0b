"""bench.py on the CPU: it refuses to measure anything but a GPU with a
published memory bandwidth, and every section runs at a tiny size."""

import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from colormipsearch_tpu import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_device_info_refuses_a_non_gpu(bench):
    with pytest.raises(SystemExit, match="measures a GPU"):
        bench.device_info()


def test_device_info_refuses_a_gpu_without_a_published_peak(bench,
                                                            monkeypatch):
    import jax

    fake = SimpleNamespace(platform="gpu", device_kind="Some Other GPU")
    monkeypatch.setattr(jax, "devices", lambda: [fake])
    with pytest.raises(SystemExit, match="no published memory bandwidth"):
        bench.device_info()


def test_build_workload_at_a_tiny_target_count(bench, monkeypatch):
    monkeypatch.setattr(bench, "N_TARGETS", 4)
    mask_rgb, targets, host_sample, region = bench.build_workload()
    assert mask_rgb.shape == (synth.HEIGHT, synth.WIDTH, 3)
    assert targets.shape == (4, synth.HEIGHT, synth.WIDTH, 3)
    np.testing.assert_array_equal(host_sample, targets)
    assert region.shape == (synth.HEIGHT, synth.WIDTH)
    # the targets are the seeded library's, decoded from PNG
    np.testing.assert_array_equal(targets[1],
                                  synth.target_image(bench.SEED, 1))


def test_every_section_runs_at_a_tiny_size(bench, monkeypatch, capsys):
    for name, value in (("N_TARGETS", 8), ("N_MASK_REPEATS", 2),
                        ("SHAPE_TARGETS", 64), ("SHAPE_REPEATS", 2),
                        ("E2E_CDS_MASKS", 2), ("E2E_CDS_TARGETS", 4),
                        ("E2E_SHAPE_TARGETS", 8), ("DRESS_MASKS", 4),
                        ("DRESS_TARGETS", 8), ("GRAD_DRESS_MASKS", 4),
                        ("GRAD_DRESS_TARGETS", 8),
                        ("GRAD_DRESS_HOST_MASKS", 2)):
        monkeypatch.setattr(bench, name, value)
    from colormipsearch_tpu.utils import caches

    # the cache rule has its own tests; keep this process's JAX config
    monkeypatch.setattr(caches, "enable_compilation_cache", lambda: None)
    kind = next(iter(bench.HBM_PEAK_GB_S))
    monkeypatch.setattr(bench, "device_info", lambda: {
        "platform": "cpu", "kind": kind, "count": 1, "card": []})
    assert bench.main() == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "cds_pair_comparisons_per_sec_per_card"
    assert out["value"] > 0 and out["device"]["kind"] == kind
    extra = out["extra"]
    for key in ("packed_pairs_per_s", "keys_pairs_per_s",
                "union_keys_pairs_per_s", "shape_pairs_per_s",
                "e2e_cds_pairs_per_s", "e2e_shape_targets_per_s",
                "e2e_dress_pairs_per_s"):
        assert extra[key] > 0, key
    assert extra["e2e_gradscore_dress"]["device_store"]["masks_run"] == 3

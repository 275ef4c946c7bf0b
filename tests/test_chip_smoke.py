"""chip_smoke.py's phases at a tiny size on the CPU (8 virtual devices, so
the target-sharded mesh path runs), its refusals, and the same phases on
a GPU when one is present."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs

N_MASKS, N_TARGETS = 6, 10


@pytest.fixture(scope="module")
def searched(tmp_path_factory):
    """Phases 1-2 once for the module: (work dir, specs, emitted)."""
    work = str(tmp_path_factory.mktemp("smoke"))
    specs = cs.make_library(work, seed=0, n_masks=N_MASKS,
                            n_targets=N_TARGETS)
    emitted = cs.pixel_search(work, N_MASKS, N_TARGETS)
    return work, specs, emitted


@pytest.fixture(scope="module")
def rescored(searched):
    work, specs, emitted = searched
    subset = cs.rescore_subset(specs, emitted, 8)
    return work, subset, cs.shape_pass(work, subset, emitted)


def test_search_emits_every_planted_match(searched):
    _work, specs, emitted = searched
    from colormipsearch_tpu import synth

    for s in specs:
        assert (synth.mask_name(s.index),
                synth.target_name(s.source)) in emitted


def test_pixel_scores_equal_the_oracle(searched):
    work, specs, emitted = searched
    cs.check_pixels(work, specs, emitted, n_targets=N_TARGETS,
                    n_pairs=24, seed=0)


def test_pixel_check_catches_a_wrong_score(searched):
    work, specs, emitted = searched
    key = next(iter(emitted))
    wrong = dict(emitted)
    wrong[key] = (wrong[key][0] + 1, wrong[key][1])
    with pytest.raises(AssertionError, match="differ from the oracle"):
        cs.check_pixels(work, specs, wrong, n_targets=N_TARGETS,
                        n_pairs=24, seed=0)


def test_pixel_check_catches_a_missing_match(searched):
    work, specs, emitted = searched
    wrong = dict(emitted)
    wrong.pop(next(iter(emitted)))
    with pytest.raises(AssertionError, match="differ from the oracle"):
        cs.check_pixels(work, specs, wrong, n_targets=N_TARGETS,
                        n_pairs=24, seed=0)


def test_rescore_subset_caps_and_keeps_planted_first(searched):
    _work, specs, emitted = searched
    from colormipsearch_tpu import synth

    sources = list(dict.fromkeys(synth.target_name(s.source)
                                 for s in specs))
    assert cs.rescore_subset(specs, emitted, 2) == sources[:2]
    assert set(sources) <= set(cs.rescore_subset(specs, emitted, 99))


def test_shape_scores_equal_the_oracle(rescored):
    work, _subset, scored = rescored
    assert len(scored) >= N_MASKS
    cs.check_shapes(work, scored, n_pairs=N_MASKS, seed=0)


def test_shape_check_catches_a_wrong_score(rescored):
    work, _subset, scored = rescored
    wrong = {k: (g + 1, h) for k, (g, h) in scored.items()}
    with pytest.raises(AssertionError, match="differ from the oracle"):
        cs.check_shapes(work, wrong, n_pairs=N_MASKS, seed=0)


def test_main_refuses_a_cpu(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cs.main(["--workdir", str(tmp_path / "w")])
    assert e.value.code not in (0, None)
    out = capsys.readouterr().out
    assert '"ok"' not in out
    assert not (tmp_path / "w").exists()  # stopped at phase 0


def test_lone_script_refuses(tmp_path):
    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.gpu
def test_smoke_phases_on_gpu(gpu, tmp_path, capsys):
    """The smoke phases at a small size on the card (the full-size run
    is `python chip_smoke.py`)."""
    import jax

    work = str(tmp_path)
    specs = cs.make_library(work, seed=1, n_masks=8, n_targets=64)
    emitted = cs.pixel_search(work, 8, 64)
    cs.check_pixels(work, specs, emitted, n_targets=64, n_pairs=64,
                    seed=1)
    scored = cs.shape_pass(work, cs.rescore_subset(specs, emitted, 16),
                           emitted)
    cs.check_shapes(work, scored, n_pairs=min(len(scored), 16), seed=1)
    assert jax.devices()[0].platform == "gpu"
    json.dumps(cs.peak_bytes(jax.devices()))

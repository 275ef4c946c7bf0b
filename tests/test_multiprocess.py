"""Two-process jax.distributed validation of the multi-host path.

Launches 2 REAL processes through scripts/run_multihost.py (the
multi-process launcher), each with 2 virtual CPU devices, forming a
4-device global mesh whose target axis spans the process boundary.  The selftest
inside each process scores a deterministic workload through the
shard_map step and checks it against the single-device kernel; this
test asserts both processes agree and that the distributed topology was
real.  (The reference has no distributed tests at all — SURVEY §4; its
distribution is validated operationally.)
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.slow

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_scoring(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    # REPO only, NOT the inherited path: a site directory on it could
    # import jax with another platform before the env below applies
    env["PYTHONPATH"] = str(REPO)

    procs = []
    outs = []
    for pid in range(2):
        out = tmp_path / f"proc{pid}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "scripts" / "run_multihost.py"),
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(pid),
             "--platform", "cpu", "--selftest", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))

    results = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=420)
            results.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    for rc, stdout, stderr in results:
        assert rc == 0, stderr.decode()[-2000:]

    docs = [json.loads(o.read_text()) for o in outs]
    for i, d in enumerate(docs):
        assert d["ok"], d
        assert d["num_processes"] == 2
        assert d["n_global_devices"] == 4  # 2 procs x 2 local devices
        assert d["process"] == i
    # both processes assembled identical global scores and pmax results
    assert docs[0]["scores"] == docs[1]["scores"]
    assert docs[0]["global_max"] == docs[1]["global_max"]
    assert any(s > 0 for row in docs[0]["scores"] for s in row)


@pytest.mark.parametrize("n_procs", [2, 4])
def test_multi_process_cli_colordepthsearch(tmp_path, n_procs):
    """The ACTUAL colorDepthSearch CLI under jax.distributed: N
    processes (2 virtual CPU devices each), per-process -od dirs, then
    the merged per-mask grouped JSON must equal a single-process run —
    the driver/executor analogue the kernel selftest doesn't cover
    (VERDICT r2 #5, widened to 4x2 per VERDICT r3 #5; ref
    SparkColorMIPSearchProcessor.java:43-81)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(7)
    h, w = 40, 64
    lib = tmp_path / "lib"
    lib.mkdir()
    # 3 masks + 60 targets: t_pad buckets to 64, so EVERY process's
    # device block holds real targets at both n_procs=2 (cols 32..63)
    # and n_procs=4 (cols 48..63) and the per-process write split is
    # observable
    for i in range(60):
        img = np.zeros((h, w, 3), np.uint8)
        n = 400
        img[rng.integers(0, h, n), rng.integers(0, w, n)] = \
            rng.integers(0, 256, (n, 3))
        Image.fromarray(img).save(lib / f"n{i:02d}.png")

    env = dict(os.environ)
    # REPO only, NOT the inherited path: a site directory on it could
    # import jax with another platform before the env below applies
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

    def cli_single(*argv):
        out = subprocess.run(
            [sys.executable, "-m", "colormipsearch_tpu.cli.main",
             *[str(a) for a in argv]],
            env=env, capture_output=True, text=True, timeout=420)
        assert out.returncode == 0, out.stderr[-2000:]

    cli_single("createColorDepthSearchDataInput", "-i", lib, "-l", "mp",
               "-od", tmp_path, "--output-filename", "all.json")
    neurons = json.loads((tmp_path / "all.json").read_text())
    (tmp_path / "masks.json").write_text(json.dumps(neurons[:3]))
    # targets include the masks so every mask has guaranteed matches
    # (self-match plus whatever the random pairs yield)
    (tmp_path / "targets.json").write_text(json.dumps(neurons))

    search_args = [
        "colorDepthSearch", "-m", tmp_path / "masks.json",
        "-i", tmp_path / "targets.json",
        "--maskThreshold", 20, "--dataThreshold", 20,
        "--pixColorFluctuation", 2.0, "--xyShift", 2, "--mirrorMask",
        # default label regions (x<330 / y<100) would cover the whole
        # 40x64 synthetic image and empty every query
        "--no-name-labels", "--no-colormap-labels"]

    # reference: a single-process run (2 local devices, same kernels)
    cli_single(*search_args, "-od", tmp_path / "ref",
               "--perMaskSubdir", "pm")

    # N-process distributed run, per-process output dirs
    port = _free_port()
    procs = []
    for pid in range(n_procs):
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "scripts" / "run_multihost.py"),
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(n_procs), "--process-id", str(pid),
             "--platform", "cpu", "--",
             *[str(a) for a in search_args],
             "-od", str(tmp_path / f"proc{pid}"),
             "--perMaskSubdir", "pm"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=420)
            assert p.returncode == 0, stderr.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    def rows(path):
        doc = json.loads(path.read_text())
        return {(r["image"]["mipId"], r["matchingPixels"], r["mirrored"],
                 r["matchingPixelsRatio"]) for r in doc["results"]}

    ref_dir = tmp_path / "ref" / "pm"
    ref_files = {f.name: rows(f) for f in ref_dir.glob("*.json")}
    assert ref_files, "single-process run produced no results"

    merged: dict[str, set] = {}
    per_proc_counts = []
    for pid in range(n_procs):
        pdir = tmp_path / f"proc{pid}" / "pm"
        n = 0
        for f in pdir.glob("*.json"):
            got = rows(f)
            n += len(got)
            merged.setdefault(f.name, set()).update(got)
        per_proc_counts.append(n)
    # the target shard really split across processes: each wrote SOME
    # results but fewer than the whole
    total = sum(len(v) for v in ref_files.values())
    assert sum(per_proc_counts) == total, (per_proc_counts, total)
    assert all(0 < c < total for c in per_proc_counts), per_proc_counts
    assert merged == ref_files

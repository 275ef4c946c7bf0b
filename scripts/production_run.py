#!/usr/bin/env python
"""THE production CDS workload, run for real.

44,593 masks x 7,391 targets — the reference's production envelope
(cdsparams.sh:6-12: one tile = the whole matrix, MASKS_PER_JOB=44593,
on a 20-core/170 GB grid node per job) — through the REAL
colorDepthSearch CLI on one card, with seeded synthetic CDMs
(colormipsearch_tpu/synth.py).

The matrix is chunked into N_TILES mask tiles (targets unsplit, so
tiles share the output dir safely — per-mask files never collide), so
a failure loses one tile, not the run.  Each tile is a separate CLI
process, run one after another; per-tile wall and stage splits are
captured from the engine logs.

Result: bench_runs/production_run_<ts>.json.

Env knobs: PROD_MASKS (44593), PROD_TARGETS (7391), PROD_TILES (4),
PROD_DIR (corpus dir, default .cache/cds_prod in the checkout; reused
if present so a re-run skips the synthesis).
"""

from __future__ import annotations

import glob
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

M = int(os.environ.get("PROD_MASKS", 44593))
T = int(os.environ.get("PROD_TARGETS", 7391))
N_TILES = int(os.environ.get("PROD_TILES", 4))
WORK = os.environ.get("PROD_DIR", os.path.join(REPO, ".cache", "cds_prod"))

STAGE_RE = re.compile(
    r"cds\.(prepMasks|decodeTargets|packUpload|scoreAllPairs|planArgs|"
    r"dispatch|emit|packSelect|packScatter)\S* finished in ([0-9.]+)s")
# the CLI's end-of-run machine-parseable counter line carries ALL
# stages (most are plain counters with no "finished in" log)
SUMMARY_RE = re.compile(r"cds stage seconds: (\{.*\})")


def synth() -> tuple[str, str]:
    from colormipsearch_tpu import synth

    masks_dir = os.path.join(WORK, "masks")
    targets_dir = os.path.join(WORK, "targets")
    done = os.path.join(WORK, ".synth_done")
    if os.path.exists(done):
        n_m = len(os.listdir(masks_dir))
        n_t = len(os.listdir(targets_dir))
        if n_m == M and n_t == T:
            print(f"# reusing corpus at {WORK} ({n_m} masks, {n_t} "
                  "targets)", file=sys.stderr, flush=True)
            return masks_dir, targets_dir
    for d in (masks_dir, targets_dir):
        os.makedirs(d, exist_ok=True)
        for f in os.scandir(d):
            os.unlink(f.path)
    t0 = time.perf_counter()
    synth.write_library(WORK, seed=31, n_masks=M, n_targets=T)
    open(done, "w").write("ok")
    print(f"# synthesized {M}+{T} CDMs in "
          f"{time.perf_counter() - t0:.0f}s", file=sys.stderr,
          flush=True)
    return masks_dir, targets_dir


def run_cli_proc(argv, log_path, timeout):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.setdefault("CDS_MASK_BATCH", "256")
    with open(log_path, "w") as log:
        p = subprocess.run(
            [sys.executable, "-m", "colormipsearch_tpu.cli.main",
             *[str(a) for a in argv]],
            env=env, stdout=log, stderr=subprocess.STDOUT,
            timeout=timeout)
    return p.returncode


def main() -> int:
    os.makedirs(WORK, exist_ok=True)
    t_all = time.perf_counter()
    masks_dir, targets_dir = synth()
    synth_s = time.perf_counter() - t_all

    # data inputs (reused when present)
    for d, name, lbl in ((masks_dir, "m", "prod-m"),
                         (targets_dir, "t", "prod-t")):
        out = os.path.join(WORK, f"{name}.json")
        if not (os.path.exists(out)
                and os.path.getmtime(out) > os.path.getmtime(
                    os.path.join(WORK, ".synth_done"))):
            rc = run_cli_proc(
                ["createColorDepthSearchDataInput", "-i", d, "-l", lbl,
                 "-od", WORK, "--output-filename", f"{name}.json"],
                os.path.join(WORK, f"datainput_{name}.log"), 1800)
            assert rc == 0, f"data input {name} failed"

    out_dir = os.path.join(WORK, "results")
    os.makedirs(out_dir, exist_ok=True)
    per_tile = (M + N_TILES - 1) // N_TILES
    tiles = []
    t_run = time.perf_counter()
    for i in range(N_TILES):
        off = i * per_tile
        ln = min(per_tile, M - off)
        if ln <= 0:
            break
        done_marker = os.path.join(WORK, f".tile{i}_done")
        log_path = os.path.join(WORK, f"tile{i}.log")
        if os.path.exists(done_marker):
            tiles.append(json.load(open(done_marker)))
            print(f"# tile {i} already done: "
                  f"{tiles[-1]['wall_s']:.0f}s", file=sys.stderr,
                  flush=True)
            continue
        t0 = time.perf_counter()
        rc = run_cli_proc(
            ["colorDepthSearch", "-m", os.path.join(WORK, "m.json"),
             "-i", os.path.join(WORK, "t.json"),
             "--masks-index", off, "--masks-length", ln,
             "--maskThreshold", 20, "--dataThreshold", 20,
             "--pixColorFluctuation", 1.0, "--xyShift", 2,
             "--mirrorMask", "--pctPositivePixels", 1.0,
             "-od", out_dir, "--perMaskSubdir", "pm"],
            log_path, 5400)
        wall = time.perf_counter() - t0
        assert rc == 0, f"tile {i} failed (see {log_path})"
        stages: dict[str, float] = {}
        for line in open(log_path, errors="replace"):
            sm = SUMMARY_RE.search(line)
            if sm:
                stages = {k: v for k, v in json.loads(sm.group(1)).items()
                          if v}
                continue
            mm = STAGE_RE.search(line)
            if mm and mm.group(1) not in stages:
                stages[mm.group(1)] = stages.get(mm.group(1), 0.0) \
                    + float(mm.group(2))
        tile = {"tile": i, "masks": ln, "wall_s": round(wall, 1),
                "pairs": ln * T, "stages_s":
                {k: round(v, 1) for k, v in stages.items()}}
        json.dump(tile, open(done_marker, "w"))
        tiles.append(tile)
        print(f"# tile {i}: {ln} masks in {wall:.0f}s "
              f"({ln * T / wall / 1e3:.0f}k pairs/s)", file=sys.stderr,
              flush=True)
    run_wall = time.perf_counter() - t_run

    n_files = len(glob.glob(os.path.join(out_dir, "pm", "*.json")))
    n_matches = 0
    for f in glob.glob(os.path.join(out_dir, "pm", "*.json"))[:500]:
        n_matches += len(json.load(open(f)).get("results", ()))
    pairs = M * T
    # the e2e rate must use the SUM of tile walls, not the wall of
    # this invocation: resumed tiles (done markers) contribute pairs
    # without contributing wall here (review r5)
    tiles_wall = sum(t["wall_s"] for t in tiles)
    result = {
        "masks": M, "targets": T, "pairs": pairs,
        "n_tiles": len(tiles), "tiles": tiles,
        "run_wall_s": round(tiles_wall, 1),
        "this_invocation_wall_s": round(run_wall, 1),
        "pairs_per_s_e2e": round(pairs / tiles_wall, 1),
        "synth_s": round(synth_s, 1),
        "result_files": n_files,
        "matches_in_first_500_files": n_matches,
        "note": "44,593x7,391 production workload through the real CLI "
                "(reference envelope: cdsparams.sh one 20-core/170GB "
                "grid node per job); tiles share -od (mask-split only: "
                "per-mask files never collide)",
    }
    os.makedirs(os.path.join(REPO, "bench_runs"), exist_ok=True)
    path = os.path.join(REPO, "bench_runs",
                        f"production_run_{time.strftime('%Y%m%dT%H%M%S')}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    result["saved"] = path
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

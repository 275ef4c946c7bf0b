#!/usr/bin/env python
"""The production shape-pass handoff.

Takes the production corpus (scripts/production_run.py), generates the
target variants with the framework's own `precomputeVariants` (the
step the reference outsources to a Fiji pipeline), re-registers the
targets WITH variants, runs the real `colorDepthSearch` for a
256-mask tile, then the real `gradientScores` over its output with
the packed store + the auto-enabled device-resident store — i.e. the
complete CDS -> variants -> gradientScores production handoff on real
CLI outputs end to end.

Result: bench_runs/production_grad_pass_<ts>.json.

Env: PGP_MASKS (256), PGP_TOPK (300).  The corpus directory is
scripts/production_run.py's (PROD_DIR, default .cache/cds_prod in the
checkout); run that script first so it holds the synthesized corpus.
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

M = int(os.environ.get("PGP_MASKS", 256))
TOPK = int(os.environ.get("PGP_TOPK", 300))

sys.path.insert(0, os.path.join(REPO, "scripts"))
from production_run import WORK, run_cli_proc  # noqa: E402

GS_RE = re.compile(r"grad-scored (\d+)/(\d+) matches")


def main() -> int:
    targets_dir = os.path.join(WORK, "targets")
    var_dir = os.path.join(WORK, "variants")
    stages: dict[str, float] = {}

    # 1. variants (skipped when present from an earlier run)
    grad_dir = os.path.join(var_dir, "grad")
    n_t = len(glob.glob(os.path.join(targets_dir, "*.png")))
    t0 = time.perf_counter()
    if len(glob.glob(os.path.join(grad_dir, "*.png"))) != n_t:
        rc = run_cli_proc(
            ["precomputeVariants", "-i", targets_dir, "-od", var_dir,
             "--maskThreshold", 20, "--negativeRadius", 20],
            os.path.join(WORK, "variants.log"), 7200)
        assert rc == 0, "precomputeVariants failed"
    stages["precomputeVariants"] = time.perf_counter() - t0

    # 2. target data input WITH variant registration
    t0 = time.perf_counter()
    rc = run_cli_proc(
        ["createColorDepthSearchDataInput", "-i", targets_dir,
         "-l", "prod-t", "--gradients-location", grad_dir,
         "--gradient-suffix", "_gradient",
         "--zgap-location", os.path.join(var_dir, "zgap"),
         "--zgap-suffix", "_20pxRGB",
         "-od", WORK, "--output-filename", "t_var.json"],
        os.path.join(WORK, "datainput_tvar.log"), 1800)
    assert rc == 0
    doc = json.load(open(os.path.join(WORK, "t_var.json")))
    n_with_var = sum(1 for d in doc
                     if "GradientImage" in d.get("computeFiles", {}))
    assert n_with_var == len(doc), (n_with_var, len(doc))
    stages["dataInput"] = time.perf_counter() - t0

    # 3. pixel search for an M-mask tile against ALL targets
    out_cds = os.path.join(WORK, "gradpass_cds")
    t0 = time.perf_counter()
    rc = run_cli_proc(
        ["colorDepthSearch", "-m", os.path.join(WORK, "m.json"),
         "-i", os.path.join(WORK, "t_var.json"),
         "--masks-index", 0, "--masks-length", M,
         "--maskThreshold", 20, "--dataThreshold", 20,
         "--pixColorFluctuation", 1.0, "--xyShift", 2,
         "--mirrorMask", "--pctPositivePixels", 1.0,
         "-od", out_cds, "--perMaskSubdir", "pm"],
        os.path.join(WORK, "gradpass_cds.log"), 5400)
    assert rc == 0
    stages["colorDepthSearch"] = time.perf_counter() - t0
    mask_files = glob.glob(os.path.join(out_cds, "pm", "*.json"))
    n_matches_in = sum(len(json.load(open(f)).get("results", ()))
                       for f in mask_files)

    # 4. the REAL production grad pass over the REAL search output
    out_gs = os.path.join(WORK, "gradpass_gs")
    store = os.path.join(WORK, "gradpass_store")
    log_gs = os.path.join(WORK, "gradpass_gs.log")
    t0 = time.perf_counter()
    rc = run_cli_proc(
        ["gradientScores", "--matches", os.path.join(out_cds, "pm"),
         "-od", out_gs, "--maskThreshold", 20, "--mirrorMask",
         "--nBestLines", TOPK, "--packed-variants-store", store],
        log_gs, 7200)
    assert rc == 0
    gs_wall = time.perf_counter() - t0
    stages["gradientScores"] = gs_wall
    scored = 0
    for line in open(log_gs, errors="replace"):
        mm = GS_RE.search(line)
        if mm:
            scored += int(mm.group(1))
    auto = any("auto-enabled" in line
               for line in open(log_gs, errors="replace"))
    assert scored > 0

    result = {
        "masks": len(mask_files), "targets": n_t,
        "matches_from_search": n_matches_in,
        "matches_grad_scored": scored,
        "grad_targets_per_s": round(scored / gs_wall, 1),
        "device_store_auto_enabled": auto,
        "stages_s": {k: round(v, 1) for k, v in stages.items()},
        "note": "complete production handoff on real CLI outputs: "
                "corpus -> precomputeVariants (the step the reference "
                "outsources to Fiji) -> variant-registered data input "
                "-> colorDepthSearch tile -> gradientScores "
                "(nBestLines %d) with packed + device-resident store"
                % TOPK,
    }
    os.makedirs(os.path.join(REPO, "bench_runs"), exist_ok=True)
    path = os.path.join(REPO, "bench_runs",
                        f"production_grad_pass_{time.strftime('%Y%m%dT%H%M%S')}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    result["saved"] = path
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the search's main path on one GPU (or four).

Drives the command-line interface in-process, the way a user runs a
search, at the production image shape (JRC2018_Unisex_20x_HR, 566 x 1210
RGB) and one production shard of targets:

  phase 0  device: JAX's devices and the card's name and power limit;
           anything but a GPU stops the run here with a non-zero exit
  phase 1  inputs: a seeded synthetic library (colormipsearch_tpu/synth.py)
           of 64 masks and 4,096 targets, written as PNG
  phase 2  pixel-match search: createColorDepthSearchDataInput, then
           colorDepthSearch with the production parameters
  phase 3  pixel correctness: >= 256 sampled pairs against the float64
           oracle (oracle/pixel.py), zero tolerance
  phase 4  shape pass: precomputeVariants for the targets the matches
           name, createColorDepthSearchDataInput registering the
           variants, colorDepthSearch over those targets, then
           gradientScores; >= 64 sampled pairs against the float64
           shape oracle (oracle/shape.py), zero tolerance

Every phase prints its wall time with the compile time apart.  The last
line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure exits non-zero before that line.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # targets sharded over a 4-card mesh

One process drives the card(s): every command runs in this process.  Its
children — nvidia-smi, the native decoder's g++ build and the library
writer's numpy workers (held to the CPU) — never touch the card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

SEED = 0
N_MASKS = 64          # >= 32 switches gradientScores to its device store
N_TARGETS = 4096      # one production target shard (engine/cds.py)
N_PIXEL_PAIRS = 256
N_SHAPE_PAIRS = 64
RESCORE_CAP = 512     # host variant generation is ~0.2 s per target
N_BEST_LINES = 300    # gradientScores rescores each mask's top 300 lines
ALIGNMENT_SPACE = "JRC2018_Unisex_20x_HR"
# production pixel-match parameters (the reference's cdsparams.sh)
CDS_ARGS = ["--maskThreshold", "20", "--dataThreshold", "20",
            "--pixColorFluctuation", "1.0", "--xyShift", "2",
            "--mirrorMask", "--pctPositivePixels", "1.0"]

_compile_s = 0.0


def log(msg: str) -> None:
    print(msg, flush=True)


def _on_duration(event: str, secs: float, **_kw) -> None:
    global _compile_s
    if event.startswith("/jax/core/compile/"):
        _compile_s += secs


@contextlib.contextmanager
def phase(name: str):
    t0, c0 = time.perf_counter(), _compile_s
    log(f"== {name}")
    yield
    log(f"== {name}: {time.perf_counter() - t0:.1f} s wall, of which "
        f"{_compile_s - c0:.1f} s compiling")


def cli(*argv) -> None:
    from colormipsearch_tpu.cli.main import main as cli_main

    argv = [str(a) for a in argv]
    rc = cli_main(argv)
    if rc != 0:
        raise RuntimeError(f"CLI {argv[0]} exited {rc}")


def peak_bytes(devices) -> str:
    stats = [d.memory_stats() for d in devices]
    if any(s is None for s in stats):
        return "peak_bytes_in_use: not reported by this backend"
    return "peak_bytes_in_use: " + ", ".join(
        f"{d.id}={s['peak_bytes_in_use']}" for d, s in zip(devices, stats))


# -- phase 0 ----------------------------------------------------------------

def check_device(n_cards: int):
    """Print JAX's devices and the card; exit unless they are GPUs."""
    import jax

    devices = jax.devices()
    d0 = devices[0]
    log(f"jax {jax.__version__}: {devices}")
    log(f"platform={d0.platform} device_kind={d0.device_kind} "
        f"count={len(devices)}")
    if d0.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {d0.platform!r}); "
              "a missing CUDA plugin falls back to the CPU silently",
              file=sys.stderr)
        raise SystemExit(1)
    if len(devices) != n_cards:
        print(f"chip_smoke: expected {n_cards} GPU(s), JAX sees "
              f"{len(devices)}", file=sys.stderr)
        raise SystemExit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log("card name, power limit (nvidia-smi):")
    for line in smi.stdout.strip().splitlines():
        log(line.strip())
    return devices


def report_host() -> None:
    """What the host offers the decode path: Pillow, g++, zlib."""
    try:
        import PIL
        pil = f"importable ({PIL.__version__})"
    except ImportError:
        pil = "not installed"
    from colormipsearch_tpu.io import native_decoder

    zlib = "present" if os.path.exists("/usr/include/zlib.h") else "absent"
    log(f"host: PIL {pil}; g++ {shutil.which('g++') or 'absent'}; "
        f"zlib.h {zlib}; image decoder: "
        f"{'native' if native_decoder.available() else 'PIL'}")


# -- phase 1 ----------------------------------------------------------------

def make_library(work: str, *, seed: int, n_masks: int, n_targets: int,
                 shape=None):
    from colormipsearch_tpu import synth

    shape = shape or (synth.HEIGHT, synth.WIDTH)
    specs = synth.write_library(os.path.join(work, "lib"), seed=seed,
                                n_masks=n_masks, n_targets=n_targets,
                                shape=shape)
    log(f"library: {n_masks} masks x {n_targets} targets at "
        f"{shape[1]}x{shape[0]} RGB, seed {seed}, under {work}/lib")
    return specs


# -- phase 2 ----------------------------------------------------------------

def search(work: str, targets_json: str, out: str) -> dict:
    """colorDepthSearch of all masks against ``targets_json``; returns
    {(mask id, target id): (matchingPixels, mirrored)} as emitted."""
    from colormipsearch_tpu.dataio.json_io import JSONMatchesReader

    cli("colorDepthSearch", "-m", os.path.join(work, "masks.json"),
        "-i", targets_json, *CDS_ARGS, "-od", out,
        "--perMaskSubdir", "masks")
    emitted = {}
    for loc in JSONMatchesReader.list_matches_locations(
            [os.path.join(out, "masks")]):
        for m in JSONMatchesReader.read_matches(loc):
            emitted[(m.mask_image.mip_id, m.matched_image.mip_id)] = (
                int(m.matching_pixels), bool(m.mirrored))
    return emitted


def pixel_search(work: str, n_masks: int, n_targets: int) -> dict:
    from colormipsearch_tpu.utils.metrics import GLOBAL

    lib = os.path.join(work, "lib")
    for kind, lname, typ in (("masks", "synth_em_masks", "em"),
                             ("targets", "synth_lm_targets", "lm")):
        cli("createColorDepthSearchDataInput", "-i",
            os.path.join(lib, kind), "-l", lname, "--type", typ,
            "--alignment-space", ALIGNMENT_SPACE, "-od", work,
            "--output-filename", f"{kind}.json")
    pairs0 = GLOBAL.get("pairsScored")
    emitted = search(work, os.path.join(work, "targets.json"),
                     os.path.join(work, "results"))
    pairs = int(GLOBAL.get("pairsScored") - pairs0)
    log(f"colorDepthSearch scored {pairs} pairs ({n_masks} masks x "
        f"{n_targets} targets), emitted {len(emitted)} matches")
    if pairs != n_masks * n_targets:
        raise AssertionError(f"scored {pairs} pairs, expected "
                             f"{n_masks * n_targets}")
    return emitted


# -- phase 3 ----------------------------------------------------------------

def _params():
    from colormipsearch_tpu.engine.cds import CDSParams

    # what CDS_ARGS and the CLI's label-region defaults select
    return CDSParams(mask_threshold=20, data_threshold=20,
                     pix_color_fluctuation=1.0, xy_shift=2,
                     mirror_mask=True, pct_positive_pixels=1.0,
                     with_name_label_region=True,
                     with_color_scale_region=True)


def _read_rgb(path: str):
    from colormipsearch_tpu.io.image import read_image

    return read_image(path).as_rgb()


def _sample_pairs(rng, planted, pool, n_masks, n_targets, n_total):
    """Planted pairs first, then up to a quarter from ``pool``, then
    uniformly random pairs, until ``n_total`` distinct pairs."""
    pairs = list(dict.fromkeys(planted))
    extra = sorted(set(pool) - set(pairs))
    for i in rng.permutation(len(extra))[:n_total // 4]:
        pairs.append(extra[i])
    seen = set(pairs)
    while len(pairs) < n_total:
        p = (int(rng.integers(n_masks)), int(rng.integers(n_targets)))
        if p not in seen:
            seen.add(p)
            pairs.append(p)
    return pairs


def check_pixels(work: str, specs, emitted: dict, *, n_targets: int,
                 n_pairs: int, seed: int) -> None:
    """Emitted pairs must equal the oracle's matchingPixels and
    mirrored exactly; pairs not emitted must be at or below the
    pctPositivePixels threshold by the oracle."""
    import numpy as np

    from colormipsearch_tpu import synth
    from colormipsearch_tpu.oracle.pixel import PixelMatchOracle

    p = _params()
    lib = os.path.join(work, "lib")
    idx = {synth.mask_name(s.index): s.index for s in specs}
    tidx = {synth.target_name(t): t for t in range(n_targets)}
    rng = np.random.default_rng(seed)
    planted = [(s.index, s.source) for s in specs]
    pool = [(idx[m], tidx[t]) for m, t in emitted]
    pairs = _sample_pairs(rng, planted, pool, len(specs), n_targets,
                          n_pairs)
    oracles = {}

    def oracle(m):
        if m not in oracles:
            rgb = _read_rgb(os.path.join(lib, "masks",
                                         synth.mask_name(m) + ".png"))
            oracles[m] = PixelMatchOracle(
                rgb, p.mask_threshold, mirror=p.mirror_mask,
                target_threshold=p.data_threshold,
                z_tolerance=p.pix_color_fluctuation / 100,
                xy_shift=p.xy_shift,
                excluded_region=p.excluded_region(*rgb.shape[:2]))
        return oracles[m]

    for m in sorted({m for m, _ in pairs}):
        oracle(m)

    def one(pair):
        m, t = pair
        res = oracle(m).score(_read_rgb(os.path.join(
            lib, "targets", synth.target_name(t) + ".png")))
        want = (res.matching_pixels > 0 and res.matching_pixels_ratio
                > p.pct_positive_pixels / 100)
        got = emitted.get((synth.mask_name(m), synth.target_name(t)))
        if got is None:
            return None if not want else (pair, "not emitted", res)
        if not want or got != (res.matching_pixels, res.mirrored):
            return (pair, f"emitted {got}", res)
        return None

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        bad = [b for b in ex.map(one, pairs) if b is not None]
    n_em = sum((synth.mask_name(m), synth.target_name(t)) in emitted
               for m, t in pairs)
    n_pl = sum((synth.mask_name(m), synth.target_name(t)) in emitted
               for m, t in planted)
    log(f"pixel oracle: {len(pairs)} pairs compared ({n_em} emitted, "
        f"{n_pl}/{len(planted)} planted matches found), "
        f"{len(bad)} differ")
    if bad:
        for pair, what, res in bad[:10]:
            log(f"  pair {pair}: device {what}, oracle "
                f"{res.matching_pixels} mirrored={res.mirrored} "
                f"ratio={res.matching_pixels_ratio:.5f}")
        raise AssertionError(f"{len(bad)} pixel pairs differ from the "
                             "oracle")


# -- phase 4 ----------------------------------------------------------------

def rescore_subset(specs, emitted: dict, cap: int) -> list[str]:
    """Target ids the matches name: the planted sources first, then by
    how many masks matched them; at most ``cap``."""
    from colormipsearch_tpu import synth

    count: dict[str, int] = {}
    for _m, t in emitted:
        count[t] = count.get(t, 0) + 1
    first = [t for t in dict.fromkeys(synth.target_name(s.source)
                                      for s in specs) if t in count]
    rest = sorted(set(count) - set(first), key=lambda t: (-count[t], t))
    named = first + rest
    if len(named) > cap:
        log(f"phase 4 rescores a {cap}-target subset of the "
            f"{len(named)} targets the matches name: host variant "
            "generation takes ~0.2 s per target")
    return named[:cap]


def shape_pass(work: str, subset: list[str], emitted: dict) -> tuple:
    """precomputeVariants -> data input with the variants ->
    colorDepthSearch over the subset -> gradientScores.  Returns the
    rescored matches {(mask id, target id): (gap, high expression)}."""
    from colormipsearch_tpu.dataio.json_io import JSONMatchesReader
    from colormipsearch_tpu.results.grouping import select_best_matches

    lib = os.path.join(work, "lib")
    sub = os.path.join(lib, "rescore")
    os.makedirs(sub, exist_ok=True)
    for t in subset:
        shutil.copyfile(os.path.join(lib, "targets", t + ".png"),
                        os.path.join(sub, t + ".png"))
    var = os.path.join(work, "variants")
    t0 = time.perf_counter()
    cli("precomputeVariants", "-i", sub, "-od", var,
        "--maskThreshold", "20", "--negativeRadius", "20")
    log(f"precomputeVariants: {len(subset)} targets in "
        f"{time.perf_counter() - t0:.1f} s")
    cli("createColorDepthSearchDataInput", "-i", sub,
        "-l", "synth_lm_targets", "--type", "lm",
        "--alignment-space", ALIGNMENT_SPACE,
        "--gradients-location", os.path.join(var, "grad"),
        "--zgap-location", os.path.join(var, "zgap"),
        "-od", work, "--output-filename", "rescore.json")
    again = search(work, os.path.join(work, "rescore.json"),
                   os.path.join(work, "results_rescore"))
    rescored = set(subset)
    want = {k: v for k, v in emitted.items() if k[1] in rescored}
    if again != want:
        diff = sorted(set(again.items()) ^ set(want.items()))[:10]
        raise AssertionError("colorDepthSearch over the rescored "
                             f"targets disagrees with phase 2: {diff}")
    log(f"colorDepthSearch over the {len(subset)} rescored targets "
        f"reproduced phase 2's {len(want)} matches among them")
    gs = os.path.join(work, "gradscores")
    cli("gradientScores", "--matches",
        os.path.join(work, "results_rescore", "masks"),
        "--maskThreshold", "20", "--negativeRadius", "20",
        "--nBestLines", N_BEST_LINES, "--mirrorMask",
        "--packed-variants-store", os.path.join(work, "packstore"),
        "-od", gs)
    scored = {}
    for loc in JSONMatchesReader.list_matches_locations([gs]):
        for m in JSONMatchesReader.read_matches(loc):
            if m.gradient_area_gap is not None and m.gradient_area_gap >= 0:
                scored[(m.mask_image.mip_id, m.matched_image.mip_id)] = (
                    int(m.gradient_area_gap), int(m.high_expression_area))
    # gradientScores rescores only each mask's top --nBestLines lines
    # (ColorMIPProcessUtils.selectBestMatches); every one of those, and
    # nothing else, must come back scored
    kept = set()
    for loc in JSONMatchesReader.list_matches_locations(
            [os.path.join(work, "results_rescore", "masks")]):
        kept.update((m.mask_image.mip_id, m.matched_image.mip_id)
                    for m in select_best_matches(
                        JSONMatchesReader.read_matches(loc),
                        N_BEST_LINES, -1, -1))
    log(f"gradientScores: {len(want)} matches in, {len(kept)} among each "
        f"mask's top {N_BEST_LINES} lines, {len(want) - len(kept)} cut "
        "by --nBestLines")
    if set(scored) != kept:
        diff = sorted(set(scored) ^ kept)[:10]
        raise AssertionError("gradientScores scored other pairs than "
                             f"each mask's top lines: {diff}")
    log(f"gradientScores scored {len(scored)} pairs")
    return scored


def check_shapes(work: str, scored: dict, *, n_pairs: int,
                 seed: int) -> None:
    import numpy as np

    from colormipsearch_tpu.io.image import read_image
    from colormipsearch_tpu.oracle.shape import ShapeMatchOracle

    if len(scored) < n_pairs:
        raise AssertionError(f"only {len(scored)} shape-scored pairs, "
                             f"need {n_pairs}")
    p = _params()
    lib = os.path.join(work, "lib")
    var = os.path.join(work, "variants")
    keys = sorted(scored)
    rng = np.random.default_rng(seed)
    pairs = [keys[i] for i in rng.permutation(len(keys))[:n_pairs]]

    def one(pair):
        m, t = pair
        q = _read_rgb(os.path.join(lib, "masks", m + ".png"))
        oracle = ShapeMatchOracle(
            q, p.mask_threshold, mirror=p.mirror_mask,
            negative_radius=p.negative_radius,
            excluded_region=p.shape_excluded_region(*q.shape[:2]))
        res = oracle.score(
            _read_rgb(os.path.join(lib, "rescore", t + ".png")),
            read_image(os.path.join(var, "grad",
                                    t + "_gradient.png")).pixels,
            _read_rgb(os.path.join(var, "zgap", t + "_20pxRGB.png")))
        got = scored[pair]
        want = (res.gradient_area_gap, res.high_expression_area)
        return None if got == want else (pair, got, want)

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        bad = [b for b in ex.map(one, pairs) if b is not None]
    log(f"shape oracle: {len(pairs)} pairs compared "
        f"(gradientAreaGap, highExpressionArea), {len(bad)} differ")
    if bad:
        for pair, got, want in bad[:10]:
            log(f"  pair {pair}: device {got}, oracle {want}")
        raise AssertionError(f"{len(bad)} shape pairs differ from the "
                             "oracle")


# -- driver -----------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run phases 2-4 with the targets sharded over a "
                         "4-card mesh")
    ap.add_argument("--workdir", default=os.path.join(REPO, ".cache",
                                                      "smoke"),
                    help="scratch directory (emptied first, removed "
                         "after a passing run)")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "colormipsearch_tpu")):
        print("chip_smoke: run it from a checkout of the repository "
              "(the colormipsearch_tpu package is not beside it)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    import jax

    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    n_cards = 4 if args.four_cards else 1
    with phase("phase 0: device"):
        devices = check_device(n_cards)
        report_host()
    work = args.workdir
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with phase("phase 1: seeded inputs"):
        specs = make_library(work, seed=SEED, n_masks=N_MASKS,
                             n_targets=N_TARGETS)
    with phase("phase 2: colorDepthSearch"):
        if n_cards > 1:
            log(f"targets sharded over a {n_cards}-device mesh")
        emitted = pixel_search(work, N_MASKS, N_TARGETS)
        log(peak_bytes(devices))
    with phase("phase 3: pixel oracle"):
        check_pixels(work, specs, emitted, n_targets=N_TARGETS,
                     n_pairs=N_PIXEL_PAIRS, seed=SEED)
    with phase("phase 4: gradientScores"):
        subset = rescore_subset(specs, emitted, RESCORE_CAP)
        scored = shape_pass(work, subset, emitted)
        log(peak_bytes(devices))
        check_shapes(work, scored, n_pairs=N_SHAPE_PAIRS, seed=SEED)
    shutil.rmtree(work, ignore_errors=True)
    d0 = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

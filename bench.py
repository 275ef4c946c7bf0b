"""Throughput benchmark of the search on one GPU.

Workload: the production CDS configuration (maskThreshold 20,
dataThreshold 20, pixColorFluctuation 1.0, xyShift 2, mirror — reference
cdsparams.sh:42-46 / DATA_NOTES.md:59-66) on a seeded synthetic library
(colormipsearch_tpu/synth.py) at the JRC2018_Unisex_20x_HR shape: one
synthetic mask of ~2k query pixels scored against N_TARGETS synthetic
targets.

Sections: the pixel kernels at T=N_TARGETS (packed, classic keys,
x-union, and the full-union form the engine runs by default); the split
shape kernel; decode-inclusive colorDepthSearch and gradientScores CLI
runs; the production-shaped colorDepthSearch dress and the
gradientScores dress (host tile pack vs the device-resident store).

Baseline: the reference publishes no throughput numbers (BASELINE.md), so
the baseline is measured here: the vectorized float64 numpy oracle —
itself faster than the reference's scalar Java loops — timed on one core
and scaled by the reference's production per-node concurrency (39 threads
on a 20-core node, submitCDSJob.sh:13-18).  vs_baseline is pairs/s per
card over that estimated per-node baseline.

Every result names the device it ran on (platform, device_kind, count,
and the card's name and power limit from nvidia-smi); on anything but a
GPU the run fails.  Any failing section fails the run.  Prints ONE JSON
line last: {"metric", "value", "unit", "vs_baseline", "device", "extra"}.
"""

from __future__ import annotations

import json
import os as _os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = _os.path.dirname(_os.path.abspath(__file__))
SEED = 0  # the synthetic library's seed
# T=4096 is one production shard and B=8 the engine's mask batch: the
# defaults, not values tuned on this card
N_TARGETS = int(_os.environ.get("CDS_BENCH_TARGETS", 4096))
N_MASK_REPEATS = int(_os.environ.get("CDS_BENCH_REPEATS", 24))
MASK_BATCH = int(_os.environ.get("CDS_BENCH_MASK_BATCH", 8))
SHAPE_TARGETS = int(_os.environ.get("CDS_BENCH_SHAPE_TARGETS", 4096))
SHAPE_REPEATS = int(_os.environ.get("CDS_BENCH_SHAPE_REPEATS", 50))
BASELINE_ORACLE_TARGETS = 24
REFERENCE_NODE_THREADS = 39  # submitCDSJob.sh:13-18 (2*20 cores - 1)

# published device-memory bandwidth by jax device_kind, GB/s
# (NVIDIA H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s)
HBM_PEAK_GB_S = {"NVIDIA H100 80GB HBM3": 3350.0}


def device_info() -> dict:
    """The device every result is reported against; fails unless JAX
    runs on a GPU with a published peak in HBM_PEAK_GB_S."""
    import jax

    devices = jax.devices()
    d0 = devices[0]
    if d0.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found "
                         f"{d0.platform!r} ({devices})")
    if d0.device_kind not in HBM_PEAK_GB_S:
        raise SystemExit(f"no published memory bandwidth for "
                         f"{d0.device_kind!r}; add it to HBM_PEAK_GB_S")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devices),
            "card": [ln.strip() for ln in smi.stdout.strip().splitlines()]}


def _scratch_dir():
    """A temporary directory inside the checkout's cache."""
    base = _os.path.join(REPO, ".cache")
    _os.makedirs(base, exist_ok=True)
    return tempfile.TemporaryDirectory(dir=base)


def build_workload():
    """(mask_rgb, target_stack, host_sample, region): the benchmark's
    mask, its N_TARGETS targets, the oracle baseline's targets, and the
    CLI's default excluded label region."""
    from colormipsearch_tpu import synth
    from colormipsearch_tpu.oracle.pixel import label_regions_mask

    region = label_regions_mask(synth.WIDTH, synth.HEIGHT)
    # the first synthetic mask with a query size like the reference's
    # golden EM mask (1,897 pixels)
    for m in range(256):
        spec = synth.mask_spec(SEED, m, N_TARGETS)
        mask_rgb = synth.mask_image(SEED, spec)
        q = int(((mask_rgb > 20).any(axis=-1) & ~region).sum())
        if 1500 <= q <= 3000:
            break
    # drawn in parallel processes to disk, decoded by the engine's
    # native batch decoder
    from colormipsearch_tpu.io import native_decoder

    with _scratch_dir() as tmp:
        paths = write_library(tmp, 0, N_TARGETS, seed=SEED)
        blobs = [open(p, "rb").read() for p in paths]
    targets, ok = native_decoder.decode_img_batch(
        blobs, width=synth.WIDTH, height=synth.HEIGHT, channels=3)
    assert ok.all()
    host_sample = targets[:BASELINE_ORACLE_TARGETS].copy()
    return mask_rgb, targets, host_sample, region


def build_planes(targets: np.ndarray, kind: str = "packed"):
    """The engine's device planes for a target stack, data threshold 20
    folded into the pack (its production configuration)."""
    import jax

    from colormipsearch_tpu.engine.cds import _pack_target_stack

    return jax.block_until_ready(
        _pack_target_stack(targets, targets.shape[0], kind, 20))


def write_library(out_dir: str, n_masks: int, n_targets: int, *,
                  seed: int) -> list[str]:
    """The synthetic library as PNGs under ``out_dir``/masks and
    ``out_dir``/targets (colormipsearch_tpu/synth.py); returns the
    target paths."""
    from colormipsearch_tpu import synth

    synth.write_library(out_dir, seed=seed, n_masks=n_masks,
                        n_targets=n_targets)
    return [_os.path.join(out_dir, "targets", synth.target_name(t) + ".png")
            for t in range(n_targets)]


def bench_kernels(mask_rgb, targets, region):
    import jax

    from colormipsearch_tpu.ops import pixel_match

    plan = pixel_match.build_query_plan(
        mask_rgb, 20, mirror=True, xy_shift=2, pix_color_fluctuation=1.0,
        excluded_region=region)
    t0 = time.perf_counter()
    planes = build_planes(targets)
    print(f"# packed {N_TARGETS} targets ({planes.nbytes / 1e9:.1f} GB) "
          f"in {time.perf_counter() - t0:.1f}s", file=sys.stderr,
          flush=True)
    # the engine's production step: MASK_BATCH query plans per dispatch
    pos = jax.device_put(np.stack([plan.positions] * MASK_BATCH))
    q_cls = jax.device_put(np.stack([plan.q_cls] * MASK_BATCH))
    q_s = jax.device_put(np.stack([plan.q_s] * MASK_BATCH))
    q_p = jax.device_put(np.stack([plan.q_p] * MASK_BATCH))

    def run_once():
        return pixel_match.score_query_batch(
            planes, pos, q_cls, q_s, q_p,
            target_threshold=-1,  # folded into the pack above
            ztol_num=plan.ztol_num,
            ztol_den=plan.ztol_den, n_straight=plan.n_straight)

    t0 = time.perf_counter()
    jax.block_until_ready(run_once())
    print(f"# compiled in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    out = None
    for _ in range(N_MASK_REPEATS):
        out = run_once()
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    final = np.asarray(out[0])
    pairs = N_MASK_REPEATS * MASK_BATCH * N_TARGETS
    # sanity: scoring is live (the mask's source target scores > 0)
    assert int(final.max()) > 0
    v, q = plan.positions.shape
    gather_gb_s = (N_MASK_REPEATS * MASK_BATCH * v * q * N_TARGETS * 4
                   / dt / 1e9)

    # the rank-key kernels on the same workload; the packed planes are
    # released first so the two plane sets never coexist
    packed_max = int(final.max())
    del planes, out, final
    keys_rate, union_rate, full_union_rate, fu_gather_gb_s = \
        bench_kernels_keys(targets, plan, packed_max, mask_rgb, region)
    return (pairs / dt, gather_gb_s, keys_rate, union_rate,
            full_union_rate, fu_gather_gb_s, plan)


def _time_repeats(fn):
    """(seconds for N_MASK_REPEATS calls, last call's first output)."""
    import jax

    jax.block_until_ready(fn())  # compile + warm
    t0 = time.perf_counter()
    out = None
    for _ in range(N_MASK_REPEATS):
        out = fn()
    jax.block_until_ready(out)
    return time.perf_counter() - t0, np.asarray(out[0])


def bench_kernels_keys(targets, plan, packed_max: int,
                       mask_rgb, region) -> tuple[float, float, float, float]:
    import jax

    from colormipsearch_tpu.ops import pixel_match

    t_keys = build_planes(targets, kind="keys")
    h, w = mask_rgb.shape[:2]
    kplan = pixel_match.key_plan_from_query_plan(plan, h * w, 1.0)
    kpos = jax.device_put(np.stack([kplan.positions] * MASK_BATCH))
    klo = jax.device_put(np.stack([kplan.lo] * MASK_BATCH))
    kspan = jax.device_put(np.stack([kplan.span] * MASK_BATCH))
    dt, final = _time_repeats(lambda: pixel_match.score_query_batch_keys(
        t_keys, kpos, klo, kspan, n_straight=plan.n_straight))
    # the exact kernel must reproduce the packed kernel's top score
    # (this workload has no ambiguity flags)
    assert int(final.max()) == packed_max, (int(final.max()), packed_max)
    keys_rate = N_MASK_REPEATS * MASK_BATCH * N_TARGETS / dt

    # x-union lane form of the same kernel on the same key planes
    uplan = pixel_match.build_union_key_plan(
        mask_rgb, 20, mirror=True, xy_shift=2, pix_color_fluctuation=1.0,
        excluded_region=region)
    uargs = [jax.device_put(np.stack([a] * MASK_BATCH)) for a in (
        uplan.u_pos, uplan.mu_pos, uplan.lane_lo, uplan.lane_span)]
    dt, final = _time_repeats(
        lambda: pixel_match.score_query_batch_union_keys(t_keys, *uargs))
    assert int(final.max()) == packed_max, (int(final.max()), packed_max)
    union_rate = N_MASK_REPEATS * MASK_BATCH * N_TARGETS / dt

    # full (x+y) union form, the engine default: one gathered row set
    # per orientation, lane tables expanded on device from the factored
    # qkey wire form once per batch
    fplan = pixel_match.build_full_union_key_plan(
        mask_rgb, 20, mirror=True, xy_shift=2, pix_color_fluctuation=1.0,
        excluded_region=region)
    if fplan.qidx is not None:
        u_pos_s, mu_pos_s, qidx_s, kl_s, fu2 = \
            pixel_match.stack_union_qkey_args([fplan] * MASK_BATCH, h * w)
        tabs = pixel_match.interval_table_arrays(1.0 / 100.0)
        f_lo, f_span = pixel_match.expand_union_tables(
            jax.device_put(qidx_s), jax.device_put(kl_s),
            jax.device_put(tabs[0]), jax.device_put(tabs[1]))
        fargs = (jax.device_put(u_pos_s), jax.device_put(mu_pos_s),
                 f_lo, f_span)
    else:
        fu2 = fplan.u2 if fplan.u2 >= 0 else None
        fargs = [jax.device_put(np.stack([a] * MASK_BATCH)) for a in (
            fplan.u_pos, fplan.mu_pos, fplan.lane_lo, fplan.lane_span)]
    dt, final = _time_repeats(
        lambda: pixel_match.score_query_batch_union_keys(
            t_keys, *fargs, u2=fu2))
    assert int(final.max()) == packed_max, (int(final.max()), packed_max)
    full_union_rate = N_MASK_REPEATS * MASK_BATCH * N_TARGETS / dt
    fu_rows = fplan.u_pos.size + fplan.mu_pos.size
    fu_gather_gb_s = (N_MASK_REPEATS * MASK_BATCH * fu_rows * N_TARGETS
                      * 4 / dt / 1e9)
    return keys_rate, union_rate, full_union_rate, fu_gather_gb_s


def bench_shape(mask_rgb, region):
    """Shape (gradient-area-gap) pass rate: one mask vs SHAPE_TARGETS
    synthesized targets, both orientations (the production mirror
    config), through the engine's split support-row form: gap rows
    (query non-black, grad|slice words) and he rows (r=60 ring, one
    foreground byte) scored by dedicated kernels
    (ops/shape_score.pack_target_rows_split)."""
    import jax
    import jax.numpy as jnp

    from colormipsearch_tpu.ops import shape_score

    q_pack = shape_score.pack_query(mask_rgb, excluded_region=region)
    pos_gap, pos_he = shape_score.support_split(q_pack)
    n_gap = shape_score.support_bucket(pos_gap.size, minimum=1024)
    n_he = shape_score.he_words(pos_he.size)
    qg, qh = shape_score.sparse_query_split(q_pack, pos_gap, n_gap,
                                            pos_he, n_he)
    q_gap = jnp.asarray(np.stack([qg, qg]))
    q_he = jnp.asarray(np.stack([qh, qh]))

    # packed support rows synthesized on device at realistic field
    # sparsity (the kernel's inputs, without a host decode/pack pass)
    @jax.jit
    def make(key):
        k1, k2, k3 = jax.random.split(key, 3)
        gshape = (2, n_gap, SHAPE_TARGETS)
        grad = jax.random.randint(k1, gshape, 0, 1 << 16)
        sl = jax.random.randint(k2, gshape, 0, 257)
        word = (grad | (sl << 16)).astype(jnp.uint32)
        t_gap = jnp.where(
            (jnp.arange(n_gap) < pos_gap.size)[None, :, None],
            word, jnp.uint32(0))
        # bitpacked ring-row fg: AND of 4 uniform words gives ~6.25%
        # bit density, matching realistic CDM foreground
        hshape = (2, n_he, SHAPE_TARGETS)
        bits = jax.random.bits(k3, (4,) + hshape, jnp.uint32)
        t_he = jnp.where(
            (jnp.arange(n_he) * 32 < pos_he.size)[None, :, None],
            bits[0] & bits[1] & bits[2] & bits[3], jnp.uint32(0))
        return t_gap, t_he

    t_gap, t_he = jax.block_until_ready(make(jax.random.PRNGKey(0)))

    def run_once():
        # mirror config: both orientations, both row classes, 1 dispatch
        return shape_score.shape_score_pairs_split(t_gap, q_gap,
                                                   t_he, q_he)

    jax.block_until_ready(run_once())  # compile + warm
    t0 = time.perf_counter()
    out = None
    for _ in range(SHAPE_REPEATS):
        out = run_once()
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return SHAPE_REPEATS * SHAPE_TARGETS / dt


# ---------------------------------------------------------------------------
# end-to-end (decode-inclusive) benchmarks: production-shaped ON-DISK
# workloads driven through the REAL CLI paths — what the reference's
# grid envelope actually measures (cdsparams.sh job sizing;
# cmd/ColorDepthSearchCmd.java:195-340).  The kernel benches above
# start from device-resident planes; these include decode, the
# host->device upload and the result writes, and report the split.
# ---------------------------------------------------------------------------

E2E_CDS_MASKS = int(_os.environ.get("CDS_BENCH_E2E_MASKS", 16))
E2E_CDS_TARGETS = int(_os.environ.get("CDS_BENCH_E2E_TARGETS", 96))
E2E_SHAPE_TARGETS = int(_os.environ.get("CDS_BENCH_E2E_SHAPE_TARGETS", 2048))


def _run_cli(argv) -> None:
    from colormipsearch_tpu.cli.main import main as cli_main

    rc = cli_main([str(a) for a in argv])
    assert rc == 0, f"CLI failed ({rc}): {argv}"


def _data_inputs(tmp, masks_dir, targets_dir, label):
    for d, name in ((masks_dir, "m"), (targets_dir, "t")):
        _run_cli(["createColorDepthSearchDataInput", "-i", d,
                  "-l", f"{label}-{name}", "-od", tmp,
                  "--output-filename", f"{name}.json"])


def bench_e2e_cds():
    """colorDepthSearch end to end: on-disk PNGs -> data-input -> decode
    -> query plans -> device scoring -> streaming grouped JSON writes,
    timed as one CLI run.  Returns (pairs/s, split dict)."""
    import jax

    from colormipsearch_tpu import synth
    from colormipsearch_tpu.io import native_decoder
    from colormipsearch_tpu.ops import pixel_match

    with _scratch_dir() as tmp:
        masks_dir = _os.path.join(tmp, "masks")
        targets_dir = _os.path.join(tmp, "targets")
        t0 = time.perf_counter()
        tpaths = write_library(tmp, E2E_CDS_MASKS, E2E_CDS_TARGETS,
                               seed=SEED + 1)
        synth_s = time.perf_counter() - t0

        # split term 1: host decode rate (native batch decoder, the
        # engine's decode pool path)
        blobs = [open(p, "rb").read() for p in tpaths]
        h, w = synth.HEIGHT, synth.WIDTH
        t0 = time.perf_counter()
        _, ok = native_decoder.decode_img_batch(blobs, width=w, height=h,
                                                channels=3)
        decode_s = time.perf_counter() - t0
        assert ok.all()

        # split term 2: host->device upload of a target stack
        stack = np.zeros((min(8, E2E_CDS_TARGETS), h, w, 3), np.uint8)
        jax.block_until_ready(jax.device_put(stack))  # warm
        t0 = time.perf_counter()
        jax.block_until_ready(jax.device_put(stack))
        sample_s = time.perf_counter() - t0
        upload_s_est = sample_s * E2E_CDS_TARGETS / stack.shape[0]

        # split term 3: query-plan build (once per mask on the host;
        # the first build also constructs the process-wide cached
        # key-interval table — reported separately)
        mask_rgb = synth.mask_image(
            SEED + 1, synth.mask_spec(SEED + 1, 0, E2E_CDS_TARGETS))
        t0 = time.perf_counter()
        pixel_match.build_full_union_key_plan(
            mask_rgb, 20, mirror=True, xy_shift=2,
            pix_color_fluctuation=1.0)
        plan_cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(4):
            pixel_match.build_full_union_key_plan(
                mask_rgb, 20, mirror=True, xy_shift=2,
                pix_color_fluctuation=1.0)
        plan_s = (time.perf_counter() - t0) / 4

        _data_inputs(tmp, masks_dir, targets_dir, "e2e")
        out = _os.path.join(tmp, "results")
        t0 = time.perf_counter()
        _run_cli(["colorDepthSearch",
                  "-m", _os.path.join(tmp, "m.json"),
                  "-i", _os.path.join(tmp, "t.json"),
                  "--maskThreshold", 20, "--dataThreshold", 20,
                  "--pixColorFluctuation", 1.0, "--xyShift", 2,
                  "--mirrorMask", "-od", out, "--perMaskSubdir", "pm"])
        wall = time.perf_counter() - t0
        # zero-match masks write no file; every mask is cut from one of
        # the targets, so every mask writes one
        n_files = len(_os.listdir(_os.path.join(out, "pm")))
        assert n_files == E2E_CDS_MASKS, (n_files, E2E_CDS_MASKS)
        pairs = E2E_CDS_MASKS * E2E_CDS_TARGETS
        split = {
            "masks": E2E_CDS_MASKS, "targets": E2E_CDS_TARGETS,
            "wall_s": wall,
            "decode_targets_per_s": E2E_CDS_TARGETS / decode_s,
            "plan_build_s_per_mask": plan_s,
            "plan_table_init_s": plan_cold_s - plan_s,
            "upload_s_est": upload_s_est,
            "upload_gb_per_s": stack.nbytes / sample_s / 1e9,
            "upload_share": upload_s_est / wall,
            "synth_s": synth_s,
        }
        return pairs / wall, split


def _write_shape_triplets(root: str, n_masks: int, n: int, *, seed: int,
                          zgap_every: int) -> list[str]:
    """The synthetic library under ``root`` plus each target's gradient
    and z-gap variants beside it.  Every target decodes its own variant
    files (the cost being measured), but identical content is ENCODED
    once and byte-copied: one random gradient for all, one z-gap
    dilation per ``zgap_every`` targets.  Returns the target paths."""
    from colormipsearch_tpu import synth
    from colormipsearch_tpu.io.image import read_image
    from colormipsearch_tpu.io.png import encode_png
    from colormipsearch_tpu.oracle.shape import dilate_rgb, mask_rgb as mfn

    tpaths = write_library(root, n_masks, n, seed=seed)
    rng = np.random.default_rng(seed)
    grad_bytes = encode_png(rng.integers(
        0, 400, (synth.HEIGHT, synth.WIDTH)).astype(np.uint16))
    zg_bytes = None
    for i, p in enumerate(tpaths):
        stem = p[:-4]
        with open(stem + "_grad.png", "wb") as f:
            f.write(grad_bytes)
        if i % zgap_every == 0:
            zg_bytes = encode_png(
                dilate_rgb(mfn(read_image(p).as_rgb(), 20), 20))
        with open(stem + "_zgap.png", "wb") as f:
            f.write(zg_bytes)
    return tpaths


def _target_neuron(name: str, path: str):
    from colormipsearch_tpu.model import ComputeFileType, FileData, Neuron

    t_n = Neuron(mip_id=name, published_name=name)
    t_n.set_compute_file(ComputeFileType.InputColorDepthImage,
                         FileData(path))
    t_n.set_compute_file(ComputeFileType.GradientImage,
                         FileData(path[:-4] + "_grad.png"))
    t_n.set_compute_file(ComputeFileType.ZGapImage,
                         FileData(path[:-4] + "_zgap.png"))
    return t_n


def bench_e2e_shape(mask_rgb, region):
    """gradientScores end to end: on-disk CDM+gradient+zgap triplets ->
    matches file -> decode/gather -> split shape kernel -> rewritten
    grouped JSON, as one CLI run.  Two passes: decode-inclusive (builds
    the packed-variant store behind) and store-hit (the decode-once
    production configuration).  Returns (hit_rate, build_rate, split)."""
    from colormipsearch_tpu import synth
    from colormipsearch_tpu.dataio.json_io import JSONMatchesWriter
    from colormipsearch_tpu.io.png import write_png
    from colormipsearch_tpu.model import (
        CDMatch,
        ComputeFileType,
        FileData,
        Neuron,
    )

    with _scratch_dir() as tmp:
        mask_path = _os.path.join(tmp, "mask.png")
        write_png(mask_path, mask_rgb)
        t0 = time.perf_counter()
        tpaths = _write_shape_triplets(_os.path.join(tmp, "lib"), 0,
                                       E2E_SHAPE_TARGETS, seed=SEED + 3,
                                       zgap_every=64)
        synth_s = time.perf_counter() - t0

        mask_n = Neuron(mip_id="e2e-mask", published_name="e2e-mask")
        mask_n.set_compute_file(ComputeFileType.InputColorDepthImage,
                                FileData(mask_path))
        matches = [CDMatch(mask_image=mask_n,
                           matched_image=_target_neuron(f"s{i:05d}", p),
                           matching_pixels=100,
                           matching_pixels_ratio=0.05)
                   for i, p in enumerate(tpaths)]
        mdir = _os.path.join(tmp, "matches")
        writer = JSONMatchesWriter(per_masks_dir=mdir)
        writer.write(matches)
        writer.close()

        store = _os.path.join(tmp, "pack")
        rates = []
        for i in range(2):
            t0 = time.perf_counter()
            _run_cli(["gradientScores", "--matches", mdir,
                      "-od", _os.path.join(tmp, f"out{i}"),
                      "--maskThreshold", 20, "--mirrorMask",
                      "--packed-variants-store", store])
            rates.append(E2E_SHAPE_TARGETS / (time.perf_counter() - t0))
        print(f"# e2e shape: synth {synth_s:.1f}s, build "
              f"{rates[0]:.1f}/s, store-hit {rates[1]:.1f}/s",
              file=sys.stderr, flush=True)

        # split terms: the per-mask query pack (r=60/r=20 dilations),
        # the store's host-side tile gather rate, and the dispatch
        # plane upload
        import jax

        from colormipsearch_tpu.io.shape_pack import ShapePackStore
        from colormipsearch_tpu.ops import shape_score

        h, w = synth.HEIGHT, synth.WIDTH
        t0 = time.perf_counter()
        q_pack = shape_score.pack_query(mask_rgb, excluded_region=region)
        qpack_s = time.perf_counter() - t0
        pos_gap, pos_he = shape_score.support_split(q_pack)
        n_gap = shape_score.support_bucket(pos_gap.size, minimum=1024)
        n_he = shape_score.he_words(pos_he.size)
        st = ShapePackStore(store, h, w)
        gplan = shape_score.split_gather_plan(
            pos_gap, pos_he, w, mirror=True, excluded=region)
        rows = list(range(len(st)))
        t0 = time.perf_counter()
        t_gap, t_he = shape_score.select_target_tile_from_store(
            st, rows, pos_gap, n_gap, n_he, gplan, mirror=True)
        gather_s = time.perf_counter() - t0
        plane_mb = (t_gap.nbytes + t_he.nbytes) / 1e6
        buf = np.zeros(4 << 20, np.uint8)
        jax.block_until_ready(jax.device_put(buf))  # warm
        t0 = time.perf_counter()
        jax.block_until_ready(jax.device_put(buf))
        up_gb_s = buf.nbytes / (time.perf_counter() - t0) / 1e9
        split = {
            "targets": E2E_SHAPE_TARGETS,
            "query_pack_s_per_mask": qpack_s,
            "store_gather_targets_per_s": len(rows) / gather_s,
            "dispatch_plane_mb": plane_mb,
            "upload_s_est": plane_mb / 1e3 / up_gb_s,
            "synth_s": synth_s,
        }
        return rates[1], rates[0], split


# ---------------------------------------------------------------------------
# gradientScores production dress rehearsal: the REAL gradientScores CLI
# over M masks x T packed-store targets — the production access pattern
# (CalculateGradientScoresCmd.java:124-222 iterates mask partitions of
# 100-200 mask files, cdsparams.sh:56-66) — A/B: host tile pack vs the
# device-resident store (CDS_SHAPE_STORE_DEVICE=1), reporting targets/s,
# per-mask wire bytes, and the stage split.
# ---------------------------------------------------------------------------

GRAD_DRESS_MASKS = int(_os.environ.get("CDS_BENCH_GRAD_DRESS_MASKS", 128))
GRAD_DRESS_TARGETS = int(_os.environ.get(
    "CDS_BENCH_GRAD_DRESS_TARGETS", 2048))
# the host-pack arm runs a subset of the masks to bound the run's time
# and reports a per-mask-linear extrapolation to all of them
GRAD_DRESS_HOST_MASKS = int(_os.environ.get(
    "CDS_BENCH_GRAD_DRESS_HOST_MASKS", 32))


def bench_e2e_gradscore_dress():
    """dict with A/B walls, rates, per-mask wire bytes, stage splits."""
    import gc

    import jax

    from colormipsearch_tpu.dataio.json_io import JSONMatchesWriter
    from colormipsearch_tpu.model import (
        CDMatch,
        ComputeFileType,
        FileData,
        Neuron,
    )
    from colormipsearch_tpu.utils.metrics import GLOBAL

    # earlier sections must not pin device memory next to the ~GB-scale
    # device-store fields
    gc.collect()
    for a in [a for a in jax.live_arrays() if a.nbytes > (64 << 20)]:
        a.delete()
    gc.collect()

    m_count, t_count = GRAD_DRESS_MASKS, GRAD_DRESS_TARGETS
    with _scratch_dir() as tmp:
        # --- target triplets (CDM + grad + zgap), byte-copied encodes,
        # and M distinct masks (each with its own support set and
        # gather plan)
        from colormipsearch_tpu import synth

        lib = _os.path.join(tmp, "lib")
        t0 = time.perf_counter()
        tpaths = _write_shape_triplets(lib, m_count, t_count,
                                       seed=SEED + 21, zgap_every=256)
        mpaths = [_os.path.join(lib, "masks", synth.mask_name(m) + ".png")
                  for m in range(m_count)]
        synth_s = time.perf_counter() - t0

        # --- per-mask grouped matches files: every mask rescores the
        # full T-target store (the "top lines" of a production mask)
        t0 = time.perf_counter()
        t_neurons = [_target_neuron(f"t{i:05d}", p)
                     for i, p in enumerate(tpaths)]
        mdir = _os.path.join(tmp, "matches")
        writer = JSONMatchesWriter(per_masks_dir=mdir, pretty=False)
        for i, p in enumerate(mpaths):
            m_n = Neuron(mip_id=f"m{i:04d}", published_name=f"m{i:04d}")
            m_n.set_compute_file(ComputeFileType.InputColorDepthImage,
                                 FileData(p))
            writer.write([CDMatch(mask_image=m_n, matched_image=t_n,
                                  matching_pixels=100,
                                  matching_pixels_ratio=0.05)
                          for t_n in t_neurons])
        writer.close()
        matches_s = time.perf_counter() - t0

        store = _os.path.join(tmp, "pack")
        mask_files = sorted(_os.listdir(mdir))
        gs_keys = ("gs.queryPack.seconds", "gs.storeGather.seconds",
                   "gs.deviceTileBuild.seconds", "gs.dispatch.seconds",
                   "gs.wireBytes", "gs.storeUpload.seconds",
                   "gs.storeUploadBytes")

        def run_pass(name, files, out, device_store: bool):
            before = {k: GLOBAL.get(k) for k in gs_keys}
            # pin explicitly: the CLI auto-enables the device store
            # above a mask-count threshold, and the host arm must stay
            # the host arm
            _os.environ["CDS_SHAPE_STORE_DEVICE"] = \
                "1" if device_store else "0"
            try:
                t0 = time.perf_counter()
                _run_cli(["gradientScores", "--matches",
                          *[_os.path.join(mdir, f) for f in files],
                          "-od", out, "--maskThreshold", 20,
                          "--mirrorMask",
                          "--packed-variants-store", store])
                wall = time.perf_counter() - t0
            finally:
                _os.environ.pop("CDS_SHAPE_STORE_DEVICE", None)
            st = {k.split(".")[1]: GLOBAL.get(k) - before[k]
                  for k in gs_keys}
            print(f"# gradscore dress {name}: {wall:.1f}s "
                  f"({len(files) * t_count / wall:.0f} targets/s)",
                  file=sys.stderr, flush=True)
            return wall, st

        # store BUILD pass (decode-inclusive): one mask populates all
        # T rows — after this, every pass is store-hit, the production
        # decode-once state
        build_wall, _build_st = run_pass("store-build", mask_files[:1],
                                         _os.path.join(tmp, "out_b"),
                                         False)
        ab_files = mask_files[1:]
        m_dev = len(ab_files)
        wall_dev, st_dev = run_pass("device-store", ab_files,
                                    _os.path.join(tmp, "out_d"), True)
        host_files = ab_files[:GRAD_DRESS_HOST_MASKS]
        m_host = len(host_files)
        wall_host, st_host = run_pass("host-pack", host_files,
                                      _os.path.join(tmp, "out_a"), False)

        # consistency: both passes produced identical scores on the
        # host arm's masks
        mismatched = 0
        for fn in sorted(_os.listdir(_os.path.join(tmp, "out_a"))):
            docs = [json.load(open(_os.path.join(tmp, d, fn)))
                    for d in ("out_a", "out_d")]
            keys = [sorted((r["image"]["mipId"], r.get("gradientAreaGap"),
                            r.get("highExpressionArea"))
                           for r in doc["results"]) for doc in docs]
            mismatched += keys[0] != keys[1]
        assert mismatched == 0, "host vs device-store scores differ"

        host_wire_per_mask = st_host["wireBytes"] / max(m_host, 1)
        dev_fixed = st_dev["storeUploadBytes"]
        dev_wire_per_mask = st_dev["wireBytes"] / max(m_dev, 1)
        host_wall_extrap = wall_host * m_dev / max(m_host, 1)
        return {
            "masks": m_dev, "targets_per_mask": t_count,
            "store_build_wall_s": build_wall,
            "host_pack": {
                "masks_run": m_host,
                "wall_s": wall_host,
                "targets_per_s": m_host * t_count / wall_host,
                "wall_extrapolated_to_all_masks_s": host_wall_extrap,
                "wire_mb_per_mask": host_wire_per_mask / 1e6,
                "split": st_host,
            },
            "device_store": {
                "masks_run": m_dev,
                "wall_s": wall_dev,
                "targets_per_s": m_dev * t_count / wall_dev,
                "wire_kb_per_mask": dev_wire_per_mask / 1e3,
                "store_upload_gb": dev_fixed / 1e9,
                "split": st_dev,
            },
            "speedup_device_over_host": host_wall_extrap / wall_dev,
            "synth_s": synth_s + matches_s,
        }


# ---------------------------------------------------------------------------
# production dress rehearsal: the REAL colorDepthSearch CLI at amortized
# shape — T on-disk targets decoded + uploaded ONCE, reused across M
# on-disk masks (the production access pattern; cdsparams.sh runs
# 44,593 x 7,391).  Reports e2e pairs/s plus the in-run stage split
# (engine stage timers) and a projection to the full production run.
# ---------------------------------------------------------------------------

DRESS_MASKS = int(_os.environ.get("CDS_BENCH_DRESS_MASKS", 8192))
DRESS_TARGETS = int(_os.environ.get("CDS_BENCH_DRESS_TARGETS", 4096))


def bench_dress_rehearsal():
    """(pairs_per_s, split dict) of the production-shaped CLI run."""
    import gc

    import jax

    from colormipsearch_tpu.utils.metrics import GLOBAL

    # earlier sections must not pin device memory into the dress
    gc.collect()
    for a in [a for a in jax.live_arrays() if a.nbytes > (64 << 20)]:
        a.delete()
    gc.collect()

    m, t = DRESS_MASKS, DRESS_TARGETS
    with _scratch_dir() as tmp:
        masks_dir = _os.path.join(tmp, "masks")
        targets_dir = _os.path.join(tmp, "targets")
        t0 = time.perf_counter()
        write_library(tmp, m, t, seed=SEED + 11)
        synth_s = time.perf_counter() - t0
        _data_inputs(tmp, masks_dir, targets_dir, "dress")
        # wide dispatches amortize per-batch round trips at this mask
        # count (engine reads the env at construction)
        _os.environ.setdefault("CDS_MASK_BATCH", "256")
        out = _os.path.join(tmp, "results")
        stages = ("cds.prepMasks.seconds", "cds.decodeTargets.seconds",
                  "cds.packUpload.seconds", "cds.scoreAllPairs.seconds",
                  "cds.planArgs.seconds", "cds.dispatch.seconds",
                  "cds.emit.seconds", "cds.packSelect.seconds",
                  "cds.packScatter.seconds")
        before = {s: GLOBAL.get(s) for s in stages}
        t0 = time.perf_counter()
        _run_cli(["colorDepthSearch",
                  "-m", _os.path.join(tmp, "m.json"),
                  "-i", _os.path.join(tmp, "t.json"),
                  "--maskThreshold", 20, "--dataThreshold", 20,
                  "--pixColorFluctuation", 1.0, "--xyShift", 2,
                  "--mirrorMask", "--pctPositivePixels", 1.0,
                  "-od", out, "--perMaskSubdir", "pm"])
        wall = time.perf_counter() - t0
        st = {s.split(".")[1]: GLOBAL.get(s) - before[s] for s in stages}
        assert _os.listdir(_os.path.join(out, "pm")), \
            "no result files written"
        pairs = m * t
        decode_upload = st["decodeTargets"] + st["packUpload"]
        # projection to the production 44,593 x 7,391 run on THIS host:
        # mask prep streams into shard-0 scoring and shard i+1
        # decode+upload overlaps shard-i scoring, so the projection is
        # the max of the scaled components, not their sum.  The device
        # term scales by pairs at the in-run dispatch+emit rate.
        dev_serial_s = max(st["dispatch"] + st["emit"], 1e-9)
        device_rate = pairs / dev_serial_s
        pm, pt = 44593, 7391
        comp_prep = st["prepMasks"] * pm / m
        comp_du = decode_upload * pt / t
        comp_score = pm * pt / device_rate
        split = {
            "masks": m, "targets": t, "wall_s": wall, **st,
            "decode_upload_share": decode_upload / wall,
            "device_score_pairs_per_s": device_rate,
            "synth_s": synth_s,
            "production_44593x7391_projection_s":
                max(comp_prep, comp_du, comp_score),
            "projection_components_s": {
                "prep": comp_prep, "decode_upload": comp_du,
                "score": comp_score},
        }
        return pairs / wall, split


def bench_oracle_baseline(mask_rgb, targets, region):
    """Single-core positions-only scorer emulating the reference's access
    pattern (PixelMatchColorDepthSearchAlgorithm.calculateScore:235-263:
    only query positions are touched, no full-image precompute), but
    vectorized with numpy — i.e. an upper bound on the Java scalar loop's
    per-core speed.  Scaled by the production node concurrency."""
    from colormipsearch_tpu.oracle.pixel import (
        PixelMatchOracle,
        classify_rgb,
        pixel_gap,
        ratio_f64,
    )

    oracle = PixelMatchOracle(mask_rgb, 20, mirror=True, target_threshold=20,
                              z_tolerance=0.01, xy_shift=2,
                              excluded_region=region)
    variants = np.concatenate([oracle.variants, oracle.mirror_variants])

    def score_one(target):
        flat = target.reshape(-1, 3)
        best = 0
        for pos in variants:
            ok = pos >= 0
            tp = pos[ok]
            px = flat[tp]
            sel = px.astype(np.int32).max(axis=-1) > 20
            if not sel.any():
                continue
            cls, s, p = classify_rgb(px[sel])
            r = ratio_f64(cls, s, p)
            gaps = pixel_gap(oracle.q_cls[ok][sel], oracle.q_ratio[ok][sel],
                             cls, r)
            best = max(best, int(np.count_nonzero(gaps <= 0.01)))
        return best

    t0 = time.perf_counter()
    for t in targets:
        score_one(t)
    dt = time.perf_counter() - t0
    single_core = len(targets) / dt
    return single_core * REFERENCE_NODE_THREADS


def main() -> int:
    from colormipsearch_tpu.utils import caches

    device = device_info()
    caches.enable_compilation_cache()
    mask_rgb, targets, host_sample, region = build_workload()
    (packed_rate, gather_gb_s, keys_rate, union_rate, full_union_rate,
     fu_gather_gb_s, plan) = bench_kernels(mask_rgb, targets, region)
    del targets
    shape_rate = bench_shape(mask_rgb, region)
    baseline_rate = bench_oracle_baseline(mask_rgb, host_sample, region)
    extra = {
        "full_union_gather_gb_per_s": fu_gather_gb_s,
        "packed_pairs_per_s": packed_rate,
        "packed_unit": "packed-plane kernel (banded-f32 predicate + "
                       f"oracle fallback, {plan.n_variants} shift "
                       "variants; docs/DESIGN.md §2)",
        "packed_gather_gb_per_s": gather_gb_s,
        "packed_gather_pct_of_hbm_peak":
            100 * gather_gb_s / HBM_PEAK_GB_S[device["kind"]],
        "keys_pairs_per_s": keys_rate,
        "keys_unit": "classic rank-key interval kernel (docs/DESIGN.md "
                     "§2.4) on the same workload",
        "union_keys_pairs_per_s": union_rate,
        "union_keys_unit": "x-union lane form of the key kernel (0.5x "
                           "gather rows)",
        "shape_pairs_per_s": shape_rate,
        "shape_unit": "shape-rescored mask-target pairs/s (mirror "
                      f"config, T={SHAPE_TARGETS})",
    }
    if _os.environ.get("CDS_BENCH_E2E", "1") != "0":
        rate, split = bench_e2e_cds()
        extra["e2e_cds_pairs_per_s"] = rate
        extra["e2e_cds_unit"] = (
            "decode-inclusive colorDepthSearch CLI run (on-disk PNGs -> "
            f"grouped JSON writes, {E2E_CDS_MASKS} masks x "
            f"{E2E_CDS_TARGETS} targets)")
        extra["e2e_cds_split"] = split
        hit, build, split = bench_e2e_shape(mask_rgb, region)
        extra["e2e_shape_targets_per_s"] = hit
        extra["e2e_shape_unit"] = (
            f"decode-once gradientScores CLI run ({E2E_SHAPE_TARGETS} "
            "on-disk targets, packed-variant store hit pass; build pass "
            "= decode-inclusive)")
        extra["e2e_shape_build_targets_per_s"] = build
        extra["e2e_shape_split"] = split
    if _os.environ.get("CDS_BENCH_DRESS", "1") != "0":
        rate, split = bench_dress_rehearsal()
        extra["e2e_dress_pairs_per_s"] = rate
        extra["e2e_dress_unit"] = (
            f"production-shaped colorDepthSearch CLI ({DRESS_MASKS} "
            f"on-disk masks x {DRESS_TARGETS} on-disk targets, "
            "decode+upload amortized)")
        extra["e2e_dress_split"] = split
    if _os.environ.get("CDS_BENCH_GRAD_DRESS", "1") != "0":
        extra["e2e_gradscore_dress"] = bench_e2e_gradscore_dress()
    print(json.dumps({
        "metric": "cds_pair_comparisons_per_sec_per_card",
        # headline = the engine's production-default kernel: the full
        # (x+y) union form of the rank-key interval kernel
        "value": full_union_rate,
        "unit": "mask-target pairs/s (prod params: thr 20/20, xyShift 2, "
                f"mirror, {plan.query_size}-px query, T={N_TARGETS} "
                "shard; full-union rank-key kernel, the engine default)",
        "vs_baseline": full_union_rate / baseline_rate,
        "device": device,
        "extra": extra,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

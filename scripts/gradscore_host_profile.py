"""Host-side profile of the gradientScores decode+pack pipeline.

End-to-end gradientScores throughput is bounded by the HOST work:
decoding each target's CDM (RGB), GradientImage (16-bit) and
ZGapImage (RGB) and packing the support rows
(ops/shape_score.pack_target_rows_split).  This script synthesizes a
realistic on-disk workload (production 1210x566 CDMs, ~6% foreground,
PackBits TIFF CDM + uncompressed 16-bit grad TIFF + PNG zgap, the
production variant formats) and times each stage on CPU — no
accelerator needed.

    python scripts/gradscore_host_profile.py [--targets N] [--workers K]
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H, W = 566, 1210


def synthesize(tmp: str, n: int):
    """Write n targets' (cdm.tif, grad.tif, zgap.png) to tmp."""
    from PIL import Image

    rng = np.random.default_rng(0)
    fg_frac = 0.06
    paths = []
    base_fg = rng.random((H, W)) < fg_frac
    base_rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    base_grad = rng.integers(0, 1 << 16, (H, W), dtype=np.uint16)
    for i in range(n):
        # roll the shared base per target: realistic content, cheap synth
        fg = np.roll(base_fg, (i * 7) % H, axis=0)
        rgb = np.where(fg[..., None], np.roll(base_rgb, i, axis=1), 0)
        grad = np.roll(base_grad, i, axis=1)
        zgap = np.where(np.roll(fg, 3, axis=1)[..., None],
                        np.roll(base_rgb, i + 1, axis=1), 0)
        cdm = os.path.join(tmp, f"t{i:04d}_cdm.tif")
        gp = os.path.join(tmp, f"t{i:04d}_grad.tif")
        zp = os.path.join(tmp, f"t{i:04d}_zgap.png")
        Image.fromarray(rgb).save(cdm, compression="packbits")
        Image.fromarray(grad, mode="I;16").save(gp)
        Image.fromarray(zgap.astype(np.uint8)).save(zp)
        paths.append((cdm, gp, zp))
    return paths


def run_e2e(paths, mask_path, pack_store=None) -> float:
    """End-to-end GradScoreEngine rate (targets/s) on the synthesized
    on-disk workload: decode + select + assemble + device dispatch with
    the production prefetch pipeline.  Run under JAX_PLATFORMS=cpu to
    measure the HOST pipeline (the CPU 'device' kernel is not the GPU
    one, but the host side is identical)."""
    import time

    from colormipsearch_tpu.engine.cds import CDSParams
    from colormipsearch_tpu.engine.gradscore import GradScoreEngine
    from colormipsearch_tpu.model import (
        CDMatch, ComputeFileType, FileData, Neuron)

    mask_n = Neuron(mip_id="mask", published_name="mask")
    mask_n.set_compute_file(ComputeFileType.InputColorDepthImage,
                            FileData(mask_path))
    matches = []
    for i, (cdm, gp, zp) in enumerate(paths):
        t_n = Neuron(mip_id=f"t{i:04d}", published_name=f"t{i:04d}")
        t_n.set_compute_file(ComputeFileType.InputColorDepthImage,
                             FileData(cdm))
        t_n.set_compute_file(ComputeFileType.GradientImage, FileData(gp))
        t_n.set_compute_file(ComputeFileType.ZGapImage, FileData(zp))
        matches.append(CDMatch(mask_image=mask_n, matched_image=t_n,
                               matching_pixels=100))
    params = CDSParams(mask_threshold=20, data_threshold=20,
                       pix_color_fluctuation=1.0, xy_shift=2,
                       mirror_mask=True)
    eng = GradScoreEngine(params, use_mesh=False, pack_store=pack_store)
    t0 = time.perf_counter()
    scored = eng.score_matches(matches)
    dt = time.perf_counter() - t0
    assert len(scored) == len(matches), (len(scored), len(matches))
    return len(matches) / dt


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--targets", type=int, default=96)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    from colormipsearch_tpu.io.image import read_image
    from colormipsearch_tpu.io import native_decoder
    from colormipsearch_tpu.oracle.pixel import label_regions_mask
    from colormipsearch_tpu.ops import shape_score

    print(f"# native decoder available: {native_decoder.available()}")

    fix = ("/root/reference/colormipsearch-api/src/test/resources/"
           "colormipsearch/api/cdsearch")
    mask_rgb = read_image(
        f"{fix}/1752016801-LPLC2-RT_18U.tif").as_rgb()
    region = label_regions_mask(W, H)
    q_pack = shape_score.pack_query(mask_rgb, excluded_region=region)
    pos_gap, pos_he = shape_score.support_split(q_pack)
    n_gap = shape_score.support_bucket(pos_gap.size, minimum=1024)
    n_he = shape_score.he_words(pos_he.size)
    print(f"# support: {pos_gap.size} gap rows (pad {n_gap}), "
          f"{pos_he.size} he rows ({n_he} words)")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = synthesize(tmp, args.targets)
        print(f"# synthesized {args.targets} target triplets in "
              f"{time.perf_counter() - t0:.1f}s")

        # stage 1: raw file read
        t0 = time.perf_counter()
        blobs = []
        for c, g, z in paths:
            blobs.append(tuple(open(p, "rb").read() for p in (c, g, z)))
        dt_read = time.perf_counter() - t0

        # stage 2: decode (single thread, the per-file read_image path)
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            decoded = []
            for cb, gb, zb in blobs:
                t_rgb = read_image(cb).as_rgb()
                grad = read_image(gb).pixels.astype(np.uint16)
                zgap = read_image(zb).as_rgb()
                decoded.append((t_rgb, grad, zgap))
            dt_dec = time.perf_counter() - t0

        # stage 2b: decode via the native batch API (all cores)
        cdm_blobs = [b[0] for b in blobs]
        zgap_blobs = [b[2] for b in blobs]
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            arena_c, ok_c = native_decoder.decode_img_batch(
                cdm_blobs, width=W, height=H, channels=3)
            arena_z, ok_z = native_decoder.decode_img_batch(
                zgap_blobs, width=W, height=H, channels=3)
            dt_dec_batch = time.perf_counter() - t0
        assert ok_c.all() and ok_z.all()

        # stage 3: pack (single thread)
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            t_gap, t_he = shape_score.pack_target_rows_split(
                [d[0] for d in decoded], [d[1] for d in decoded],
                [d[2] for d in decoded], pos_gap, n_gap, pos_he, n_he,
                mask_threshold=20, excluded=region, mirror=True)
            dt_pack = time.perf_counter() - t0

        n = args.targets
        print(f"read:        {1e3 * dt_read / n:7.2f} ms/target "
              f"({n / dt_read:8.1f}/s)")
        print(f"decode:      {1e3 * dt_dec / n:7.2f} ms/target "
              f"({n / dt_dec:8.1f}/s)  [1 thread, 3 files]")
        print(f"decode-batch:{1e3 * dt_dec_batch / n:7.2f} ms/target "
              f"({n / dt_dec_batch:8.1f}/s)  [all cores, cdm+zgap]")
        print(f"pack:        {1e3 * dt_pack / n:7.2f} ms/target "
              f"({n / dt_pack:8.1f}/s)  [1 thread]")
        per_worker = dt_dec + dt_pack
        rate = args.workers * n / per_worker
        print(f"old pipeline ceiling ({args.workers} tile workers, "
              f"serial decode+pack): {rate:,.0f} targets/s")

        # the production pipeline since this change: per-target
        # decode+select fanned out over a cpu_count pool
        # (GradScoreEngine._load_group_targets), tile assembly on top
        import concurrent.futures

        def load_select(i):
            cb, gb, zb = blobs[i]
            t_rgb = read_image(cb).as_rgb()
            grad = read_image(gb).pixels.astype(np.uint16)
            zgap = read_image(zb).as_rgb()
            return shape_score.select_target_cols_split(
                t_rgb, grad, zgap, pos_gap, n_gap, pos_he, n_he,
                mask_threshold=20, excluded=region, mirror=True)

        n_pool = os.cpu_count() or 4
        with concurrent.futures.ThreadPoolExecutor(n_pool) as pool:
            list(pool.map(load_select, range(8)))  # warm
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                cols = list(pool.map(load_select, range(n)))
                t_gap2, t_he2 = shape_score.assemble_target_rows_split(
                    cols, n_gap, n_he, mirror=True)
                dt_new = time.perf_counter() - t0
        assert (t_gap2 == t_gap).all() and (t_he2 == t_he).all()
        print(f"new pipeline ({n_pool}-thread decode+select): "
              f"{1e3 * dt_new / n:7.2f} ms/target ({n / dt_new:8.1f}/s)"
              f"  (device kernel: ~3.6M pairs/s at T=4096)")

        # end-to-end engine rate on the same on-disk workload (includes
        # the prefetch pipeline and the device dispatch)
        mask_path = os.path.join(tmp, "mask.tif")
        from PIL import Image as _Image
        _Image.fromarray(mask_rgb).save(mask_path)
        cold = run_e2e(paths, mask_path)
        warm = run_e2e(paths, mask_path)  # kernel compiled, LUTs hot
        print(f"engine end-to-end: {warm:8.1f} targets/s "
              f"({1e3 / warm:.2f} ms/target; cold incl. compile + "
              f"query pack: {cold:.1f}/s)")

        # packed-variant store (io/shape_pack.py): first run builds the
        # rows (decode + write-behind), later runs gather instead of
        # decoding — the decode-once production configuration
        pack_dir = os.path.join(tmp, "pack")
        build = run_e2e(paths, mask_path, pack_store=pack_dir)
        hot = run_e2e(paths, mask_path, pack_store=pack_dir)
        hot2 = run_e2e(paths, mask_path, pack_store=pack_dir)
        print(f"engine + packed store: build {build:8.1f} targets/s, "
              f"store-hit {max(hot, hot2):8.1f} targets/s "
              f"({1e3 / max(hot, hot2):.2f} ms/target)")

        # store-hit HOST side alone (gather + assemble, no device
        # dispatch): the host ceiling when the device kernel is
        # negligible per target
        from colormipsearch_tpu.io.shape_pack import ShapePackStore

        store = ShapePackStore(pack_dir, H, W)
        gplan = shape_score.split_gather_plan(
            pos_gap, pos_he, W, mirror=True, excluded=region)

        def hit(i):
            zsl, grad_thr, tfg_bits = store.row(i)
            return shape_score.select_target_cols_split_from_row(
                zsl, grad_thr, tfg_bits, pos_gap, n_gap, n_he, gplan,
                mirror=True)

        with concurrent.futures.ThreadPoolExecutor(n_pool) as pool:
            list(pool.map(hit, range(min(8, n))))  # warm page cache
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                cols3 = list(pool.map(hit, range(n)))
                shape_score.assemble_target_rows_split(
                    cols3, n_gap, n_he, mirror=True)
                dt_hit = time.perf_counter() - t0
        print(f"store-hit host pipeline ({n_pool} threads, no device): "
              f"{1e3 * dt_hit / n:7.2f} ms/target ({n / dt_hit:8.1f}/s)")

        # tile-level store gather (the engine's actual fast lane):
        # one vectorized 2D gather per field per dispatch tile
        rows = list(range(n))
        shape_score.select_target_tile_from_store(
            store, rows[:8], pos_gap, n_gap, n_he, gplan, mirror=True)
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            shape_score.select_target_tile_from_store(
                store, rows, pos_gap, n_gap, n_he, gplan, mirror=True)
            dt_tile = time.perf_counter() - t0
        print(f"store-hit tile gather (1 thread, no device): "
              f"{1e3 * dt_tile / n:7.2f} ms/target ({n / dt_tile:8.1f}/s)")

        # pack sub-stage split
        decoded_np = decoded
        t0 = time.perf_counter()
        for d in decoded_np:
            d[0].reshape(-1, 3)[np.concatenate([pos_he, pos_he])]
        dt_sel = time.perf_counter() - t0
        from colormipsearch_tpu.ops.slice_lut import slice_numbers_lut
        zsel = np.stack([z.reshape(-1, 3)[pos_gap] for _, _, z in decoded])
        t0 = time.perf_counter()
        slice_numbers_lut(zsel)
        dt_lut = time.perf_counter() - t0
        print(f"#   pack sub-stages: he-row select {1e3 * dt_sel / n:.2f} "
              f"ms/t, slice LUT {1e3 * dt_lut / n:.2f} ms/t")
    return 0


if __name__ == "__main__":
    sys.exit(main())

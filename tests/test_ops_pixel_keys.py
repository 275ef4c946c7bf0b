"""Rank-key interval predicate vs the float64 oracle.

The key path (ops/common.pack_target_planes_keys +
ops/pixel_match.build_key_intervals / score_query_batch_keys) claims
EXACT per-pixel verdicts — no ambiguity band — because interval
endpoints are found by bisecting the f64 oracle itself.  These tests
check per-variant equality against PixelMatchOracle (not merely the
banded fast kernel), the engine path, the mesh step, and the
negative-query form; the `-m slow` suite proves membership equality
over every achievable ratio pair (test_slow_exhaustive.py).
"""

import numpy as np
import pytest

from colormipsearch_tpu.oracle import pixel as oracle_pixel
from colormipsearch_tpu.oracle.pixel import PixelMatchOracle
from colormipsearch_tpu.ops import common, pixel_match


def _mk(rng, h, w, n):
    img = np.zeros((h, w, 3), np.uint8)
    ys = rng.integers(0, h, n)
    xs = rng.integers(0, w, n)
    img[ys, xs] = rng.integers(0, 256, (n, 3))
    return img


def test_rank_table_sound():
    vals, rank = common.ratio_rank_table()
    assert vals.size < (1 << common.KEY_RANK_BITS)
    assert vals[0] == 0.0
    assert (np.diff(vals) > 0).all()
    # rank round-trips the f64 ratio for every achievable (s, p)
    sv, pv = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    valid = (pv >= 1) & (sv < pv)
    assert (vals[rank[valid]] == (sv / np.maximum(pv, 1))[valid]).all()
    assert (rank[~valid] == 0).all()


@pytest.mark.parametrize("z_tol", [0.01, 0.02, 0.0123])
def test_intervals_match_oracle_on_ratio_grid(z_tol):
    """Membership equality on a strided grid of achievable summaries
    (the slow suite covers ALL pairs)."""
    vals, rank_tab = common.ratio_rank_table()
    sv, pv = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    valid = (pv >= 1) & (sv < pv)
    s_all, p_all = sv[valid], pv[valid]
    sel = np.arange(0, s_all.size, 97)
    rng = np.random.default_rng(3)

    for qc in range(1, 7):
        q_s = s_all[sel].astype(np.int64)
        q_p = p_all[sel].astype(np.int64)
        q_cls = np.full(q_s.shape, qc, np.int64)
        q_r = oracle_pixel.ratio_f64(q_cls, q_s, q_p)
        lo, span = pixel_match.build_key_intervals(q_cls, q_s, q_p, z_tol)
        # all classes x a strided set of target ratios (always including
        # the extremes and a random block)
        t_ranks = np.unique(np.concatenate([
            np.arange(0, vals.size, 131), [0, 1, vals.size - 1],
            rng.integers(0, vals.size, 200)]))
        for tc in range(1, 7):
            keys = ((tc << common.KEY_RANK_BITS) | t_ranks).astype(
                np.uint32)
            truth = oracle_pixel.pixel_gap(
                q_cls[:, None], q_r[:, None], tc, vals[t_ranks][None, :]
            ) <= z_tol
            memb = np.zeros_like(truth)
            for k in range(3):
                memb |= (keys[None, :] - lo[k][:, None]) <= span[k][:, None]
            assert (memb == truth).all(), (qc, tc)


def test_interval_table_equals_direct_bisection():
    """build_key_intervals gathers from the per-tolerance memo table
    (_key_interval_table); the gather must equal running the bisection
    directly on the pixels' (class, rank) summaries."""
    _, rank_tab = common.ratio_rank_table()
    rng = np.random.default_rng(11)
    q_p = rng.integers(1, 256, 4096).astype(np.int64)
    q_s = (q_p * rng.random(4096)).astype(np.int64)  # s < p
    q_cls = rng.integers(0, 7, 4096).astype(np.int64)
    lo, span = pixel_match.build_key_intervals(q_cls, q_s, q_p, 0.01)
    rank = rank_tab[q_s, q_p]
    d_lo, d_span = pixel_match._bisect_key_intervals(q_cls, rank, 0.01)
    live = q_cls > 0
    assert (lo[:, live] == d_lo[:, live]).all()
    assert (span[:, live] == d_span[:, live]).all()
    # class-0 summaries must map to the empty interval
    assert (span[:, ~live] == 0).all()
    assert (lo[:, ~live] == pixel_match._EMPTY_LO).all()


@pytest.mark.parametrize("z_tol", [-0.01, float("nan"), 0.0])
def test_intervals_degenerate_tolerances(z_tol):
    """Negative/NaN tolerances must still equal the oracle verdict —
    the same-class bisection's degenerate edges previously underflowed
    span to match-everything."""
    vals, _ = common.ratio_rank_table()
    sel = np.arange(1, 32000, 997)
    sv, pv = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    valid = (pv >= 1) & (sv < pv)
    s_all, p_all = sv[valid], pv[valid]
    for qc in (1, 4):
        q_s = s_all[sel].astype(np.int64)
        q_p = p_all[sel].astype(np.int64)
        q_cls = np.full(q_s.shape, qc, np.int64)
        q_r = oracle_pixel.ratio_f64(q_cls, q_s, q_p)
        lo, span = pixel_match.build_key_intervals(q_cls, q_s, q_p, z_tol)
        t_ranks = np.arange(0, vals.size, 131)
        for tc in range(1, 7):
            keys = ((tc << common.KEY_RANK_BITS) | t_ranks).astype(
                np.uint32)
            gaps = oracle_pixel.pixel_gap(
                q_cls[:, None], q_r[:, None], tc, vals[t_ranks][None, :])
            truth = gaps <= z_tol
            memb = np.zeros_like(truth)
            for k in range(3):
                memb |= (keys[None, :] - lo[k][:, None]) <= span[k][:, None]
            assert (memb == truth).all(), (qc, tc, z_tol)


def test_key_kernel_equals_oracle_per_variant():
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    h, w = 40, 60
    query = _mk(rng, h, w, 400)
    # the known f32-ambiguity regression pair must be exact here
    query[0, 0] = (50, 0, 53)
    targets = [_mk(rng, h, w, 300) for _ in range(6)] + [query]
    targets[0][0, 0] = (151, 0, 158)
    flu, thr = 1.23, 20

    plan = pixel_match.build_query_plan(
        query, thr, mirror=True, xy_shift=2, pix_color_fluctuation=flu)
    kplan = pixel_match.key_plan_from_query_plan(plan, h * w, flu)
    t_keys = common.pack_target_planes_keys(
        jnp.asarray(np.stack(targets)), thr, common.rank_lut_device())
    scores = np.asarray(pixel_match.score_query_against_key_planes_raw(
        t_keys, jnp.asarray(kplan.positions), jnp.asarray(kplan.lo),
        jnp.asarray(kplan.span)))

    oracle = PixelMatchOracle(query, thr, mirror=True,
                              target_threshold=thr, z_tolerance=flu / 100,
                              xy_shift=2)
    for i, t in enumerate(targets):
        res = oracle.score(t)
        want = np.concatenate([res.per_variant, res.per_variant_mirror])
        assert (scores[:, i] == want).all(), i


def test_score_query_batch_keys_matches_raw():
    """The batched (non-mesh fallback) entry point must agree with the
    per-variant raw kernel + reference reduction semantics."""
    import jax.numpy as jnp

    rng = np.random.default_rng(13)
    h, w = 30, 40
    queries = [_mk(rng, h, w, 250) for _ in range(3)]
    targets = [_mk(rng, h, w, 200) for _ in range(5)] + [queries[0]]
    thr, flu = 20, 1.0

    plans = [pixel_match.build_query_plan(
        q, thr, mirror=True, xy_shift=2, pix_color_fluctuation=flu)
        for q in queries]
    kplans = [pixel_match.key_plan_from_query_plan(p, h * w, flu)
              for p in plans]
    t_keys = common.pack_target_planes_keys(
        jnp.asarray(np.stack(targets)), thr, common.rank_lut_device())
    best, mirrored, flags = pixel_match.score_query_batch_keys(
        t_keys,
        jnp.asarray(np.stack([kp.positions for kp in kplans])),
        jnp.asarray(np.stack([kp.lo for kp in kplans])),
        jnp.asarray(np.stack([kp.span for kp in kplans])),
        n_straight=plans[0].n_straight)
    assert (np.asarray(flags) == 0).all()
    for b, kp in enumerate(kplans):
        scores = np.asarray(pixel_match.score_query_against_key_planes_raw(
            t_keys, jnp.asarray(kp.positions), jnp.asarray(kp.lo),
            jnp.asarray(kp.span)))
        want_b, want_m = pixel_match.reduce_variant_scores(scores, plans[b])
        assert (np.asarray(best)[b] == want_b).all()
        assert (np.asarray(mirrored)[b] == want_m).all()
    assert int(np.asarray(best)[0, 5]) == plans[0].query_size


def test_key_planes_from_packed_equals_direct_pack():
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    stack = np.stack([_mk(rng, 20, 30, 150) for _ in range(4)])
    lut = common.rank_lut_device()
    direct = np.asarray(common.pack_target_planes_keys(
        jnp.asarray(stack), 20, lut))
    packed = common.pack_target_planes(jnp.asarray(stack),
                                       data_threshold=20)
    converted = np.asarray(common.key_planes_from_packed(packed, lut))
    assert (direct == converted).all()
    assert (direct[-1] == 0).all()  # sentinel row


@pytest.mark.parametrize("xy_shift", [2, 4])
def test_union_qkeys_batch_equals_classic_keys(xy_shift):
    """The qkey wire form (device-side table gather) must equal the
    classic key kernel exactly, across shifts and a mask batch."""
    import jax.numpy as jnp

    rng = np.random.default_rng(41 + xy_shift)
    h, w = 30, 40
    queries = [_mk(rng, h, w, 250) for _ in range(3)]
    targets = [_mk(rng, h, w, 200) for _ in range(7)] + [queries[0]]
    thr, flu = 20, 1.0

    t_keys = common.pack_target_planes_keys(
        jnp.asarray(np.stack(targets)), thr, common.rank_lut_device())
    plans = [pixel_match.build_query_plan(
        q, thr, mirror=True, xy_shift=xy_shift,
        pix_color_fluctuation=flu) for q in queries]
    kplans = [pixel_match.key_plan_from_query_plan(p, h * w, flu)
              for p in plans]
    best, mirrored, _ = pixel_match.score_query_batch_keys(
        t_keys,
        jnp.asarray(np.stack([kp.positions for kp in kplans])),
        jnp.asarray(np.stack([kp.lo for kp in kplans])),
        jnp.asarray(np.stack([kp.span for kp in kplans])),
        n_straight=plans[0].n_straight)

    fplans = [pixel_match.build_full_union_key_plan(
        q, thr, mirror=True, xy_shift=xy_shift,
        pix_color_fluctuation=flu) for q in queries]
    assert all(p.qkeys is not None for p in fplans)
    stacked = pixel_match.stack_union_qkey_args(fplans, h * w)
    assert stacked is not None
    *arrs, u2 = stacked
    tabs = pixel_match.interval_table_arrays(flu / 100.0)
    assert tabs is not None
    qbest, qmirrored, qflags = pixel_match.score_query_batch_union_qkeys(
        t_keys, *[jnp.asarray(a) for a in arrs],
        jnp.asarray(tabs[0]), jnp.asarray(tabs[1]), u2=u2)
    assert (np.asarray(qflags) == 0).all()
    assert (np.asarray(qbest) == np.asarray(best)).all()
    assert (np.asarray(qmirrored) == np.asarray(mirrored)).all()


@pytest.mark.parametrize("xy_shift", [2, 4])
def test_pos_expansion_equals_host_tables(xy_shift):
    """The positional wire form's ON-DEVICE lane-table derivation
    (pos_index scatter + geometry, expand_union_tables_from_pos) must
    reproduce the host-built expanded tables bit-for-bit, including
    sentinel pads, out-of-image shifts, excluded regions, and batch
    members with different query sizes."""
    import jax.numpy as jnp

    rng = np.random.default_rng(51 + xy_shift)
    h, w = 30, 40
    region = np.zeros((h, w), bool)
    region[:4, :6] = True
    queries = [_mk(rng, h, w, n) for n in (250, 90, 170)]
    plans = [pixel_match.build_full_union_key_plan(
        q, 20, mirror=True, xy_shift=xy_shift, pix_color_fluctuation=1.0,
        excluded_region=region) for q in queries]
    assert all(p.q_pos is not None for p in plans)
    pa = pixel_match.stack_union_pos_args(plans, h * w)
    assert pa is not None
    u_pos, mu_pos, q_pos, key_list, u2 = pa
    tabs = pixel_match.interval_table_arrays(1.0 / 100.0)
    from colormipsearch_tpu.oracle.pixel import shift_offsets

    offs = tuple((int(dx), int(dy))
                 for dx, dy in shift_offsets(xy_shift))
    lo_dev, sp_dev = pixel_match.expand_union_tables_from_pos(
        jnp.asarray(u_pos), jnp.asarray(q_pos), jnp.asarray(key_list),
        jnp.asarray(tabs[0]), jnp.asarray(tabs[1]),
        offsets=offs, w=w, h=h)
    # host reference: the plans' own expanded lane tables
    u_pad = max(p.u_pos.shape[1] for p in plans)
    padded = [pixel_match.pad_union_key_plan(p, u_pad, h * w)
              for p in plans]
    np.testing.assert_array_equal(
        np.asarray(lo_dev), np.stack([p.lane_lo for p in padded]))
    np.testing.assert_array_equal(
        np.asarray(sp_dev), np.stack([p.lane_span for p in padded]))


def test_large_query_falls_back_to_table_stacking():
    """Regression (review r4): a >=65535-px query has qkeys but no
    factored qidx; light plans must KEEP the lane tables so the
    engine's fallback stacking works instead of crashing."""
    rng = np.random.default_rng(3)
    img = rng.integers(30, 256, (300, 300, 3)).astype(np.uint8)  # 90k fg
    p = pixel_match.build_full_union_key_plan(
        img, 20, mirror=True, xy_shift=2, pix_color_fluctuation=1.0,
        light=True)
    assert p.query_size >= 65535
    assert p.qidx is None
    assert p.lane_lo is not None  # kept for the fallback
    assert pixel_match.stack_union_qkey_args([p], 300 * 300) is None
    arrs = pixel_match.stack_union_plan_args([p], 300 * 300)
    assert arrs is not None and len(arrs) == 5


def test_sparse_key_planes_equal_dense():
    """The sparse COO upload path must produce BIT-IDENTICAL key planes
    to the dense device pack — including t_pad padding columns, the
    sentinel row, threshold-boundary pixels, and tie pixels (cls 0)
    that sit above the threshold."""
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    stack = np.stack([_mk(rng, 24, 37, 200) for _ in range(5)])
    # threshold-edge and tie pixels: maxch == 20 (dead), 21 (live),
    # and a live-but-tied pixel (class 0 -> key 0 in both paths)
    stack[0, 0, 0] = (20, 20, 20)
    stack[0, 0, 1] = (21, 0, 0)
    stack[0, 0, 2] = (200, 200, 200)
    lut = common.rank_lut_device()
    t_pad = 8
    dense = np.asarray(common.pack_target_planes_keys(
        jnp.asarray(stack), 20, lut))
    dense = np.pad(dense, ((0, 0), (0, t_pad - stack.shape[0])))
    sparse = np.asarray(common.pack_target_planes_keys_sparse(
        stack, 20, lut, t_pad))
    np.testing.assert_array_equal(sparse, dense)
    assert (sparse[-1] == 0).all()  # sentinel row

    # empty stack (all black) still produces valid all-zero planes
    black = np.zeros((3, 24, 37, 3), np.uint8)
    sp = np.asarray(common.pack_target_planes_keys_sparse(
        black, 20, lut, 4))
    assert sp.shape == (24 * 37 + 1, 4) and (sp == 0).all()


def test_engine_sparse_upload_end_to_end(tmp_path, monkeypatch):
    """load_target_shards' default sparse path must give the same
    scores as the dense A/B path through the real engine."""
    import os

    from PIL import Image

    from colormipsearch_tpu.engine import cds as cds_engine
    from colormipsearch_tpu.model import ComputeFileType
    from colormipsearch_tpu.model.entities import Neuron

    rng = np.random.default_rng(11)
    neurons = []
    for i in range(5):
        img = _mk(rng, 40, 60, 400)
        p = tmp_path / f"t{i}.png"
        Image.fromarray(img).save(p)
        n = Neuron(mip_id=f"t-{i}")
        n.set_compute_file(ComputeFileType.InputColorDepthImage, str(p))
        neurons.append(n)

    shards_sparse = cds_engine.load_target_shards(
        neurons, pack_threshold=20, plane_kind="keys")
    monkeypatch.setenv("CDS_DENSE_UPLOAD", "1")
    shards_dense = cds_engine.load_target_shards(
        neurons, pack_threshold=20, plane_kind="keys")
    assert len(shards_sparse) == len(shards_dense) == 1
    np.testing.assert_array_equal(np.asarray(shards_sparse[0].planes),
                                  np.asarray(shards_dense[0].planes))


def test_union_key_plan_grid_detection():
    rng = np.random.default_rng(7)
    img = _mk(rng, 20, 30, 100)
    # xy_shift 4 offsets (identity + compass 2 + compass 4) are not a
    # {dy} x {dx} grid -> no union plan, callers fall back
    assert pixel_match.build_union_key_plan(
        img, 20, mirror=True, xy_shift=4, pix_color_fluctuation=1.0) is None
    up = pixel_match.build_union_key_plan(
        img, 20, mirror=True, xy_shift=2, pix_color_fluctuation=1.0)
    assert up is not None and up.n_sets == 3 and up.n_lanes == 3
    assert up.n_straight == 9 and up.mu_pos.shape == up.u_pos.shape


def test_union_keys_per_variant_equals_oracle():
    """Union rows (dy-set major, dx-lane minor) must equal the oracle's
    per-variant counts for every shift/mirror variant."""
    import jax.numpy as jnp

    rng = np.random.default_rng(17)
    h, w = 40, 60
    query = _mk(rng, h, w, 400)
    query[0, 0] = (50, 0, 53)  # f32-ambiguity regression pair
    targets = [_mk(rng, h, w, 300) for _ in range(5)] + [query]
    targets[0][0, 0] = (151, 0, 158)
    flu, thr = 1.23, 20

    up = pixel_match.build_union_key_plan(
        query, thr, mirror=True, xy_shift=2, pix_color_fluctuation=flu)
    t_keys = common.pack_target_planes_keys(
        jnp.asarray(np.stack(targets)), thr, common.rank_lut_device())
    scores = np.asarray(pixel_match.score_query_union_keys_raw(
        t_keys, jnp.asarray(up.u_pos), jnp.asarray(up.mu_pos),
        jnp.asarray(up.lane_lo), jnp.asarray(up.lane_span)))

    offsets = oracle_pixel.shift_offsets(2)
    dxs = sorted({dx for dx, _ in offsets})
    dys = sorted({dy for _, dy in offsets})
    rows = [dys.index(dy) * len(dxs) + dxs.index(dx) for dx, dy in offsets]
    oracle = PixelMatchOracle(query, thr, mirror=True,
                              target_threshold=thr, z_tolerance=flu / 100,
                              xy_shift=2)
    for i, t in enumerate(targets):
        res = oracle.score(t)
        assert (scores[rows, i] == res.per_variant).all(), i
        mrows = [up.n_straight + r for r in rows]
        assert (scores[mrows, i] == res.per_variant_mirror).all(), i


def test_union_keys_batch_equals_classic_keys():
    import jax.numpy as jnp

    rng = np.random.default_rng(19)
    h, w = 30, 40
    queries = [_mk(rng, h, w, 250) for _ in range(3)]
    # one query with an empty-after-threshold support exercises padding
    queries.append(np.zeros((h, w, 3), np.uint8))
    targets = [_mk(rng, h, w, 200) for _ in range(7)] + [queries[0]]
    thr, flu = 20, 1.0

    t_keys = common.pack_target_planes_keys(
        jnp.asarray(np.stack(targets)), thr, common.rank_lut_device())
    plans = [pixel_match.build_query_plan(
        q, thr, mirror=True, xy_shift=2, pix_color_fluctuation=flu)
        for q in queries]
    kplans = [pixel_match.key_plan_from_query_plan(p, h * w, flu)
              for p in plans]
    best, mirrored, _ = pixel_match.score_query_batch_keys(
        t_keys,
        jnp.asarray(np.stack([kp.positions for kp in kplans])),
        jnp.asarray(np.stack([kp.lo for kp in kplans])),
        jnp.asarray(np.stack([kp.span for kp in kplans])),
        n_straight=plans[0].n_straight)

    uplans = [pixel_match.build_union_key_plan(
        q, thr, mirror=True, xy_shift=2, pix_color_fluctuation=flu)
        for q in queries]
    *uarrs, uu2 = pixel_match.stack_union_plan_args(uplans, h * w)
    ubest, umirrored, uflags = pixel_match.score_query_batch_union_keys(
        t_keys, *[jnp.asarray(a) for a in uarrs], u2=uu2)
    assert (np.asarray(uflags) == 0).all()
    assert (np.asarray(ubest) == np.asarray(best)).all()
    assert (np.asarray(umirrored) == np.asarray(mirrored)).all()
    # self-match sanity: nonzero and equal through both kernels (it can
    # be < query_size — dominance-less foreground pixels never match)
    assert int(np.asarray(ubest)[0, 7]) > 0


def test_union_keys_golden_87(mask_rgb, target_rgb):
    import jax.numpy as jnp

    h, w = mask_rgb.shape[:2]
    region = oracle_pixel.label_regions_mask(w, h)
    up = pixel_match.build_union_key_plan(
        mask_rgb, 20, mirror=True, xy_shift=2, pix_color_fluctuation=1.0,
        excluded_region=region)
    t_keys = common.pack_target_planes_keys(
        jnp.asarray(target_rgb[None]), 20, common.rank_lut_device())
    best, mirrored, _ = pixel_match.score_query_batch_union_keys(
        t_keys, jnp.asarray(up.u_pos[None]), jnp.asarray(up.mu_pos[None]),
        jnp.asarray(up.lane_lo[None]), jnp.asarray(up.lane_span[None]))
    assert int(np.asarray(best)[0, 0]) == 87
    assert not bool(np.asarray(mirrored)[0, 0])


def test_full_union_keys_per_variant_equals_oracle():
    """Full-union rows (one row set, lanes in shift_offsets order) must
    equal the oracle's per-variant counts, straight and mirrored."""
    import jax.numpy as jnp

    rng = np.random.default_rng(23)
    h, w = 40, 60
    query = _mk(rng, h, w, 400)
    query[0, 0] = (50, 0, 53)
    targets = [_mk(rng, h, w, 300) for _ in range(5)] + [query]
    targets[0][0, 0] = (151, 0, 158)
    flu, thr = 1.23, 20

    fp = pixel_match.build_full_union_key_plan(
        query, thr, mirror=True, xy_shift=2, pix_color_fluctuation=flu)
    assert fp.n_sets == 1 and fp.n_lanes == 9 and fp.n_straight == 9
    t_keys = common.pack_target_planes_keys(
        jnp.asarray(np.stack(targets)), thr, common.rank_lut_device())
    scores = np.asarray(pixel_match.score_query_union_keys_raw(
        t_keys, jnp.asarray(fp.u_pos), jnp.asarray(fp.mu_pos),
        jnp.asarray(fp.lane_lo), jnp.asarray(fp.lane_span)))

    oracle = PixelMatchOracle(query, thr, mirror=True,
                              target_threshold=thr, z_tolerance=flu / 100,
                              xy_shift=2)
    for i, t in enumerate(targets):
        res = oracle.score(t)
        assert (scores[:9, i] == res.per_variant).all(), i
        assert (scores[9:, i] == res.per_variant_mirror).all(), i


@pytest.mark.parametrize("xy_shift", [0, 2, 4])
def test_full_union_keys_batch_equals_classic_keys(xy_shift):
    """Best/mirrored equality vs the classic key kernel — including
    xyShift 4, where the x-union form has no plan at all."""
    import jax.numpy as jnp

    rng = np.random.default_rng(27 + xy_shift)
    h, w = 30, 40
    queries = [_mk(rng, h, w, 250) for _ in range(3)]
    queries.append(np.zeros((h, w, 3), np.uint8))
    targets = [_mk(rng, h, w, 200) for _ in range(7)] + [queries[0]]
    thr, flu = 20, 1.0

    t_keys = common.pack_target_planes_keys(
        jnp.asarray(np.stack(targets)), thr, common.rank_lut_device())
    plans = [pixel_match.build_query_plan(
        q, thr, mirror=True, xy_shift=xy_shift, pix_color_fluctuation=flu)
        for q in queries]
    kplans = [pixel_match.key_plan_from_query_plan(p, h * w, flu)
              for p in plans]
    best, mirrored, _ = pixel_match.score_query_batch_keys(
        t_keys,
        jnp.asarray(np.stack([kp.positions for kp in kplans])),
        jnp.asarray(np.stack([kp.lo for kp in kplans])),
        jnp.asarray(np.stack([kp.span for kp in kplans])),
        n_straight=plans[0].n_straight)

    fplans = [pixel_match.build_full_union_key_plan(
        q, thr, mirror=True, xy_shift=xy_shift, pix_color_fluctuation=flu)
        for q in queries]
    *farrs, fu2 = pixel_match.stack_union_plan_args(fplans, h * w)
    ubest, umirrored, uflags = pixel_match.score_query_batch_union_keys(
        t_keys, *[jnp.asarray(a) for a in farrs], u2=fu2)
    assert (np.asarray(uflags) == 0).all()
    assert (np.asarray(ubest) == np.asarray(best)).all()
    assert (np.asarray(umirrored) == np.asarray(mirrored)).all()


def test_full_union_keys_golden_87(mask_rgb, target_rgb):
    import jax.numpy as jnp

    h, w = mask_rgb.shape[:2]
    region = oracle_pixel.label_regions_mask(w, h)
    fp = pixel_match.build_full_union_key_plan(
        mask_rgb, 20, mirror=True, xy_shift=2, pix_color_fluctuation=1.0,
        excluded_region=region)
    t_keys = common.pack_target_planes_keys(
        jnp.asarray(target_rgb[None]), 20, common.rank_lut_device())
    best, mirrored, _ = pixel_match.score_query_batch_union_keys(
        t_keys, jnp.asarray(fp.u_pos[None]), jnp.asarray(fp.mu_pos[None]),
        jnp.asarray(fp.lane_lo[None]), jnp.asarray(fp.lane_span[None]))
    assert int(np.asarray(best)[0, 0]) == 87
    assert not bool(np.asarray(mirrored)[0, 0])


def _engine_matches(tmp_path, use_keys, masks_neurons, targets_neurons,
                    params, **kw):
    from colormipsearch_tpu.engine.cds import CDSearchEngine

    eng = CDSearchEngine(params, use_key_planes=use_keys, **kw)
    ms = eng.find_all_matches(masks_neurons, targets_neurons)
    return sorted(
        ((m.mask_image.mip_id, m.matched_image.mip_id,
          m.matching_pixels, m.mirrored, round(m.matching_pixels_ratio, 12))
         for m in ms))


def _write_neurons(tmp_path, imgs, prefix):
    from PIL import Image

    from colormipsearch_tpu.model import ComputeFileType, Neuron

    out = []
    for i, img in enumerate(imgs):
        f = tmp_path / f"{prefix}{i}.png"
        Image.fromarray(img).save(f)
        n = Neuron(mip_id=f"{prefix}-{i}")
        n.set_compute_file(ComputeFileType.InputColorDepthImage, str(f))
        out.append(n)
    return out


def test_engine_key_path_equals_packed_path(tmp_path):
    from colormipsearch_tpu.engine.cds import CDSParams

    rng = np.random.default_rng(21)
    h, w = 36, 48
    masks = [_mk(rng, h, w, 350) for _ in range(3)]
    targets = [_mk(rng, h, w, 300) for _ in range(9)] + [masks[0]]
    mask_neurons = _write_neurons(tmp_path, masks, "m")
    target_neurons = _write_neurons(tmp_path, targets, "t")
    params = CDSParams(mask_threshold=20, data_threshold=20,
                       pix_color_fluctuation=1.0, xy_shift=2,
                       mirror_mask=True)
    ref = _engine_matches(tmp_path, False, mask_neurons, target_neurons,
                          params)
    got = _engine_matches(tmp_path, True, mask_neurons, target_neurons,
                          params)
    assert got == ref and len(ref) > 0


def test_engine_wire_form_fallbacks_equal(tmp_path, monkeypatch):
    """The engine's three full-union wire forms (positional, factored
    qkeys, expanded tables) must yield identical matches — the fallback
    chain is exercised by disabling the preferred stackers."""
    from colormipsearch_tpu.engine.cds import CDSParams
    from colormipsearch_tpu.ops import pixel_match as pm

    rng = np.random.default_rng(61)
    h, w = 36, 48
    masks = [_mk(rng, h, w, 350) for _ in range(3)]
    targets = [_mk(rng, h, w, 300) for _ in range(9)] + [masks[0]]
    mask_neurons = _write_neurons(tmp_path, masks, "wm")
    target_neurons = _write_neurons(tmp_path, targets, "wt")
    params = CDSParams(mask_threshold=20, data_threshold=20,
                       pix_color_fluctuation=1.0, xy_shift=2,
                       mirror_mask=True)

    def run():
        return _engine_matches(tmp_path, True, mask_neurons,
                               target_neurons, params,
                               use_union_keys="full")

    ref = run()  # positional form (default)
    assert len(ref) > 0
    monkeypatch.setattr(pm, "stack_union_pos_args",
                        lambda plans, n: None)
    assert run() == ref  # factored qkey form
    monkeypatch.setattr(pm, "stack_union_qkey_args",
                        lambda plans, n: None)
    assert run() == ref  # expanded-tables form


def test_engine_key_path_top_k(tmp_path):
    from colormipsearch_tpu.engine.cds import CDSearchEngine, CDSParams

    rng = np.random.default_rng(22)
    h, w = 36, 48
    masks = [_mk(rng, h, w, 350) for _ in range(2)]
    targets = [_mk(rng, h, w, 300) for _ in range(12)] + [masks[0]]
    mask_neurons = _write_neurons(tmp_path, masks, "km")
    target_neurons = _write_neurons(tmp_path, targets, "kt")
    params = CDSParams(mask_threshold=20, data_threshold=20,
                       pix_color_fluctuation=1.0, xy_shift=2,
                       mirror_mask=True)
    ref = CDSearchEngine(params, use_key_planes=False).find_all_matches(
        mask_neurons, target_neurons, max_matches_per_mask=3)
    got = CDSearchEngine(params, use_key_planes=True).find_all_matches(
        mask_neurons, target_neurons, max_matches_per_mask=3)
    key = lambda m: (m.mask_image.mip_id, -m.matching_pixels,  # noqa: E731
                     m.matched_image.mip_id)
    assert [(m.mask_image.mip_id, m.matched_image.mip_id,
             m.matching_pixels) for m in sorted(got, key=key)] == \
        [(m.mask_image.mip_id, m.matched_image.mip_id,
          m.matching_pixels) for m in sorted(ref, key=key)]


def test_engine_key_path_golden_87(tmp_path, mask_rgb, target_rgb):
    from colormipsearch_tpu.engine.cds import CDSearchEngine, CDSParams

    mask_neurons = _write_neurons(tmp_path, [mask_rgb], "gm")
    target_neurons = _write_neurons(tmp_path, [target_rgb], "gt")
    params = CDSParams(mask_threshold=20, data_threshold=20,
                       pix_color_fluctuation=1.0, xy_shift=2,
                       mirror_mask=True, with_name_label_region=True,
                       with_color_scale_region=True)
    ms = CDSearchEngine(params, use_key_planes=True).find_all_matches(
        mask_neurons, target_neurons)
    assert len(ms) == 1
    assert ms[0].matching_pixels == 87 and not ms[0].mirrored


@pytest.mark.parametrize("mode", ["x", "full"])
def test_engine_union_keys_equals_packed_path(tmp_path, mode):
    from colormipsearch_tpu.engine.cds import CDSParams

    rng = np.random.default_rng(29)
    h, w = 36, 48
    masks = [_mk(rng, h, w, 350) for _ in range(3)]
    targets = [_mk(rng, h, w, 300) for _ in range(9)] + [masks[0]]
    mask_neurons = _write_neurons(tmp_path, masks, "um" + mode)
    target_neurons = _write_neurons(tmp_path, targets, "ut" + mode)
    params = CDSParams(mask_threshold=20, data_threshold=20,
                       pix_color_fluctuation=1.0, xy_shift=2,
                       mirror_mask=True)
    ref = _engine_matches(tmp_path, False, mask_neurons, target_neurons,
                          params)
    got = _engine_matches(tmp_path, True, mask_neurons, target_neurons,
                          params, use_union_keys=mode)
    assert got == ref and len(ref) > 0


def test_engine_union_keys_top_k(tmp_path):
    from colormipsearch_tpu.engine.cds import CDSearchEngine, CDSParams

    rng = np.random.default_rng(31)
    h, w = 36, 48
    masks = [_mk(rng, h, w, 350) for _ in range(2)]
    targets = [_mk(rng, h, w, 300) for _ in range(12)] + [masks[0]]
    mask_neurons = _write_neurons(tmp_path, masks, "ukm")
    target_neurons = _write_neurons(tmp_path, targets, "ukt")
    params = CDSParams(mask_threshold=20, data_threshold=20,
                       pix_color_fluctuation=1.0, xy_shift=2,
                       mirror_mask=True)
    ref = CDSearchEngine(params, use_key_planes=True).find_all_matches(
        mask_neurons, target_neurons, max_matches_per_mask=3)
    got = CDSearchEngine(params, use_union_keys=True).find_all_matches(
        mask_neurons, target_neurons, max_matches_per_mask=3)
    key = lambda m: (m.mask_image.mip_id, -m.matching_pixels,  # noqa: E731
                     m.matched_image.mip_id)
    assert [(m.mask_image.mip_id, m.matched_image.mip_id,
             m.matching_pixels) for m in sorted(got, key=key)] == \
        [(m.mask_image.mip_id, m.matched_image.mip_id,
          m.matching_pixels) for m in sorted(ref, key=key)]


def test_engine_union_keys_golden_87(tmp_path, mask_rgb, target_rgb):
    from colormipsearch_tpu.engine.cds import CDSearchEngine, CDSParams

    mask_neurons = _write_neurons(tmp_path, [mask_rgb], "ugm")
    target_neurons = _write_neurons(tmp_path, [target_rgb], "ugt")
    params = CDSParams(mask_threshold=20, data_threshold=20,
                       pix_color_fluctuation=1.0, xy_shift=2,
                       mirror_mask=True, with_name_label_region=True,
                       with_color_scale_region=True)
    ms = CDSearchEngine(params, use_union_keys=True).find_all_matches(
        mask_neurons, target_neurons)
    assert len(ms) == 1
    assert ms[0].matching_pixels == 87 and not ms[0].mirrored


def test_engine_union_keys_neg_query_and_grid_fallback(tmp_path):
    """Union path with a negative query (the neg pass runs the classic
    key kernel) must equal the packed path; a non-grid xyShift must
    silently fall back to the classic key kernel."""
    from colormipsearch_tpu.engine.cds import CDSearchEngine, CDSParams

    rng = np.random.default_rng(33)
    h, w = 36, 48
    mask = _mk(rng, h, w, 400)
    neg = _mk(rng, h, w, 150)
    targets = [_mk(rng, h, w, 300) for _ in range(5)] + [mask]
    mask_neurons = _write_neurons(tmp_path, [mask], "unm")
    target_neurons = _write_neurons(tmp_path, targets, "unt")
    params = CDSParams(mask_threshold=20, data_threshold=20,
                       pix_color_fluctuation=1.0, xy_shift=2,
                       mirror_mask=True)
    kw = dict(neg_query_rgb=neg, mirror_neg_query=True)
    ref = _engine_matches(tmp_path, False, mask_neurons, target_neurons,
                          params, **kw)
    got = _engine_matches(tmp_path, True, mask_neurons, target_neurons,
                          params, use_union_keys=True, **kw)
    assert got == ref and len(ref) > 0

    params4 = CDSParams(mask_threshold=20, data_threshold=20,
                        pix_color_fluctuation=1.0, xy_shift=4,
                        mirror_mask=True)
    # bare True now selects "full" (covers any shift); the grid
    # fallback is specific to the "x" form
    engb = CDSearchEngine(params4, use_union_keys=True)
    assert engb.use_union_keys == "full"
    eng = CDSearchEngine(params4, use_union_keys="x")
    assert not eng.use_union_keys and eng.use_key_planes
    ref4 = _engine_matches(tmp_path, False, mask_neurons, target_neurons,
                           params4)
    got4 = sorted(
        ((m.mask_image.mip_id, m.matched_image.mip_id, m.matching_pixels,
          m.mirrored, round(m.matching_pixels_ratio, 12))
         for m in eng.find_all_matches(mask_neurons, target_neurons)))
    assert got4 == ref4 and len(ref4) > 0

    # the full-union form needs no grid: it must run (not fall back)
    # at xyShift 4 and still equal the packed path
    engf = CDSearchEngine(params4, use_union_keys="full")
    assert engf.use_union_keys == "full"
    gotf = sorted(
        ((m.mask_image.mip_id, m.matched_image.mip_id, m.matching_pixels,
          m.mirrored, round(m.matching_pixels_ratio, 12))
         for m in engf.find_all_matches(mask_neurons, target_neurons)))
    assert gotf == ref4


def test_engine_key_path_neg_query(tmp_path):
    from colormipsearch_tpu.engine.cds import CDSearchEngine, CDSParams

    rng = np.random.default_rng(23)
    h, w = 36, 48
    mask = _mk(rng, h, w, 400)
    neg = _mk(rng, h, w, 150)
    targets = [_mk(rng, h, w, 300) for _ in range(5)] + [mask]
    mask_neurons = _write_neurons(tmp_path, [mask], "nm")
    target_neurons = _write_neurons(tmp_path, targets, "nt")
    params = CDSParams(mask_threshold=20, data_threshold=20,
                       pix_color_fluctuation=1.0, xy_shift=2,
                       mirror_mask=True)
    kw = dict(neg_query_rgb=neg, mirror_neg_query=True)
    ref = _engine_matches(tmp_path, False, mask_neurons, target_neurons,
                          params, **kw)
    got = _engine_matches(tmp_path, True, mask_neurons, target_neurons,
                          params, **kw)
    assert got == ref and len(ref) > 0


def test_engine_kernel_kwarg_resolution():
    """An explicit use_key_planes choice pins exactly that kernel — the
    CDS_UNION_KEYS env default must not silently upgrade it to the
    union form (that would make cross-kernel equality tests vacuous,
    ADVICE r2 high).  Bare opt-in shorthands all mean the production
    default form, "full"."""
    from colormipsearch_tpu.engine.cds import CDSearchEngine, CDSParams

    params = CDSParams(mask_threshold=20, data_threshold=20,
                       pix_color_fluctuation=1.0, xy_shift=2)
    # explicit kernel pins: packed / classic keys
    eng = CDSearchEngine(params, use_key_planes=False)
    assert eng.use_union_keys is False and eng.use_key_planes is False
    eng = CDSearchEngine(params, use_key_planes=True)
    assert eng.use_union_keys is False and eng.use_key_planes is True
    # neither kwarg: the env default (production: full-union)
    eng = CDSearchEngine(params)
    assert eng.use_union_keys == "full" and eng.use_key_planes
    # every bare shorthand selects "full"
    for bare in (True, 1, "1"):
        eng = CDSearchEngine(params, use_union_keys=bare)
        assert eng.use_union_keys == "full" and eng.use_key_planes
    # "off"/"0"/False all disable the union form
    for off in (False, 0, "0", "off"):
        eng = CDSearchEngine(params, use_union_keys=off)
        assert eng.use_union_keys is False


def test_interval_slot_compaction():
    """compact_interval_slots drops only always-empty slots, preserves
    window sets per (lane, row), and production-tolerance plans come
    out with 2 slots (no key has 3 non-empty windows at ztol 0.01)."""
    E = int(pixel_match._EMPTY_LO)
    # [1 lane, 3 slots, 3 rows]: row 0 has windows in slots 0+2,
    # row 1 in slot 0, row 2 in slot 2; slot 1 is all-empty
    lo = np.array([[[3, 5, E], [E, E, E], [7, E, 9]]], np.uint32)
    sp = np.array([[[4, 2, 0], [0, 0, 0], [1, 0, 3]]], np.uint32)
    clo, csp = pixel_match.compact_interval_slots(lo, sp)
    assert clo.shape == (1, 2, 3)
    # per-row non-empty window multisets preserved
    for r in range(3):
        want = {(int(lo[0, s, r]), int(sp[0, s, r])) for s in range(3)
                if not (lo[0, s, r] == E and sp[0, s, r] == 0)}
        got = {(int(clo[0, s, r]), int(csp[0, s, r])) for s in range(2)
               if not (clo[0, s, r] == E and csp[0, s, r] == 0)}
        assert got == want

    # all-empty input keeps one (empty) slot
    clo1, _ = pixel_match.compact_interval_slots(
        np.full((2, 3, 4), E, np.uint32), np.zeros((2, 3, 4), np.uint32))
    assert clo1.shape == (2, 1, 4)

    # a real production-tolerance plan compacts to <= 2 slots
    rng = np.random.default_rng(3)
    q = _mk(rng, 30, 40, 250)
    fp = pixel_match.build_full_union_key_plan(
        q, 20, mirror=True, xy_shift=2, pix_color_fluctuation=1.0)
    assert fp.lane_lo.shape[1] <= 2


@pytest.mark.parametrize("seed,mirror", [(41, True), (42, True),
                                         (43, False), (44, True)])
def test_full_union_forms_identical(seed, mirror):
    """The full-union scorer: the slot-2 segmented form (tests on the
    u2 prefix only) and the full-width form give identical per-variant
    counts, and the batched best score and mirrored flag equal the
    float64 oracle's on every target."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    h, w = 40, 60
    query = _mk(rng, h, w, 400)
    targets = [_mk(rng, h, w, 300) for _ in range(6)] + [query]
    thr, flu = 20, 1.0

    fp = pixel_match.build_full_union_key_plan(
        query, thr, mirror=mirror, xy_shift=2, pix_color_fluctuation=flu)
    t_keys = common.pack_target_planes_keys(
        jnp.asarray(np.stack(targets)), thr, common.rank_lut_device())
    args = (t_keys, jnp.asarray(fp.u_pos), jnp.asarray(fp.mu_pos),
            jnp.asarray(fp.lane_lo), jnp.asarray(fp.lane_span))
    u2 = fp.u2 if fp.u2 is not None and fp.u2 >= 0 else None
    seg = np.asarray(pixel_match.score_query_union_keys_raw(*args, u2=u2))
    full = np.asarray(pixel_match.score_query_union_keys_raw(*args))
    assert (seg == full).all()

    best, mirrored, _ = pixel_match.score_query_batch_union_keys(
        *[a if i == 0 else a[None] for i, a in enumerate(args)], u2=u2)
    oracle = PixelMatchOracle(query, thr, mirror=mirror,
                              target_threshold=thr, z_tolerance=flu / 100,
                              xy_shift=2)
    for t, img in enumerate(targets):
        res = oracle.score(img)
        assert int(best[0, t]) == res.matching_pixels, t
        assert bool(mirrored[0, t]) == res.mirrored, t


def test_expansion_chunked_vmap_identical(monkeypatch):
    """The chunked map+vmap lane-table expansion (CDS_EXPAND_VMAP) must
    produce bit-identical tables to the per-mask map, for BOTH wire
    forms (positional and factored qkey), and the two forms must agree
    with each other — the chunking and the packed-row gather only
    reorganize exact u32 copies."""
    import jax.numpy as jnp

    from colormipsearch_tpu.oracle.pixel import shift_offsets

    rng = np.random.default_rng(17)
    h, w = 40, 64
    plans = [pixel_match.build_full_union_key_plan(
        _mk(rng, h, w, 200), 20, mirror=True, xy_shift=2,
        pix_color_fluctuation=1.0) for _ in range(16)]
    u_pos, _mu, q_pos, kl, _u2 = pixel_match.stack_union_pos_args(
        plans, h * w)
    _u, _m, qidx, qkl, _u2b = pixel_match.stack_union_qkey_args(
        plans, h * w)
    tabs = pixel_match.interval_table_arrays(0.01)
    offs = tuple((int(dx), int(dy)) for dx, dy in shift_offsets(2))
    pos_args = (jnp.asarray(u_pos), jnp.asarray(q_pos), jnp.asarray(kl),
                jnp.asarray(tabs[0]), jnp.asarray(tabs[1]))
    qk_args = (jnp.asarray(qidx), jnp.asarray(qkl),
               jnp.asarray(tabs[0]), jnp.asarray(tabs[1]))

    outs = {}
    for setting in ("1", "8", "16"):
        monkeypatch.setenv("CDS_EXPAND_VMAP", setting)
        # the chunking is baked at trace time: fresh traces per setting
        pixel_match.expand_union_tables_from_pos.clear_cache()
        pixel_match.expand_union_tables.clear_cache()
        lo, sp = pixel_match.expand_union_tables_from_pos(
            *pos_args, offsets=offs, w=w, h=h)
        qlo, qsp = pixel_match.expand_union_tables(*qk_args)
        outs[setting] = tuple(np.asarray(a) for a in (lo, sp, qlo, qsp))
    ref = outs["1"]
    for setting in ("8", "16"):
        for a, b in zip(ref, outs[setting]):
            assert (a == b).all(), setting
    assert (ref[0] == ref[2]).all() and (ref[1] == ref[3]).all(), \
        "positional vs qkey expansion differ"

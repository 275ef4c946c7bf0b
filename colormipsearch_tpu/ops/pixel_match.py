"""Batched device pixel-match (positive CDS) scoring kernel.

Device redesign of the reference hot loop
(cds/PixelMatchColorDepthSearchAlgorithm.calculateScore:235-263):

  * targets are packed ONCE into pixel-major [P, T] uint32 summary planes
    (ops/common.py), resident in device memory; a gather at one query
    position reads the lane-contiguous summaries of ALL T targets,
  * one kernel invocation scores one query against a whole target shard
    for every shift/mirror variant: scores[V, T] = sum over query
    positions of the match predicate,
  * the predicate is exact integer arithmetic for same-class pixels and
    float32-with-guard-band for the adjacent-class branches; pixels whose
    verdict falls inside the ambiguity band are counted separately so the
    (rare) affected pairs can be re-scored bit-exactly by the float64
    oracle on the host.

Numerical contract: outside the flagged band the predicate provably equals
the reference's float64 computation (margins between achievable rational
gaps and thresholds are >= 1/(255*255*b), orders of magnitude above both
float32 and float64 rounding error).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

import jax
import jax.numpy as jnp

from colormipsearch_tpu.constants import (
    BG_GB,
    BR_BG,
    CLASS_BG,
    CLASS_BR,
    CLASS_GB,
    CLASS_GR,
    CLASS_RB,
    CLASS_RG,
    GB_GR,
    GR_RG,
    RG_RB,
)
from colormipsearch_tpu.oracle import pixel as oracle_pixel
from colormipsearch_tpu.ops import common

# Adjacent-class compatibility table.  Each row:
#   (query class, target class,
#    (qs_mul, qp_mul, q_is_less), (ts_mul, tp_mul, t_is_less),
#    gap_is_sum_minus_2c, boundary constant)
# The ratio preconditions (e.g. r < 0.44) are exact as integer
# cross-multiplications: 25*s < 11*p  <=>  s/p < 0.44 in float64 (ties at
# equality agree because fl(s/p) == fl(0.44) is not < fl(0.44)).
_ADJ_TABLE = (
    (CLASS_BR, CLASS_BG, (25, 11, True), (50, 27, True), True, BR_BG),
    (CLASS_BG, CLASS_BR, (50, 27, True), (25, 11, True), True, BR_BG),
    (CLASS_BG, CLASS_GB, (5, 4, False), (5, 4, False), False, BG_GB),
    (CLASS_GB, CLASS_BG, (5, 4, False), (5, 4, False), False, BG_GB),
    (CLASS_GB, CLASS_GR, (10, 7, True), (10, 7, True), True, GB_GR),
    (CLASS_GR, CLASS_GB, (10, 7, True), (10, 7, True), True, GB_GR),
    (CLASS_GR, CLASS_RG, (5, 4, False), (5, 4, False), False, GR_RG),
    (CLASS_RG, CLASS_GR, (5, 4, False), (5, 4, False), False, GR_RG),
    (CLASS_RG, CLASS_RB, (10, 7, True), (10, 7, True), True, RG_RB),
    (CLASS_RB, CLASS_RG, (10, 7, True), (10, 7, True), True, RG_RB),
)

# float32 guard band around the z-tolerance for the adjacent-class gap;
# float32 evaluation error is bounded by ~5e-7, float64-vs-exact by ~3e-16.
ADJ_BAND = 1e-4

# Largest z-tolerance denominator for the exact same-class test: the
# f32-evaluated integer products must stay < 2^24 (b * 255 * 255), so
# fractions up to 1/258 of a percent stay exact; coarser denominators
# fall back to the banded-f32 ratio-gap branch.
_MAX_INT_DENOM = 258


@dataclasses.dataclass
class QueryPlan:
    """Host-side precomputation for one query (mask) image.

    Mirrors the reference's precomputed shifted/mirrored position arrays
    (PixelMatchColorDepthSearchAlgorithm ctor) in padded dense form.
    """
    positions: np.ndarray      # int32 [V, Q] target-lookup positions, -1 pad
    q_cls: np.ndarray          # int32 [Q]
    q_s: np.ndarray            # int32 [Q]
    q_p: np.ndarray            # int32 [Q]
    query_size: int            # true (unpadded) number of query positions
    n_straight: int            # variants [0:n_straight] are unmirrored
    mirror: bool
    ztol_num: int
    ztol_den: int

    @property
    def n_variants(self) -> int:
        return self.positions.shape[0]


def build_query_plan(query_rgb: np.ndarray, query_threshold: int, *,
                     mirror: bool, xy_shift: int,
                     pix_color_fluctuation,
                     excluded_region: np.ndarray | None = None,
                     pad_to: int | None = None) -> QueryPlan:
    """Build the padded position/attribute arrays for one query image."""
    h, w = query_rgb.shape[:2]
    fg = (query_rgb > query_threshold).any(axis=-1)
    if excluded_region is not None:
        fg &= ~excluded_region
    positions = np.flatnonzero(fg.reshape(-1)).astype(np.int64)
    q = positions.size

    # classify only the foreground (~0.1-1% of the plane)
    cls, s, p = oracle_pixel.classify_rgb(
        query_rgb.reshape(-1, 3)[positions])
    q_cls = cls.astype(np.int32)
    q_s = s.astype(np.int32)
    q_p = p.astype(np.int32)

    x = positions % w
    y = positions // w
    variants = []
    for dx, dy in oracle_pixel.shift_offsets(xy_shift):
        nx, ny = x + dx, y + dy
        ok = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < h)
        variants.append(np.where(ok, ny * w + nx, -1))
    n_straight = len(variants)
    if mirror:
        for v in list(variants):
            vx = v % w
            variants.append(np.where(v < 0, -1, v + (w - 1) - 2 * vx))
    pos = np.stack(variants).astype(np.int32) if q else \
        np.full((n_straight * (2 if mirror else 1), 0), -1, np.int32)

    q_pad = pad_to if pad_to is not None else _bucket(q)
    if q_pad < q:
        raise ValueError(f"pad_to {q_pad} < query size {q}")
    if q_pad > q:
        pos = np.pad(pos, ((0, 0), (0, q_pad - q)), constant_values=-1)
        q_cls = np.pad(q_cls, (0, q_pad - q))
        q_s = np.pad(q_s, (0, q_pad - q))
        q_p = np.pad(q_p, (0, q_pad - q))

    a, b = common.ztol_fraction(pix_color_fluctuation)
    return QueryPlan(pos, q_cls, q_s, q_p, q, n_straight, mirror, a, b)


def build_neg_query_plan(query_rgb: np.ndarray, query_threshold: int,
                         neg_query_rgb: np.ndarray, neg_query_threshold: int,
                         *, mirror_neg_query: bool, xy_shift: int,
                         pix_color_fluctuation,
                         excluded_region: np.ndarray | None = None,
                         pad_to: int | None = None) -> QueryPlan | None:
    """Build the negative-query plan for device scoring.

    Reference semantics (PixelMatchColorDepthSearchAlgorithm:36-57,195-217):
    the negative pass reads SOURCE pixels from the negative image at the
    POSITIVE query's positions, zipped with the shifted NEGATIVE query
    position arrays as target lookups, truncated to the shorter length.
    The returned plan's ``query_size`` is the TRUE negative-query
    foreground size (the divisor of the score subtraction), which may
    exceed the padded zip length.  Returns None when either side is empty.
    """
    h, w = query_rgb.shape[:2]
    fg = (query_rgb > query_threshold).any(axis=-1)
    neg_fg = (neg_query_rgb > neg_query_threshold).any(axis=-1)
    if excluded_region is not None:
        fg &= ~excluded_region
        neg_fg &= ~excluded_region
    positions = np.flatnonzero(fg.reshape(-1)).astype(np.int64)
    neg_positions = np.flatnonzero(neg_fg.reshape(-1)).astype(np.int64)
    neg_query_size = int(neg_positions.size)
    size = min(positions.size, neg_query_size)
    if size == 0:
        return None

    src = positions[:size]
    ncls, ns, np_ = oracle_pixel.classify_rgb(
        neg_query_rgb.reshape(-1, 3)[src])
    q_cls = ncls.astype(np.int32)
    q_s = ns.astype(np.int32)
    q_p = np_.astype(np.int32)

    x = neg_positions % w
    y = neg_positions // w
    variants = []
    for dx, dy in oracle_pixel.shift_offsets(xy_shift):
        nx, ny = x + dx, y + dy
        ok = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < h)
        variants.append(np.where(ok, ny * w + nx, -1)[:size])
    n_straight = len(variants)
    if mirror_neg_query:
        for v in list(variants):
            vx = v % w
            variants.append(np.where(v < 0, -1, v + (w - 1) - 2 * vx))
    pos = np.stack(variants).astype(np.int32)

    q_pad = pad_to if pad_to is not None else _bucket(size)
    if q_pad > size:
        pos = np.pad(pos, ((0, 0), (0, q_pad - size)), constant_values=-1)
        q_cls = np.pad(q_cls, (0, q_pad - size))
        q_s = np.pad(q_s, (0, q_pad - size))
        q_p = np.pad(q_p, (0, q_pad - size))

    a, b = common.ztol_fraction(pix_color_fluctuation)
    return QueryPlan(pos, q_cls, q_s, q_p, neg_query_size, n_straight,
                     mirror_neg_query, a, b)


def _bucket(q: int, minimum: int = 512) -> int:
    """Pad query sizes to the {1, 1.25, 1.5, 1.75} x 2^k bucket ladder
    (512, 640, 768, 896, 1024, 1280, ...): average padding waste ~11%
    and worst case 25%, vs up to 2x for plain powers of two, while the
    number of distinct kernel shapes (whose XLA compilations the
    persistent cache amortizes) stays small."""
    if q <= minimum:
        return minimum
    base = minimum
    while base * 2 < q:
        base *= 2
    for m in (4, 5, 6, 7, 8):
        n = base * m // 4
        if n >= q:
            return n
    return base * 2


@functools.lru_cache(maxsize=1)
def _adj_rule_tables():
    """Per-query-class adjacency rule tables.

    Every dominance class has at most TWO adjacent classes it can match
    (e.g. BG pairs with BR and GB), so instead of sweeping all 10 rows of
    _ADJ_TABLE per pair, each query pixel carries its <= 2 candidate
    rules; the kernel evaluates exactly those.  Arrays are indexed
    [class 0..6, rule slot 0..1]:
      tc       target class (0 = slot disabled)
      qms, qmp, qless   query-side ratio precondition (exact ints)
      tms, tmp, tless   target-side ratio precondition
      sign, offs        gap = sign * (q_r + t_r) + offs   (offs = -/+ 2c)
    """
    import numpy as _np

    shape = (7, 2)
    tc = _np.zeros(shape, _np.int32)
    qms = _np.zeros(shape, _np.int32)
    qmp = _np.zeros(shape, _np.int32)
    qless = _np.zeros(shape, bool)
    tms = _np.zeros(shape, _np.int32)
    tmp_ = _np.zeros(shape, _np.int32)
    tless = _np.zeros(shape, bool)
    sign = _np.zeros(shape, _np.float32)
    offs = _np.zeros(shape, _np.float32)
    slot = [0] * 7
    for qc, t, (a, b, ql), (c_, d, tl), plus, const in _ADJ_TABLE:
        k = slot[qc]
        slot[qc] += 1
        tc[qc, k] = t
        qms[qc, k], qmp[qc, k], qless[qc, k] = a, b, ql
        tms[qc, k], tmp_[qc, k], tless[qc, k] = c_, d, tl
        sign[qc, k] = 1.0 if plus else -1.0
        offs[qc, k] = _np.float32(-2.0 * const) if plus \
            else _np.float32(2.0 * const)
    return tc, qms, qmp, qless, tms, tmp_, tless, sign, offs


def query_side_rules(q_cls, q_s, q_p, *, ztol_num: int, ztol_den: int):
    """Per-query-pixel precomputation for the elementwise predicate.

    Folds the whole adjacent-class machinery of calculatePixelGap
    (:260-388) into at most two one-sided bound tests per query pixel:
    every adjacent-class branch is "target class == tc AND a one-sided
    ratio condition" because the target-side precondition and the gap
    threshold bound t_r from the SAME side —

        plus rules  (gap = (q_r - c) + (t_r - c) <= ztol):
            t_r <  pre_hi   and  t_r <= ztol + 2c - q_r
        minus rules (gap = (c - q_r) + (c - t_r) <= ztol):
            t_r >  pre_lo   and  t_r >= 2c - ztol - q_r

    so the per-element test collapses to one bound test on
    g = t_s - B*t_p (direction chosen by `upper`), with B precomputed
    here per (query pixel, rule slot).
    Boundary points (the strict-vs-non-strict distinction and all f32
    rounding) fall inside the ambiguity band and are flagged for the
    float64 oracle.

    Returns (same_cls, bq_s, bq_p, a_qp, tc, bound, sign):
      same_cls: int32 — q_cls where the same-class branch can fire
                (ratio > 0 per :262), else -1
      bq_s, bq_p, a_qp: f32 — ztol_den * q_s, ztol_den * q_p and
                ztol_num * q_p.  The same-class test
                |q_s*t_p - t_s*q_p| * b <= a * q_p * t_p runs entirely
                in f32: every product is < 2^24 (b*255*255 <= 1.66e7
                for b <= 255), so f32 arithmetic is EXACT and runs
                on FMA-capable float lanes instead of int32
                multiplies.
      tc:       int32 [2, ...] — adjacency rule target class (0 = off)
      bound:    f32  [2, ...] — ratio bound B
      upper:    bool [2, ...] — True for upper (t_r <= B), else lower
    """
    a, b = ztol_num, ztol_den
    ztol_f32 = jnp.float32(a / b)

    q_r = q_s.astype(jnp.float32) / jnp.maximum(q_p, 1).astype(jnp.float32)
    tc_t, qms_t, qmp_t, qless_t, tms_t, tmp_t, tless_t, sign_t, offs_t = \
        (jnp.asarray(t) for t in _adj_rule_tables())

    same_cls = jnp.where(q_s >= 1, q_cls, -1)
    bq_s = (b * q_s).astype(jnp.float32)
    bq_p = (b * q_p).astype(jnp.float32)
    a_qp = (a * q_p).astype(jnp.float32)

    tc = []
    bound = []
    upper = []
    for k in (0, 1):
        # query-side precondition (exact ints), folded into the rule's
        # target class (0 = rule disabled for this query pixel)
        qms = qms_t[q_cls, k]
        qmp = qmp_t[q_cls, k]
        q_lhs = qms * q_s - qmp * q_p
        pre_q = jnp.where(qless_t[q_cls, k], q_lhs < 0, q_lhs > 0)
        tc.append(jnp.where(pre_q, tc_t[q_cls, k], 0))
        # plus rules (sign_t == +1, offs = -2c): upper bound
        #   min(pre_hi, ztol + 2c - q_r)   with pre_hi = tmp/tms
        # minus rules (sign_t == -1, offs = +2c): lower bound
        #   max(pre_lo, 2c - ztol - q_r)
        pre_ratio = tmp_t[q_cls, k].astype(jnp.float32) / \
            jnp.maximum(tms_t[q_cls, k], 1).astype(jnp.float32)
        plus = sign_t[q_cls, k] > 0
        gap_bound = jnp.where(plus,
                              ztol_f32 - offs_t[q_cls, k] - q_r,
                              -ztol_f32 + offs_t[q_cls, k] - q_r)
        bound.append(jnp.where(plus,
                               jnp.minimum(pre_ratio, gap_bound),
                               jnp.maximum(pre_ratio, gap_bound)))
        upper.append(plus)
    return (same_cls, bq_s, bq_p, a_qp, jnp.stack(tc), jnp.stack(bound),
            jnp.stack(upper))


def element_predicate(q_cls, q_s, q_p, t_cls, t_s, t_p, t_max, *,
                      target_threshold: int, ztol_num: int, ztol_den: int):
    """Elementwise match predicate on pixel summaries (broadcastable).

    The single source of truth for the device decision: returns
    (match, flag) bool arrays where `flag` marks ambiguity-band pixels
    whose verdict must be re-checked by the float64 oracle.  Used by the
    hot kernel below AND validated exhaustively over every achievable
    ratio pair by the `-m slow` suite (tests/test_slow_exhaustive.py)
    against the reference semantics of
    cds/AbstractColorDepthSearchAlgorithm.calculatePixelGap:157-390.
    """
    rules = query_side_rules(q_cls, q_s, q_p, ztol_num=ztol_num,
                             ztol_den=ztol_den)
    return predicate_from_rules(
        rules, q_s, q_p, t_cls, t_s, t_p, t_max,
        target_threshold=target_threshold, ztol_num=ztol_num,
        ztol_den=ztol_den)


def predicate_from_rules(rules, q_s, q_p, t_cls, t_s, t_p, t_max, *,
                         target_threshold: int, ztol_num: int,
                         ztol_den: int):
    """The [elements]-shaped half of the predicate (see query_side_rules).

    Kept deliberately lean — this runs per (query pixel x target x
    variant) element in the hot kernel; everything foldable to the query
    side lives in query_side_rules."""
    a, b = ztol_num, ztol_den
    use_exact_same = b <= _MAX_INT_DENOM
    band = jnp.float32(ADJ_BAND)
    same_cls, bq_s, bq_p, a_qp, tc, bound, upper = rules

    # target_threshold < 0 means the threshold was folded into the pack
    # (pack_target_planes(data_threshold=...)): skip the per-element test
    # instead of trusting XLA to range-infer `(v & 0xFF) > -1` away, and
    # let DCE drop the t_max unpack
    valid = True if target_threshold < 0 else t_max > target_threshold
    ts_f = t_s.astype(jnp.float32)
    tp_f = t_p.astype(jnp.float32)

    same = (same_cls == t_cls) & (t_s >= 1)
    if use_exact_same:
        # exact-in-f32 integer arithmetic (see query_side_rules): every
        # product < 2^24, so these compares equal the exact-rational test
        lhs = jnp.abs(bq_s * tp_f - ts_f * bq_p)
        rhs = a_qp * tp_f
        m_same = same & (lhs <= rhs)
        f_same = same & (lhs == rhs)
    else:
        q_r = q_s.astype(jnp.float32) / \
            jnp.maximum(q_p, 1).astype(jnp.float32)
        t_r32 = ts_f / jnp.maximum(tp_f, 1)
        ztol_f32 = jnp.float32(a / b)
        gap = jnp.abs(t_r32 - q_r)
        m_same = same & (gap <= ztol_f32)
        f_same = same & (jnp.abs(gap - ztol_f32) < band)

    # the two rule slots target DISTINCT classes (a query class pairs
    # with at most two different adjacent classes), so at most one rule
    # can fire per element: select that rule's bound/direction by class
    # equality and evaluate a single bound test
    sel0 = t_cls == tc[0]
    sel1 = t_cls == tc[1]
    sel = (sel0 | sel1) & (t_cls > 0)
    bound_sel = jnp.where(sel0, bound[0], bound[1])
    upper_sel = jnp.where(sel0, upper[0], upper[1])
    g = ts_f - bound_sel * tp_f
    m_adj = sel & ((g <= 0) == upper_sel)
    f_adj = sel & (jnp.abs(g) < band * tp_f)

    match = valid & (m_same | m_adj)
    flag = valid & (f_same | f_adj)
    return match, flag


def score_query_against_planes_raw(t_planes: jax.Array, pos: jax.Array,
                                   q_cls: jax.Array, q_s: jax.Array,
                                   q_p: jax.Array, *, target_threshold: int,
                                   ztol_num: int, ztol_den: int):
    """Score one query plan against packed target planes.

    Args:
      t_planes: uint32 [P, T] packed target summaries (common.pack_*).
      pos:      int32 [V, Q] target-lookup positions (-1 = skip).
      q_cls, q_s, q_p: int32 [Q] query pixel summaries.
      target_threshold: data threshold (python int, static).
      ztol_num, ztol_den: exact rational z-tolerance (static).

    Returns:
      scores: int32 [V, T] matching-pixel counts per variant per target.
      flags:  int32 [V, T] count of ambiguity-band pixels (0 => exact).
    """

    # query-side precomputation hoisted out of the variant loop: the
    # adjacency rules collapse to per-pixel one-sided bounds so the
    # [Q, T] hot path needs no division and no two-sided rule sweeps
    rules = query_side_rules(q_cls, q_s, q_p, ztol_num=ztol_num,
                             ztol_den=ztol_den)
    same_cls, bq_s, bq_p, a_qp, tc, bound, upper = rules
    rules_b = (same_cls[:, None], bq_s[:, None], bq_p[:, None],
               a_qp[:, None], tc[:, :, None], bound[:, :, None],
               upper[:, :, None])

    def per_variant(_, pos_v):
        gathered = jnp.take(t_planes, jnp.maximum(pos_v, 0), axis=0)  # [Q,T]
        t_cls, t_s, t_p, t_max = common.unpack_summary(gathered)
        match, flag = predicate_from_rules(
            rules_b, q_s[:, None], q_p[:, None],
            t_cls, t_s, t_p, t_max,
            target_threshold=target_threshold,
            ztol_num=ztol_num, ztol_den=ztol_den)
        ok = (pos_v >= 0)[:, None]
        match &= ok
        flag &= ok
        return None, (match.sum(axis=0, dtype=jnp.int32),
                      flag.sum(axis=0, dtype=jnp.int32))

    n_variants = pos.shape[0]
    if n_variants <= 32:
        # unrolled: the variants are independent, so emitting them as
        # separate gathers+predicates lets XLA overlap memory gathers
        # with the predicates (lax.scan would serialize the iterations)
        outs = [per_variant(None, pos[v])[1] for v in range(n_variants)]
        scores = jnp.stack([o[0] for o in outs])
        flags = jnp.stack([o[1] for o in outs])
        return scores, flags
    _, (scores, flags) = jax.lax.scan(per_variant, None, pos)
    return scores, flags


score_query_against_planes = functools.partial(
    jax.jit,
    static_argnames=("target_threshold", "ztol_num", "ztol_den"))(
        score_query_against_planes_raw)


@functools.partial(
    jax.jit,
    static_argnames=("target_threshold", "ztol_num", "ztol_den",
                     "n_straight"))
def score_query_batch(t_planes: jax.Array, pos: jax.Array, q_cls: jax.Array,
                      q_s: jax.Array, q_p: jax.Array, *,
                      target_threshold: int, ztol_num: int, ztol_den: int,
                      n_straight: int):
    """Score a batch of B query plans in ONE dispatch.

    Args are the batched forms of score_query_against_planes
    (pos [B, V, Q], q_* [B, Q]).  Returns (best [B, T], mirrored [B, T],
    pair_flags [B, T]).  Batching amortizes per-dispatch latency — the
    analogue of the reference scoring many masks against the cached
    target stack inside one executor task.
    """

    def one(args):
        pos_b, cls_b, s_b, p_b = args
        scores, flags = score_query_against_planes_raw(
            t_planes, pos_b, cls_b, s_b, p_b,
            target_threshold=target_threshold,
            ztol_num=ztol_num, ztol_den=ztol_den)
        return reduce_variants_device(scores, flags, n_straight)

    return jax.lax.map(one, (pos, q_cls, q_s, q_p))


def score_query_against_split_planes_raw(t_sp: jax.Array, t_cls8: jax.Array,
                                         pos: jax.Array, q_cls: jax.Array,
                                         q_s: jax.Array, q_p: jax.Array, *,
                                         ztol_num: int, ztol_den: int):
    """Split-plane variant of score_query_against_planes_raw.

    Gathers 3 bytes/pixel (uint16 (p<<8)|s + uint8 cls) instead of the
    4-byte packed word.  The data threshold must be folded into the
    planes (common.pack_target_planes_split), so there is no t_max test.
    Bit-identical scores to the packed path by construction (same
    predicate on the same summaries).
    """
    rules = query_side_rules(q_cls, q_s, q_p, ztol_num=ztol_num,
                             ztol_den=ztol_den)
    same_cls, bq_s, bq_p, a_qp, tc, bound, upper = rules
    rules_b = (same_cls[:, None], bq_s[:, None], bq_p[:, None],
               a_qp[:, None], tc[:, :, None], bound[:, :, None],
               upper[:, :, None])

    def per_variant(_, pos_v):
        idx = jnp.maximum(pos_v, 0)
        g_sp = jnp.take(t_sp, idx, axis=0).astype(jnp.int32)    # [Q,T]
        t_cls = jnp.take(t_cls8, idx, axis=0).astype(jnp.int32)
        t_p = g_sp >> 8
        t_s = g_sp & 0xFF
        match, flag = predicate_from_rules(
            rules_b, q_s[:, None], q_p[:, None],
            t_cls, t_s, t_p, jnp.int32(0),
            target_threshold=-1,
            ztol_num=ztol_num, ztol_den=ztol_den)
        ok = (pos_v >= 0)[:, None]
        match &= ok
        flag &= ok
        return None, (match.sum(axis=0, dtype=jnp.int32),
                      flag.sum(axis=0, dtype=jnp.int32))

    n_variants = pos.shape[0]
    if n_variants <= 32:
        outs = [per_variant(None, pos[v])[1] for v in range(n_variants)]
        return (jnp.stack([o[0] for o in outs]),
                jnp.stack([o[1] for o in outs]))
    _, (scores, flags) = jax.lax.scan(per_variant, None, pos)
    return scores, flags


@functools.partial(
    jax.jit,
    static_argnames=("ztol_num", "ztol_den", "n_straight"))
def score_query_batch_split(t_sp: jax.Array, t_cls8: jax.Array,
                            pos: jax.Array, q_cls: jax.Array,
                            q_s: jax.Array, q_p: jax.Array, *,
                            ztol_num: int, ztol_den: int,
                            n_straight: int):
    """Batched split-plane scoring (see score_query_batch)."""

    def one(args):
        pos_b, cls_b, s_b, p_b = args
        scores, flags = score_query_against_split_planes_raw(
            t_sp, t_cls8, pos_b, cls_b, s_b, p_b,
            ztol_num=ztol_num, ztol_den=ztol_den)
        return reduce_variants_device(scores, flags, n_straight)

    return jax.lax.map(one, (pos, q_cls, q_s, q_p))


def reduce_variants_device(scores: jax.Array, flags: jax.Array,
                           n_straight: int):
    """Device-side variant reduction: (best, mirrored, pair_flags).

    Same semantics as reduce_variant_scores (mirror wins only when
    strictly greater than the best straight variant)."""
    straight = scores[:n_straight].max(axis=0)
    if scores.shape[0] > n_straight:
        mirrored = scores[n_straight:].max(axis=0)
        best = jnp.maximum(straight, mirrored)
        is_mirrored = mirrored > straight
    else:
        best = straight
        is_mirrored = jnp.zeros_like(straight, dtype=jnp.bool_)
    return best, is_mirrored, flags.sum(axis=0, dtype=jnp.int32)


# --- rank-key interval predicate ------------------------------------------
#
# Exact alternative to the banded predicate above: targets pack to
# key = (cls << 15) | rank-of-ratio (ops/common.pack_target_planes_keys)
# and each query pixel carries THREE precomputed key intervals (same
# class + <= 2 adjacent classes).  The per-element test is three unsigned
# range checks on the gathered key — ~3x fewer vector intermediates than
# predicate_from_rules and, because the interval endpoints are found by
# bisecting the float64 oracle itself (oracle/pixel.pixel_gap), the
# device verdict is bit-identical to the reference with NO ambiguity
# band and NO oracle fallback.
#
# Faithfulness rests on the match set being an interval of the ratio
# order for every (query pixel, target class): same-class matches form
# the window |r2 - r1| <= z (r2 > 0); each adjacent-class rule bounds r2
# from one side only (its precondition and its gap bound point the same
# way), and IEEE-754 rounding preserves weak monotonicity, so bisection
# probes of the oracle land exactly on the f64 verdict boundary.  The
# `-m slow` suite proves membership equality for every achievable ratio
# pair of every class pair (tests/test_slow_exhaustive.py).

# encodes an empty interval: (key - EMPTY_LO) mod 2^32 > any span for
# every achievable key (< 2^18)
_EMPTY_LO = np.uint32(1 << 31)


@functools.lru_cache(maxsize=1)
def _adj_direction_tables():
    """Per-query-class adjacency slots for the interval build.

    Returns (tc, prefix): int32/bool [2, 7] arrays — slot k's target
    class (0 = none) and whether its match set is a PREFIX of the ratio
    order ("plus" rules: gap grows with t_r) or a suffix ("minus").
    """
    tc = np.zeros((2, 7), np.int32)
    prefix = np.zeros((2, 7), bool)
    slot = [0] * 7
    for qc, t, _q, _t, plus, _c in _ADJ_TABLE:
        k = slot[qc]
        slot[qc] += 1
        tc[k, qc] = t
        prefix[k, qc] = plus
    return tc, prefix


def _bisect_key_intervals(q_cls: np.ndarray, q_rank: np.ndarray,
                          z_tol: float):
    """Key intervals by f64-oracle bisection for (class, ratio-rank)
    query summaries (the core of build_key_intervals; see there).

    The oracle predicate depends on the query pixel only through
    (class, float64 ratio), and equal rationals give identical float64
    quotients, so (cls, rank) fully determines the intervals.
    """
    from colormipsearch_tpu.ops.common import (
        KEY_RANK_BITS,
        ratio_rank_table,
    )

    vals, _ = ratio_rank_table()
    n_ratios = vals.size
    q_cls = np.asarray(q_cls, np.int64)
    q_rank = np.asarray(q_rank, np.int64)
    q_r = vals[q_rank]
    n_q = q_cls.shape[0]

    lo = np.full((3, n_q), _EMPTY_LO, np.uint32)
    span = np.zeros((3, n_q), np.uint32)

    def probe(tc, j):
        return oracle_pixel.pixel_gap(q_cls, q_r, tc, vals[j]) <= z_tol

    def fill(slot, act, tc, lo_rank, hi_rank):
        key_lo = (tc.astype(np.int64) << KEY_RANK_BITS) + lo_rank
        key_hi = (tc.astype(np.int64) << KEY_RANK_BITS) + hi_rank
        lo[slot] = np.where(act, key_lo, int(_EMPTY_LO)).astype(np.uint32)
        span[slot] = np.where(act, key_hi - key_lo, 0).astype(np.uint32)

    # slot 0: same class.  Non-empty iff the ratio is positive (r2 > 0
    # is also required, hence ranks start at 1); the window contains
    # q's own rank (gap 0), so bisect each edge from there.
    act = (q_cls > 0) & (q_rank >= 1)
    anchor = np.maximum(q_rank, 1)
    # the bisection assumes the anchor matches (gap 0 <= z); with a
    # negative or NaN tolerance nothing matches and the degenerate
    # edges would otherwise underflow span to "match everything"
    act &= probe(q_cls, anchor)
    lo_i, hi_i = np.ones(n_q, np.int64), anchor.astype(np.int64)
    for _ in range(16):  # first j in [1, q_rank] with match (monotone)
        mid = (lo_i + hi_i) // 2
        m = probe(q_cls, mid)
        hi_i = np.where(m, mid, hi_i)
        lo_i = np.where(m, lo_i, mid + 1)
    left = lo_i
    lo_i, hi_i = anchor.astype(np.int64), np.full(n_q, n_ratios - 1)
    for _ in range(16):  # last j in [q_rank, R-1] with match
        mid = (lo_i + hi_i + 1) // 2
        m = probe(q_cls, mid)
        lo_i = np.where(m, mid, lo_i)
        hi_i = np.where(m, hi_i, mid - 1)
    fill(0, act, q_cls, left, lo_i)

    # slots 1..2: adjacent classes.  "plus" rules match a prefix of the
    # ratio order (both the precondition and the gap bound cap r2 from
    # above), "minus" rules a suffix; the closed end decides emptiness.
    tc_tab, prefix_tab = _adj_direction_tables()
    for k in (0, 1):
        tc = tc_tab[k][q_cls]
        pref = prefix_tab[k][q_cls]
        end = np.where(pref, 0, n_ratios - 1)
        act = (tc > 0) & probe(tc, end)
        lo_i = np.zeros(n_q, np.int64)
        hi_i = np.full(n_q, n_ratios - 1, np.int64)
        for _ in range(16):
            mid = np.where(pref, (lo_i + hi_i + 1) // 2,
                           (lo_i + hi_i) // 2)
            m = probe(tc, mid)
            lo_i = np.where(pref,
                            np.where(m, mid, lo_i),
                            np.where(m, lo_i, mid + 1))
            hi_i = np.where(pref,
                            np.where(m, hi_i, mid - 1),
                            np.where(m, mid, hi_i))
        fill(k + 1, act, tc,
             np.where(pref, 0, lo_i), np.where(pref, lo_i, n_ratios - 1))
    return lo, span


@functools.lru_cache(maxsize=4)
def _key_interval_table(z_tol: float):
    """(lo, span) uint32 [3, 7 << KEY_RANK_BITS] interval tables for one
    z-tolerance, indexed by the query pixel's OWN key
    (cls << KEY_RANK_BITS) | rank.  Built once by bisecting every
    achievable (class, rank) pair (~119k) and cached per tolerance —
    plan builds then cost a table gather instead of re-running the
    bisections per pixel per lane (the full-union build probes each
    query pixel up to 18x otherwise)."""
    from colormipsearch_tpu.ops.common import (
        KEY_RANK_BITS,
        ratio_rank_table,
    )

    vals, _ = ratio_rank_table()
    n_ratios = vals.size
    cls = np.repeat(np.arange(1, 7, dtype=np.int64), n_ratios)
    rank = np.tile(np.arange(n_ratios, dtype=np.int64), 6)
    lo, span = _bisect_key_intervals(cls, rank, z_tol)
    n = 7 << KEY_RANK_BITS
    tab_lo = np.full((3, n), _EMPTY_LO, np.uint32)
    tab_span = np.zeros((3, n), np.uint32)
    idx = (cls << KEY_RANK_BITS) | rank
    tab_lo[:, idx] = lo
    tab_span[:, idx] = span
    return tab_lo, tab_span


@functools.lru_cache(maxsize=4)
def _key_interval_table2(z_tol: float):
    """Slot-compacted twin of _key_interval_table: (lo, span) uint32
    [2, 7 << KEY_RANK_BITS] plus per-key metadata for the segmented
    kernel: ``any2`` bool [n_keys] (second window live) and
    ``disjoint_ok`` (True iff for EVERY key the live windows sit in
    distinct class segments — the proof that the segmented kernel's
    window-indicator sums need no OR).

    Compacting once at table build removes the per-plan
    compact_interval_slots pass (the heaviest part of the ~39 ms
    full-union plan build) and shrinks the per-lane gathers by 1/3.
    """
    from colormipsearch_tpu.ops.common import KEY_RANK_BITS

    tab_lo3, tab_span3 = _key_interval_table(z_tol)
    ne = ~((tab_lo3 == _EMPTY_LO) & (tab_span3 == 0))  # [3, n]
    order = np.argsort(~ne, axis=0, kind="stable")
    lo = np.take_along_axis(tab_lo3, order, axis=0)
    span = np.take_along_axis(tab_span3, order, axis=0)
    ne = np.take_along_axis(ne, order, axis=0)
    if ne[2].any():
        # 3 live windows at this tolerance: callers fall back to the
        # uncompacted 3-slot path (never observed at production
        # tolerances; proven per tolerance here, not assumed)
        return None
    seg_lo = lo >> KEY_RANK_BITS
    seg_hi = (lo + span) >> KEY_RANK_BITS
    both = ne[0] & ne[1]
    disjoint_ok = bool((~both | ((seg_lo[0] != seg_lo[1])
                                 & (seg_lo[0] == seg_hi[0])
                                 & (seg_lo[1] == seg_hi[1]))).all())
    return (np.ascontiguousarray(lo[:2]),
            np.ascontiguousarray(span[:2]),
            np.ascontiguousarray(ne[1]), disjoint_ok)


def build_key_intervals(q_cls: np.ndarray, q_s: np.ndarray,
                        q_p: np.ndarray, z_tol: float):
    """Per-query-pixel key intervals (lo uint32 [3, Q], span uint32 [3, Q]).

    A target key k matches query pixel i iff
    (k - lo[slot, i]) mod 2^32 <= span[slot, i] for some slot.  Endpoints
    are found by vectorized bisection of the float64 oracle predicate
    (pixel_gap(q, t) <= z_tol), so membership equals the reference's f64
    verdict exactly — including the query-side rule preconditions, which
    the oracle evaluates internally (a failed precondition makes every
    probe miss and the interval comes out empty).  The bisections run
    once per (class, rank, tolerance) via a cached table
    (_key_interval_table); this is a gather.
    """
    from colormipsearch_tpu.ops.common import (
        KEY_RANK_BITS,
        ratio_rank_table,
    )

    _, rank_tab = ratio_rank_table()
    q_cls = np.asarray(q_cls, np.int64)
    q_s = np.asarray(q_s, np.int64)
    q_p = np.asarray(q_p, np.int64)
    rank = rank_tab[np.minimum(q_s, 255), np.minimum(q_p, 255)]
    # class 0 (padded / inactive) maps to key 0, whose table entries are
    # the initialization value: the empty interval
    key = np.where(q_cls > 0, (q_cls << KEY_RANK_BITS) | rank, 0)
    tab_lo, tab_span = _key_interval_table(float(z_tol))
    return tab_lo[:, key], tab_span[:, key]


@dataclasses.dataclass
class KeyQueryPlan:
    """Rank-key form of QueryPlan: positions are sentinel-encoded
    (padded / out-of-bounds lanes point at the planes' all-zero row P)
    and per-pixel predicates are three key intervals."""
    positions: np.ndarray      # int32 [V, Q], sentinel = n_pixels
    lo: np.ndarray             # uint32 [3, Q]
    span: np.ndarray           # uint32 [3, Q]
    query_size: int
    n_straight: int
    mirror: bool

    @property
    def n_variants(self) -> int:
        return self.positions.shape[0]


def key_plan_from_query_plan(plan: QueryPlan, n_pixels: int,
                             pix_color_fluctuation) -> KeyQueryPlan:
    """Convert a built QueryPlan for the key kernel.

    `n_pixels` is H*W of the image the positions index (the sentinel
    row); the z-tolerance re-derives from the fluctuation value the
    same way the reference does (double division by 100).
    """
    pos = np.where(plan.positions < 0, n_pixels,
                   plan.positions).astype(np.int32)
    lo, span = build_key_intervals(
        plan.q_cls, plan.q_s, plan.q_p,
        float(pix_color_fluctuation) / 100.0)
    return KeyQueryPlan(pos, lo, span, plan.query_size,
                        plan.n_straight, plan.mirror)


def score_query_against_key_planes_raw(t_keys: jax.Array, pos: jax.Array,
                                       lo: jax.Array, span: jax.Array):
    """Key-plane scoring: one query plan against [P+1, T] key planes.

    Args:
      t_keys: int32 [P+1, T] rank-key planes (sentinel row appended).
      pos:    int32 [V, Q] sentinel-encoded positions.
      lo, span: uint32 [3, Q] key intervals.

    Returns int32 [V, T] exact matching-pixel counts (no flags — the
    interval predicate has no ambiguity band).
    """
    lo0, lo1, lo2 = lo[0][:, None], lo[1][:, None], lo[2][:, None]
    sp0, sp1, sp2 = span[0][:, None], span[1][:, None], span[2][:, None]

    def per_variant(pos_v):
        w = jnp.take(t_keys, pos_v, axis=0).astype(jnp.uint32)  # [Q, T]
        m = ((w - lo0) <= sp0) | ((w - lo1) <= sp1) | ((w - lo2) <= sp2)
        return m.sum(axis=0, dtype=jnp.int32)

    n_variants = pos.shape[0]
    if n_variants <= 32:
        return jnp.stack([per_variant(pos[v]) for v in range(n_variants)])
    return jax.lax.map(per_variant, pos)


@functools.partial(jax.jit, static_argnames=("n_straight",))
def score_query_batch_keys(t_keys: jax.Array, pos: jax.Array,
                           lo: jax.Array, span: jax.Array, *,
                           n_straight: int):
    """Batched key-plane scoring (see score_query_batch).

    pos [B, V, Q], lo/span [B, 3, Q] -> (best [B, T], mirrored [B, T],
    pair_flags [B, T] — always zero, kept for interface parity)."""

    def one(args):
        pos_b, lo_b, span_b = args
        scores = score_query_against_key_planes_raw(
            t_keys, pos_b, lo_b, span_b)
        return reduce_variants_device(
            scores, jnp.zeros_like(scores), n_straight)

    return jax.lax.map(one, (pos, lo, span))


def reduce_variant_scores(scores: np.ndarray, plan: QueryPlan):
    """[V, T] per-variant scores -> (best [T], mirrored [T]) per reference
    max semantics (mirror wins only when strictly greater)."""
    straight = scores[:plan.n_straight].max(axis=0)
    if plan.mirror:
        mirrored = scores[plan.n_straight:].max(axis=0)
        best = np.maximum(straight, mirrored)
        return best, mirrored > straight
    return straight, np.zeros(scores.shape[1], dtype=bool)


# --- x-union lane form of the rank-key kernel ------------------------------
#
# The 9 xy-shift variants gather row sets that overlap heavily in x (the
# shifts form a {dy} x {dx} grid): for each dy, the three dx-shifted
# position sets share the x-dilated union U = {q + dx}.  Gathering U once
# per dy-set (2*3 gathers instead of 18) and evaluating the dx variants as
# predicate LANES with per-lane interval constants halves the gathered
# rows/bytes for 1.5x more range tests — a trade that pays when the
# gathers, not the tests, bound the kernel; the interval predicate is
# ~3x lighter than the banded rules, which is what makes it pay.
#
# Bit-exactness: a union row u on query row y serves lane dx iff
# q = u - dx is a query position with q.x + dx in-bounds — exactly the
# classic variant's membership rule; inactive (row, lane) elements carry
# empty intervals (lo = _EMPTY_LO, span = 0) that no key can satisfy, and
# out-of-bounds dy rows gather the all-zero sentinel row, whose key 0 is
# outside every real interval (active lo >= 1 << KEY_RANK_BITS).


@dataclasses.dataclass
class UnionKeyPlan:
    """Host-side precomputation for the x-union lane key kernel."""
    u_pos: np.ndarray      # int32 [S, U] straight dy-set positions,
    #                        sentinel-encoded (= n_pixels)
    mu_pos: np.ndarray     # int32 [S or 0, U] mirrored dy-set positions
    lane_lo: np.ndarray    # uint32 [L, 3, U] per-lane key intervals
    lane_span: np.ndarray  # uint32 [L, 3, U]
    query_size: int        # true (unpadded) number of query positions
    mirror: bool
    # slot-2 segmentation (full-union plans): elements are PERMUTED so
    # the ones with a live second interval window in ANY lane form the
    # prefix [0, u2); the kernel then runs slot-2 tests only there
    # (~21% of elements at production tolerances).
    # -1 = unsegmented (x-union plans, or a single-slot table).
    u2: int = -1
    # per-(lane, element) QUERY KEYS int32 [L, U] (0 = inactive) — the
    # compressed wire form of the lane tables: the device gathers
    # lo/span from the shared per-tolerance interval table instead of
    # receiving the ~740 KB/mask expanded tables (~3.5x less plan-arg
    # upload; decisive when thousands of masks stream over a slow
    # host->device link).  None on the 3-slot fallback path.
    qkeys: np.ndarray | None = None
    z_tol: float | None = None
    # factored qkey wire form (2x smaller again): qidx uint16 [L, U]
    # indexes key_list int32 [Q_pad + 1] (last entry = 0, the inactive
    # slot); qkeys[j, u] == key_list[qidx[j, u]].  Present iff qkeys is.
    qidx: np.ndarray | None = None
    key_list: np.ndarray | None = None
    # positional wire form (the smallest): the flat query positions
    # themselves — the device derives qidx from (u_pos, q_pos,
    # offsets) via a pos_index scatter + gathers
    # (expand_union_tables_from_pos), so the per-(lane, element) index
    # matrix never crosses the wire at all (~14 KB vs 92 KB per mask).
    q_pos: np.ndarray | None = None

    @property
    def n_sets(self) -> int:
        return self.u_pos.shape[0]

    @property
    def n_lanes(self) -> int:
        if self.lane_lo is not None:
            return self.lane_lo.shape[0]
        return (self.qkeys if self.qkeys is not None
                else self.qidx).shape[0]

    @property
    def n_straight(self) -> int:
        return self.n_sets * self.n_lanes


def compact_interval_slots(lane_lo: np.ndarray, lane_span: np.ndarray):
    """Drop always-empty interval slots from [..., 3, U] lane tables.

    A key's windows live in distinct class segments (same-class plus up
    to two adjacent-class rules), but at production tolerances at most
    TWO are ever non-empty for any (class, rank) — verified here per
    plan, not assumed — so the third per-element range test in
    score_query_union_keys_raw is dead weight.  Slots are compacted
    per (lane, row) (which slot holds a window is irrelevant: the
    kernel ORs them) and trailing all-empty slots are sliced off."""
    ne = ~((lane_lo == _EMPTY_LO) & (lane_span == 0))
    order = np.argsort(~ne, axis=-2, kind="stable")
    lo = np.take_along_axis(lane_lo, order, axis=-2)
    sp = np.take_along_axis(lane_span, order, axis=-2)
    ne = np.take_along_axis(ne, order, axis=-2)
    used = ne.any(axis=tuple(i for i in range(ne.ndim) if i != ne.ndim - 2))
    # the per-row front-packing makes `used` a prefix (slot s used only
    # if every earlier slot is), so its sum is the slot count
    n_slots = max(int(used.sum()), 1)
    return (np.ascontiguousarray(lo[..., :n_slots, :]),
            np.ascontiguousarray(sp[..., :n_slots, :]))


def _select_query_foreground(query_rgb: np.ndarray,
                             query_threshold: int,
                             excluded_region: np.ndarray | None):
    """(flat positions int64 [Q], rgb uint8 [Q, 3]) of the query
    foreground.  Uses the native threaded COO pass when available (the
    full-plane numpy any-reduce was the plan build's largest single
    cost at production mask counts); numpy otherwise — identical
    output either way."""
    sel = None
    try:
        from colormipsearch_tpu.io import native_decoder
        if (query_rgb.flags.c_contiguous
                and query_rgb.dtype == np.uint8
                and query_rgb.ndim == 3 and query_rgb.shape[-1] == 3):
            sel = native_decoder.coo_select(
                query_rgb[None], query_threshold)
    except ImportError:
        pass
    if sel is not None:
        pos0, _t, vals = sel
        if excluded_region is not None:
            keep = ~excluded_region.reshape(-1)[pos0]
            pos0 = pos0[keep]
            vals = vals[keep]
        return pos0.astype(np.int64), vals
    fg = (query_rgb > query_threshold).any(axis=-1)
    if excluded_region is not None:
        fg &= ~excluded_region
    positions = np.flatnonzero(fg.reshape(-1)).astype(np.int64)
    return positions, query_rgb.reshape(-1, 3)[positions]


def offsets_form_grid(xy_shift: int) -> bool:
    """True when shift_offsets(xy_shift) is a full {dx} x {dy} grid —
    the precondition of the x-union lane factorization (holds for the
    production xy_shift in {0, 2}; not for > 2)."""
    offsets = oracle_pixel.shift_offsets(xy_shift)
    dxs = sorted({dx for dx, _ in offsets})
    dys = sorted({dy for _, dy in offsets})
    return {(dx, dy) for dx in dxs for dy in dys} == set(offsets)


def build_union_key_plan(query_rgb: np.ndarray, query_threshold: int, *,
                         mirror: bool, xy_shift: int,
                         pix_color_fluctuation,
                         excluded_region: np.ndarray | None = None,
                         pad_to: int | None = None
                         ) -> UnionKeyPlan | None:
    """Build the x-union lane plan (see UnionKeyPlan).

    Returns None when the shift offsets do not form a {dy} x {dx} grid
    (they do for the production xy_shift in {0, 2}); callers fall back
    to the classic key plan.
    """
    if not offsets_form_grid(xy_shift):
        return None
    offsets = oracle_pixel.shift_offsets(xy_shift)
    dxs = sorted({dx for dx, _ in offsets})
    dys = sorted({dy for _, dy in offsets})

    h, w = query_rgb.shape[:2]
    n_pixels = h * w
    positions, vals = _select_query_foreground(
        query_rgb, query_threshold, excluded_region)

    # classify only the foreground; pos_index maps a flat pixel back to
    # its row in the classified arrays (-1 = not a query position)
    cls, s, p = oracle_pixel.classify_rgb(vals)
    pos_index = np.full(n_pixels, -1, np.int64)
    pos_index[positions] = np.arange(positions.size)

    # x-dilated union of the query support (flat positions; dx shifts
    # that leave the row are skipped, like the reference's -1 sentinel)
    x = positions % w
    union = np.unique(np.concatenate(
        [(positions + dx)[(x + dx >= 0) & (x + dx < w)] for dx in dxs])) \
        if positions.size else np.empty(0, np.int64)
    u_count = union.size
    ux = union % w
    uy = union // w

    # per-lane interval constants: lane dx at union row u reads query
    # pixel q = u - dx (same image row, must be a query position);
    # inactive elements get class 0, which build_key_intervals maps to
    # the empty interval
    ztol = float(pix_color_fluctuation) / 100.0
    lane_lo = np.empty((len(dxs), 3, u_count), np.uint32)
    lane_span = np.empty_like(lane_lo)
    for j, dx in enumerate(dxs):
        qx = ux - dx
        src = union - dx
        # qx in [0, w) keeps src on the same row and inside the image
        jj = pos_index[np.clip(src, 0, n_pixels - 1)]
        active = (qx >= 0) & (qx < w) & (jj >= 0)
        idx = np.where(active, jj, 0)
        lane_lo[j], lane_span[j] = build_key_intervals(
            np.where(active, cls[idx], 0), np.where(active, s[idx], 0),
            np.where(active, p[idx], 0), ztol)

    # dy row sets (straight + mirrored); y overflow -> sentinel row
    u_pos = np.full((len(dys), u_count), n_pixels, np.int32)
    mu_pos = np.full((len(dys) if mirror else 0, u_count), n_pixels,
                     np.int32)
    mirror_u = union + (w - 1) - 2 * ux
    for i, dy in enumerate(dys):
        ok = (uy + dy >= 0) & (uy + dy < h)
        u_pos[i] = np.where(ok, union + dy * w, n_pixels)
        if mirror:
            mu_pos[i] = np.where(ok, mirror_u + dy * w, n_pixels)

    lane_lo, lane_span = compact_interval_slots(lane_lo, lane_span)
    plan = UnionKeyPlan(u_pos, mu_pos, lane_lo, lane_span,
                        int(positions.size), mirror)
    return pad_union_key_plan(
        plan, pad_to if pad_to is not None else _bucket(u_count), n_pixels)


def build_full_union_key_plan(query_rgb: np.ndarray, query_threshold: int,
                              *, mirror: bool, xy_shift: int,
                              pix_color_fluctuation,
                              excluded_region: np.ndarray | None = None,
                              pad_to: int | None = None,
                              light: bool = False) -> UnionKeyPlan:
    """Full (x+y) union form: ONE gathered row set per orientation, every
    shift offset an interval lane (S=1, L=n_offsets in UnionKeyPlan
    terms).  ~0.5x the gathered rows of the x-union form for ~1.5x the
    range tests; unlike the x-union it needs no {dx} x {dy} grid, so it
    covers any xyShift.  Same kernel (score_query_*_union_keys)."""
    offsets = oracle_pixel.shift_offsets(xy_shift)

    h, w = query_rgb.shape[:2]
    n_pixels = h * w
    positions, vals = _select_query_foreground(
        query_rgb, query_threshold, excluded_region)

    # classify only the foreground; pos_index maps a flat pixel back to
    # its row in the classified arrays (-1 = not a query position)
    cls, s, p = oracle_pixel.classify_rgb(vals)
    pos_index = np.full(n_pixels, -1, np.int64)
    pos_index[positions] = np.arange(positions.size)

    # union of every valid shifted position (shifts that leave the image
    # are skipped per offset, like the reference's -1 sentinel)
    x = positions % w
    y = positions // w
    parts = [(positions + dx + dy * w)
             [(x + dx >= 0) & (x + dx < w) & (y + dy >= 0) & (y + dy < h)]
             for dx, dy in offsets]
    union = np.unique(np.concatenate(parts)) if positions.size \
        else np.empty(0, np.int64)
    u_count = union.size
    ux = union % w
    uy = union // w

    # lane (dx, dy) at union element u reads query pixel q = u - dx -
    # dy*w (same-row x and in-image y required); inactive elements get
    # class 0 -> the empty interval
    from colormipsearch_tpu.ops.common import (
        KEY_RANK_BITS,
        ratio_rank_table,
    )

    ztol = float(pix_color_fluctuation) / 100.0
    tab2 = _key_interval_table2(ztol)
    if tab2 is not None:
        # fast path: slot-compacted per-key table — one key lookup per
        # query pixel, then per-lane table gathers (no per-plan
        # compaction pass)
        tab_lo, tab_span, tab_any2, disjoint_ok = tab2
        _, rank_tab = ratio_rank_table()
        key_q = np.where(
            cls > 0,
            (cls.astype(np.int64) << KEY_RANK_BITS)
            | rank_tab[np.minimum(s, 255), np.minimum(p, 255)],
            0)
        n_slots0 = 2
    else:
        disjoint_ok = False
        n_slots0 = 3
    n_q = positions.size
    factored = tab2 is not None and n_q < 65535
    qkeys = qidx = key_list = q_pos = None
    if tab2 is not None:
        # all lanes at once: [L, U] geometry, one pos_index gather, one
        # key gather (the per-lane python loop was the plan build's
        # second-largest cost)
        offs = np.asarray(offsets, np.int64)
        dxs = offs[:, 0][:, None]
        dys = offs[:, 1][:, None]
        qx = ux[None, :] - dxs
        qy = uy[None, :] - dys
        src = union[None, :] - dxs - dys * w
        jj = pos_index[np.clip(src, 0, n_pixels - 1)]
        active = ((qx >= 0) & (qx < w) & (qy >= 0) & (qy < h)
                  & (jj >= 0))
        k_lane = np.where(active, key_q[np.where(active, jj, 0)], 0)
        lane_any2 = tab_any2[k_lane]
        if factored:
            qidx = np.where(active, jj, n_q).astype(np.uint16)
            q_pos = positions.astype(np.int32)
            # key_list[q] = the query pixel's key; the trailing slot is
            # the inactive 0-key every out-of-lane element points at
            key_list = np.zeros(n_q + 1, np.int32)
            key_list[:n_q] = key_q.astype(np.int32)
        if light and factored and disjoint_ok:
            # the engine's wire form never touches the expanded tables
            # or the full qkeys matrix: skip materializing them (the
            # dominant remaining plan-build cost at production counts)
            lane_lo = lane_span = None
        else:
            qkeys = k_lane.astype(np.int32)
            lane_lo = np.ascontiguousarray(
                np.swapaxes(tab_lo[:, k_lane], 0, 1))
            lane_span = np.ascontiguousarray(
                np.swapaxes(tab_span[:, k_lane], 0, 1))
    else:
        lane_lo = np.empty((len(offsets), n_slots0, u_count), np.uint32)
        lane_span = np.empty_like(lane_lo)
        lane_any2 = np.zeros((len(offsets), u_count), bool)
        for j, (dx, dy) in enumerate(offsets):
            qx = ux - dx
            qy = uy - dy
            src = union - dx - dy * w
            jj = pos_index[np.clip(src, 0, n_pixels - 1)]
            active = ((qx >= 0) & (qx < w) & (qy >= 0) & (qy < h)
                      & (jj >= 0))
            idx = np.where(active, jj, 0)
            lane_lo[j], lane_span[j] = build_key_intervals(
                np.where(active, cls[idx], 0),
                np.where(active, s[idx], 0),
                np.where(active, p[idx], 0), ztol)

    # one straight row set; the mirrored set reuses the lane table —
    # mirror(q + dx + dy*w) = mirror_x(q) - dx + dy*w, so it covers the
    # (-dx, dy) shifts of the mirrored query, a complete set because
    # {dx} is symmetric
    u_pos = union.astype(np.int32).reshape(1, u_count)
    mu_pos = (union + (w - 1) - 2 * ux).astype(np.int32) \
        .reshape(1, u_count) if mirror else np.zeros((0, u_count),
                                                     np.int32)
    if tab2 is None:
        lane_lo, lane_span = compact_interval_slots(lane_lo, lane_span)
    if not disjoint_ok:
        # the qkey kernel ADDS the two slots' indicator sums, valid
        # only under the per-table disjointness proof
        qkeys = None
        qidx = key_list = q_pos = None
    u2 = -1
    two_slots = (tab2 is not None if lane_lo is None
                 else lane_lo.shape[1] == 2)
    if two_slots and u_count and disjoint_ok:
        # slot-2 segmentation: permute elements so those with a live
        # second window (in any lane) form the prefix — the kernel then
        # confines slot-2 range tests to [0, u2).  The mirror position
        # set shares the element order, so one permutation serves both.
        # The segmented kernel ADDS the two slots' indicator sums
        # (no OR), which is exact because _key_interval_table2 proved
        # every key's live windows sit in distinct class segments
        # (disjoint_ok) — no key can match both.
        any2 = lane_any2.any(axis=0)
        perm = np.concatenate([np.flatnonzero(any2),
                               np.flatnonzero(~any2)])
        u_pos = u_pos[:, perm]
        mu_pos = mu_pos[:, perm]
        if lane_lo is not None:
            lane_lo = np.ascontiguousarray(lane_lo[:, :, perm])
            lane_span = np.ascontiguousarray(lane_span[:, :, perm])
        if qkeys is not None:
            qkeys = np.ascontiguousarray(qkeys[:, perm])
        if qidx is not None:
            qidx = np.ascontiguousarray(qidx[:, perm])
        u2 = int(any2.sum())
    plan = UnionKeyPlan(u_pos, mu_pos, lane_lo, lane_span,
                        int(positions.size), mirror, u2=u2,
                        qkeys=qkeys, z_tol=ztol, qidx=qidx,
                        key_list=key_list, q_pos=q_pos)
    return pad_union_key_plan(
        plan, pad_to if pad_to is not None else _bucket(u_count), n_pixels)


def pad_union_key_plan(plan: UnionKeyPlan, u_pad: int,
                       n_pixels: int,
                       n_slots: int | None = None) -> UnionKeyPlan:
    """Re-pad a union plan to a wider bucket (sentinel positions, empty
    intervals) — lets a batch of plans with different natural buckets
    stack into one dispatch without rebuilding the bisections.
    ``n_slots`` additionally pads the (compacted) interval-slot axis so
    plans with different slot counts stack too."""
    u = plan.u_pos.shape[1]
    light = plan.lane_lo is None
    s = 2 if light else plan.lane_lo.shape[1]
    s_pad = s if n_slots is None else n_slots
    if u_pad == u and s_pad == s:
        return plan
    if u_pad < u:
        raise ValueError(f"pad_to {u_pad} < union size {u}")
    if s_pad < s:
        raise ValueError(f"n_slots {s_pad} < slot count {s}")
    padw = ((0, 0), (0, u_pad - u))
    lane_pad = ((0, 0), (0, s_pad - s), (0, u_pad - u))
    # padding appends sentinel elements with empty slot-2 windows, so
    # the segmentation prefix [0, u2) is unchanged (qkey 0 = inactive)
    return UnionKeyPlan(
        np.pad(plan.u_pos, padw, constant_values=n_pixels),
        np.pad(plan.mu_pos, padw, constant_values=n_pixels),
        None if light else np.pad(plan.lane_lo, lane_pad,
                                  constant_values=int(_EMPTY_LO)),
        None if light else np.pad(plan.lane_span, lane_pad),
        plan.query_size, plan.mirror, u2=plan.u2,
        qkeys=(None if plan.qkeys is None
               else np.pad(plan.qkeys, padw)),
        z_tol=plan.z_tol,
        # pad elements point at the plan's own inactive 0-key slot
        qidx=(None if plan.qidx is None
              else np.pad(plan.qidx, padw,
                          constant_values=plan.query_size)),
        key_list=plan.key_list, q_pos=plan.q_pos)


def stack_union_plan_args(plans: list, n_pixels: int):
    """Host [B, ...] stacks of (u_pos, mu_pos, lane_lo, lane_span) for
    a batch of union plans, padded to the batch's common union bucket
    and interval-slot count (slot counts vary per mask after
    compact_interval_slots).

    Also returns the batch's slot-2 prefix width ``u2_pad`` (static
    kernel parameter): the max of the members' segmentation prefixes,
    bucketed so dispatch shapes are reused; ``u_pad`` for any
    unsegmented member (the kernel then tests slot 2 full-width, which
    is always correct).  LIGHT plans (tables dropped for the
    compressed wire forms) get their tables re-expanded on host here,
    so this stacker works for any plan."""

    def host_expand(p):
        if p.lane_lo is not None:
            return p
        tabs = interval_table_arrays(p.z_tol)
        assert tabs is not None and p.qidx is not None
        qk = p.key_list[p.qidx.astype(np.int64)]
        return dataclasses.replace(
            p,
            lane_lo=np.ascontiguousarray(
                np.swapaxes(tabs[0][:, qk], 0, 1)),
            lane_span=np.ascontiguousarray(
                np.swapaxes(tabs[1][:, qk], 0, 1)))

    plans = [host_expand(p) for p in plans]
    n_slots = max(p.lane_lo.shape[1] for p in plans)
    # single-slot tables carry no live slot-2 windows: clamp their u2
    # so the common bucketing (one source of truth) sees 0
    plans = [dataclasses.replace(p, u2=0) if p.lane_lo.shape[1] < 2
             and p.u2 < 0 else p for p in plans]
    plans, u_pad, u2_pad, _kl = _stack_union_common(
        plans, n_pixels, with_key_list=False)
    plans = [pad_union_key_plan(p, u_pad, n_pixels, n_slots)
             for p in plans]
    return (np.stack([p.u_pos for p in plans]),
            np.stack([p.mu_pos for p in plans]),
            np.stack([p.lane_lo for p in plans]),
            np.stack([p.lane_span for p in plans]),
            u2_pad)


def score_query_union_keys_raw(t_keys: jax.Array, u_pos: jax.Array,
                               mu_pos: jax.Array, lane_lo: jax.Array,
                               lane_span: jax.Array,
                               u2: int | None = None):
    """Union-lane key scoring of one plan.

    Returns int32 [S*L*(1+mirror), T] exact per-variant counts; straight
    slots first, ordered (dy set major, dx lane minor).

    ``u2`` (static) is the slot-2 segmentation prefix: with elements
    permuted so every live second window sits in [0, u2)
    (build_full_union_key_plan), the second range test runs only on that
    prefix — elements beyond it have empty slot-2 windows that can never
    match, so skipping their tests is exact.  At production tolerances
    only ~21% of elements carry a second window, cutting the kernel's
    per-lane range tests by ~1.5x.  None = test every slot full-width.
    """
    n_lanes = lane_lo.shape[0]
    n_slots = lane_lo.shape[1]
    u_count = lane_lo.shape[2]
    seg = (u2 is not None and n_slots == 2 and 0 <= u2 < u_count)
    outs = []
    pos_sets = [u_pos, mu_pos] if mu_pos.shape[0] else [u_pos]
    for pos in pos_sets:
        for i in range(pos.shape[0]):
            g = jnp.take(t_keys, pos[i], axis=0).astype(jnp.uint32)  # [U, T]
            # segmented form: a SEPARATE small gather for the slot-2
            # prefix (slicing the big gathered intermediate defeated XLA
            # fusion).  An element's two windows live in distinct class
            # segments (verified at plan build), so a key matches at
            # most one and the two indicator sums add without an OR.
            g2 = (jnp.take(t_keys, pos[i, :u2], axis=0)
                  .astype(jnp.uint32) if seg and u2 > 0 else None)
            for j in range(n_lanes):
                lo, sp = lane_lo[j], lane_span[j]
                # slot count is a plan-build property: at production
                # tolerances every key has <= 2 non-empty windows, and
                # compact_interval_slots drops the dead third test
                m = (g - lo[0][:, None]) <= sp[0][:, None]
                if seg:
                    cnt = m.sum(axis=0, dtype=jnp.int32)
                    if u2 > 0:
                        m2 = (g2 - lo[1][:u2, None]) <= sp[1][:u2, None]
                        cnt = cnt + m2.sum(axis=0, dtype=jnp.int32)
                    outs.append(cnt)
                    continue
                for s in range(1, n_slots):
                    m = m | ((g - lo[s][:, None]) <= sp[s][:, None])
                outs.append(m.sum(axis=0, dtype=jnp.int32))
    return jnp.stack(outs)


@functools.partial(jax.jit, static_argnames=("u2",))
def score_query_batch_union_keys(t_keys: jax.Array, u_pos: jax.Array,
                                 mu_pos: jax.Array, lane_lo: jax.Array,
                                 lane_span: jax.Array,
                                 u2: int | None = None):
    """Batched union-lane key scoring (args are [B, ...] stacks).

    Returns (best [B, T], mirrored [B, T], pair_flags [B, T] — always
    zero, kept for interface parity).  ``u2`` is the batch's static
    slot-2 segmentation prefix (stack_union_plan_args)."""
    n_straight = u_pos.shape[1] * lane_lo.shape[1]

    def one(args):
        up, mp, lo, sp = args
        scores = score_query_union_keys_raw(t_keys, up, mp, lo, sp,
                                            u2=u2)
        return reduce_variants_device(
            scores, jnp.zeros_like(scores), n_straight)

    return jax.lax.map(one, (u_pos, mu_pos, lane_lo, lane_span))


@functools.partial(jax.jit, static_argnames=("u2", "k"))
def score_query_batch_union_keys_topk(t_keys: jax.Array, u_pos: jax.Array,
                                      mu_pos: jax.Array,
                                      lane_lo: jax.Array,
                                      lane_span: jax.Array,
                                      u2: int | None = None, *, k: int):
    """Batched union scoring + per-mask device top-k emit selection.

    Returns (scores_k [B, k] descending, idx_k [B, k] target columns,
    mirr_k [B, k], best [B, T], mirrored [B, T]).  The dense arrays stay
    ON DEVICE as the lossless fallback handle: with a positive
    pctPositivePixels threshold only pairs with
    score/querySize > pct/100 can emit (the reference's isMatch filter,
    ColorMIPSearch.java:42-44), so the caller pulls just the [B, k]
    selection and checks the k-th (smallest selected) score per mask —
    the emit test is monotone in score, so if the k-th fails it, every
    dropped pair fails it too.  If any mask's k-th could still emit the
    caller materializes the dense arrays instead (no recompute).  The
    [B, k] pull replaces the dense [B, T] result pull, as the mesh
    top-k path does (engine/cds._score_batch)."""
    best, mirrored, _flags = score_query_batch_union_keys(
        t_keys, u_pos, mu_pos, lane_lo, lane_span, u2=u2)
    scores_k, idx_k = jax.lax.top_k(best, k)
    mirr_k = jnp.take_along_axis(mirrored, idx_k, axis=1)
    return scores_k, idx_k, mirr_k, best, mirrored


def split_key_planes(t_keys: jax.Array):
    """int32 [P+1, T] key planes -> (rank uint16, cls uint8) planes.

    3 gathered bytes/element instead of 4: two thinner gathers (0.75x
    bytes) for a kernel bound by the bytes it gathers.  The kernel
    reconstructs k = (cls << KEY_RANK_BITS) | rank with one
    shift+or per element.
    """
    from colormipsearch_tpu.ops.common import KEY_RANK_BITS

    @jax.jit
    def _split(v):
        # jitted so XLA fuses the elementwise ops: eager mode
        # materializes multi-GB temporaries and OOMs at wide T
        v = v.astype(jnp.uint32)
        return ((v & ((1 << KEY_RANK_BITS) - 1)).astype(jnp.uint16),
                (v >> KEY_RANK_BITS).astype(jnp.uint8))

    return _split(t_keys)


def score_query_union_keys_splitk_raw(t_rank: jax.Array,
                                      t_cls: jax.Array,
                                      u_pos: jax.Array,
                                      mu_pos: jax.Array,
                                      lane_lo: jax.Array,
                                      lane_span: jax.Array,
                                      u2: int | None = None):
    """score_query_union_keys_raw over split (u16 rank + u8 cls) key
    planes — identical results, 3 gathered bytes/element."""
    from colormipsearch_tpu.ops.common import KEY_RANK_BITS

    n_lanes = lane_lo.shape[0]
    n_slots = lane_lo.shape[1]
    u_count = lane_lo.shape[2]
    seg = (u2 is not None and n_slots == 2 and 0 <= u2 < u_count)

    def gather_keys(pos_v):
        r = jnp.take(t_rank, pos_v, axis=0).astype(jnp.uint32)
        c = jnp.take(t_cls, pos_v, axis=0).astype(jnp.uint32)
        return (c << KEY_RANK_BITS) | r

    outs = []
    pos_sets = [u_pos, mu_pos] if mu_pos.shape[0] else [u_pos]
    for pos in pos_sets:
        for i in range(pos.shape[0]):
            g = gather_keys(pos[i])
            g2 = gather_keys(pos[i, :u2]) if seg and u2 > 0 else None
            for j in range(n_lanes):
                lo, sp = lane_lo[j], lane_span[j]
                m = (g - lo[0][:, None]) <= sp[0][:, None]
                if seg:
                    cnt = m.sum(axis=0, dtype=jnp.int32)
                    if u2 > 0:
                        m2 = (g2 - lo[1][:u2, None]) <= sp[1][:u2, None]
                        cnt = cnt + m2.sum(axis=0, dtype=jnp.int32)
                    outs.append(cnt)
                    continue
                for s in range(1, n_slots):
                    m = m | ((g - lo[s][:, None]) <= sp[s][:, None])
                outs.append(m.sum(axis=0, dtype=jnp.int32))
    return jnp.stack(outs)


@functools.partial(jax.jit, static_argnames=("u2",))
def score_query_batch_union_keys_splitk(t_rank: jax.Array,
                                        t_cls: jax.Array,
                                        u_pos: jax.Array,
                                        mu_pos: jax.Array,
                                        lane_lo: jax.Array,
                                        lane_span: jax.Array,
                                        u2: int | None = None):
    """Batched split-key-plane union scoring."""
    n_straight = u_pos.shape[1] * lane_lo.shape[1]

    def one(args):
        up, mp, lo, sp = args
        scores = score_query_union_keys_splitk_raw(
            t_rank, t_cls, up, mp, lo, sp, u2=u2)
        return reduce_variants_device(
            scores, jnp.zeros_like(scores), n_straight)

    return jax.lax.map(one, (u_pos, mu_pos, lane_lo, lane_span))


@jax.jit
def expand_union_tables(qidx: jax.Array, key_list: jax.Array,
                        tab_lo: jax.Array, tab_span: jax.Array):
    """Factored qkey wire form -> expanded device lane tables.

    (qidx uint16 [B, L, U], key_list int32 [B, KL]) -> (lane_lo,
    lane_span) uint32 [B, L, 2, U].  Runs ONCE per mask batch at
    plan-arg build time: the scalar-gather expansion costs about as
    much as one kernel dispatch, so doing it inside the scoring kernel
    (the original qkey kernel) halved the measured rate — expanded
    device tables restore the full tables-kernel speed while the WIRE
    stays the ~110 KB/mask factored form."""
    # pack the four per-key values into one row so the expansion is a
    # single ROW gather (XLA's fast take-axis-0 path, the same lowering
    # as the kernel's key-plane gather) instead of four element
    # gathers
    tab = jnp.stack([tab_lo[0], tab_lo[1],
                     tab_span[0], tab_span[1]], axis=1)  # [N, 4]

    def one(args):
        qi, kl = args
        qk = jnp.take(kl, qi.astype(jnp.int32))          # [L, U]
        t = jnp.transpose(jnp.take(tab, qk, axis=0),
                          (0, 2, 1))                     # [L, 4, U]
        return t[:, :2], t[:, 2:]                        # [L, 2, U] x2

    # chunked map+vmap: sequential over chunks (whole-batch vmap's
    # gather transients, ~2.4 GB at B=128, OOMed next to a T=4096
    # plane set), vectorized within
    return _map_vmap_chunks(one, (qidx, key_list))


def stack_union_pos_args(plans: list, n_pixels: int):
    """[B, ...] stacks of (u_pos, mu_pos, q_pos, key_list) + static u2
    for the POSITIONAL wire form, or None when any plan lacks it.  The
    per-(lane, element) index matrix never crosses the wire: the device
    re-derives it from the query positions
    (expand_union_tables_from_pos), cutting plan args to ~65 KB/mask."""
    if any(p.q_pos is None or p.key_list is None for p in plans):
        return None
    plans, _u_pad, u2_pad, kl = _stack_union_common(
        plans, n_pixels, with_key_list=True)
    qp = np.full((len(plans), kl.shape[1] - 1), n_pixels, np.int32)
    for i, p in enumerate(plans):
        qp[i, :p.q_pos.size] = p.q_pos
    return (np.stack([p.u_pos for p in plans]),
            np.stack([p.mu_pos for p in plans]),
            qp, kl, u2_pad)


@functools.partial(jax.jit, static_argnames=("offsets", "w", "h"))
def expand_union_tables_from_pos(u_pos: jax.Array, q_pos: jax.Array,
                                 key_list: jax.Array,
                                 tab_lo: jax.Array, tab_span: jax.Array,
                                 *, offsets: tuple, w: int, h: int):
    """Positional wire form -> expanded device lane tables.

    Re-derives each lane's query mapping ON DEVICE from the flat query
    positions: a pos_index scatter per plan, then per-lane geometry +
    gathers — exactly the host derivation in build_full_union_key_plan
    (out-of-image shifts inactive, non-query pixels inactive, sentinel
    pads inactive).  Returns (lane_lo, lane_span) uint32 [B, L, 2, U].
    """
    n_px = w * h
    # packed [N, 4] interval rows: one row gather replaces four element
    # gathers (see expand_union_tables)
    tab = jnp.stack([tab_lo[0], tab_lo[1],
                     tab_span[0], tab_span[1]], axis=1)

    def one(args):
        up, qp, kl = args
        u = up[0].astype(jnp.int32)            # [U]; sentinel = n_px
        n_inact = kl.shape[0] - 1              # any index here keys 0
        pos_index = jnp.full((n_px + 1,), n_inact, jnp.int32)
        qi = jnp.arange(qp.shape[0], dtype=jnp.int32)
        # pad q_pos entries (= n_px) scatter into the extra slot, which
        # no clipped src ever reads
        pos_index = pos_index.at[qp].set(qi, mode="drop")
        ux = u % w
        uy = u // w
        js = []
        for dx, dy in offsets:
            qx = ux - dx
            qy = uy - dy
            src = u - dx - dy * w
            ok = ((u < n_px) & (qx >= 0) & (qx < w)
                  & (qy >= 0) & (qy < h))
            js.append(jnp.where(
                ok, jnp.take(pos_index,
                             jnp.clip(src, 0, n_px - 1)), n_inact))
        qk = jnp.take(kl, jnp.stack(js))       # [L, U]
        t = jnp.transpose(jnp.take(tab, qk, axis=0),
                          (0, 2, 1))           # [L, 4, U]
        return t[:, :2], t[:, 2:]              # (lane_lo, lane_span)

    return _map_vmap_chunks(one, (u_pos, q_pos, key_list))


def _map_vmap_chunks(one, args, default_chunk: int = 8):
    """lax.map over CHUNKS of masks with a vmap inside: amortizes the
    per-iteration map overhead while bounding the batched-gather
    transients that made a whole-batch vmap OOM next to a T=4096 plane
    set (~2.4 GB at B=128; a chunk of 8 stays ~150 MB).  Falls back to
    the plain per-mask map when the batch doesn't divide
    (CDS_EXPAND_VMAP overrides the chunk; <=1 disables)."""
    import os

    b = args[0].shape[0]
    chunk = int(os.environ.get("CDS_EXPAND_VMAP", str(default_chunk)))
    if chunk <= 1 or b % chunk or b <= chunk:
        return jax.lax.map(one, args)
    folded = tuple(a.reshape((b // chunk, chunk) + a.shape[1:])
                   for a in args)
    lo, sp = jax.lax.map(jax.vmap(one), folded)
    return (lo.reshape((b,) + lo.shape[2:]),
            sp.reshape((b,) + sp.shape[2:]))


def interval_table_arrays(z_tol: float):
    """The shared (lo, span) uint32 [2, 7 << KEY_RANK_BITS] per-key
    interval tables the qkey kernel gathers from, or None when the
    tolerance needs 3 slots (callers use the expanded lane tables)."""
    tab2 = _key_interval_table2(float(z_tol))
    if tab2 is None:
        return None
    tab_lo, tab_span, _any2, ok = tab2
    return (tab_lo, tab_span) if ok else None


def _stack_union_common(plans: list, n_pixels: int,
                        with_key_list: bool):
    """Shared stacking core of the three union wire forms: the common
    union bucket, the batch's bucketed slot-2 prefix, padded plans, and
    (optionally) the padded key-list matrix — ONE source of truth for
    the dispatch-shape rules."""
    u_pad = max(p.u_pos.shape[1] for p in plans)
    u2_pad = max(p.u2 if p.u2 >= 0 else u_pad for p in plans)
    if 0 < u2_pad < u_pad:
        u2_pad = min(u_pad, _bucket(u2_pad, minimum=128))
    plans = [pad_union_key_plan(p, u_pad, n_pixels) for p in plans]
    kl = None
    if with_key_list:
        kl_pad = _bucket(max(p.key_list.size for p in plans),
                         minimum=512)
        kl = np.zeros((len(plans), kl_pad), np.int32)
        for i, p in enumerate(plans):
            # trailing zeros keep every inactive index (q >= query
            # size) pointing at a 0 key
            kl[i, :p.key_list.size] = p.key_list
    return plans, u_pad, u2_pad, kl


def stack_union_qkey_args(plans: list, n_pixels: int):
    """[B, ...] stacks of (u_pos, mu_pos, qidx, key_list) + static u2
    for the factored qkey wire form, or None when any plan lacks it
    (3-slot tolerance, disjointness unproven, or a >=65535-px query).
    ~7x fewer plan-arg bytes than the expanded lane tables: per-lane
    elements carry u16 indices into the mask's key list, and the
    device re-expands lo/span by gathering the shared per-tolerance
    table."""
    if any(p.qidx is None or p.key_list is None for p in plans):
        # mixed batches (light + >=65535-px queries) fall back to the
        # tables stacker, which host-expands the light plans' tables
        return None
    plans, _u_pad, u2_pad, kl = _stack_union_common(
        plans, n_pixels, with_key_list=True)
    return (np.stack([p.u_pos for p in plans]),
            np.stack([p.mu_pos for p in plans]),
            np.stack([p.qidx for p in plans]),
            kl,
            u2_pad)


def score_query_union_qkeys_raw(t_keys: jax.Array, u_pos: jax.Array,
                                mu_pos: jax.Array, qidx: jax.Array,
                                key_list: jax.Array,
                                tab_lo: jax.Array, tab_span: jax.Array,
                                u2: int | None = None):
    """Qkey wire-form twin of score_query_union_keys_raw: per-lane
    query keys are expanded from the factored wire form (qidx uint16
    [L, U] indexing key_list int32 [KL]; index query_size -> key 0 =
    inactive), then interval bounds are gathered ON DEVICE from the
    shared per-tolerance table (tab_lo/tab_span uint32 [2, n_keys]).
    Always the segmented no-OR form — the factored form exists only
    under the table's window-disjointness proof."""
    qkeys = jnp.take(key_list, qidx.astype(jnp.int32))
    n_lanes = qkeys.shape[0]
    u_count = qkeys.shape[1]
    u2e = u2 if (u2 is not None and 0 <= u2 <= u_count) else u_count
    lo1 = jnp.take(tab_lo[0], qkeys)      # [L, U]
    sp1 = jnp.take(tab_span[0], qkeys)
    qk2 = qkeys[:, :u2e]
    lo2 = jnp.take(tab_lo[1], qk2)
    sp2 = jnp.take(tab_span[1], qk2)
    outs = []
    pos_sets = [u_pos, mu_pos] if mu_pos.shape[0] else [u_pos]
    for pos in pos_sets:
        for i in range(pos.shape[0]):
            g = jnp.take(t_keys, pos[i], axis=0).astype(jnp.uint32)
            if u2e == u_count:
                g2 = g
            elif u2e > 0:
                g2 = jnp.take(t_keys, pos[i, :u2e], axis=0) \
                    .astype(jnp.uint32)
            else:
                g2 = None
            for j in range(n_lanes):
                m = (g - lo1[j][:, None]) <= sp1[j][:, None]
                cnt = m.sum(axis=0, dtype=jnp.int32)
                if g2 is not None:
                    m2 = (g2 - lo2[j][:, None]) <= sp2[j][:, None]
                    cnt = cnt + m2.sum(axis=0, dtype=jnp.int32)
                outs.append(cnt)
    return jnp.stack(outs)


@functools.partial(jax.jit, static_argnames=("u2",))
def score_query_batch_union_qkeys(t_keys: jax.Array, u_pos: jax.Array,
                                  mu_pos: jax.Array, qidx: jax.Array,
                                  key_list: jax.Array,
                                  tab_lo: jax.Array,
                                  tab_span: jax.Array,
                                  u2: int | None = None):
    """Batched qkey scoring ([B, ...] stacks; the tables are shared).

    Returns (best [B, T], mirrored [B, T], pair_flags [B, T] zeros)."""
    n_straight = u_pos.shape[1] * qidx.shape[1]

    def one(args):
        up, mp, qi, kl = args
        scores = score_query_union_qkeys_raw(
            t_keys, up, mp, qi, kl, tab_lo, tab_span, u2=u2)
        return reduce_variants_device(
            scores, jnp.zeros_like(scores), n_straight)

    return jax.lax.map(one, (u_pos, mu_pos, qidx, key_list))

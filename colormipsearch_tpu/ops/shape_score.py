"""Batched device shape (gradient-area-gap) scoring.

Device reformulation of the reference's per-pair lazy-image fold
(cds/ShapeMatchColorDepthSearchAlgorithm.calculateNegativeScores:191-240):

  * the z-slice number of a pixel is a pure function of its RGB value, so
    slice planes are computed ONCE per image (the reference re-scans its
    256-entry LUT per pixel per comparison — GradientAreaGapUtils:132-198),
  * per-target data is packed into a pixel-major uint32 plane [P, T]:
        bits  0..15  gradient value (16-bit gradient image)
        bits 16..24  z-gap slice number (0..256 -> 9 bits)
        bit   25     z-gap nonzero flag
        bit   26     target foreground flag (any channel > maskThreshold)
    so one elementwise pass over [P, T] scores a query against T targets,
  * per-query data packs to an int32 plane [P]:
        bits  0..8   query slice number
        bit   9      query nonzero
        bit   10     query signal (intensity >= threshold 2)
        bit   11     query high-expression-ring bit
  * per-pixel gap values are <= 2^17, so the [P, T] sum is carried in two
    int32 accumulators (lo 10 bits / hi bits) to avoid int64 (JAX runs
    with x64 off) and recombined on the host,
  * the mirror pass reuses the same packs: flipping the query and the
    target z-gap plane (the reference's quirk, :214-221) is equivalent to
    flipping the target gradient+foreground fields instead, so a second
    "mirror pack" with grad/fg flipped horizontally scores the mirrored
    orientation without touching the query.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from colormipsearch_tpu.constants import (
    DEFAULT_COLOR_FLUX,
    GAP_THRESHOLD,
    RAINBOW_LUT,
    SLICE_LUT_RANGES,
)
from colormipsearch_tpu.oracle import shape as shape_oracle

# field layout (keep in sync with pack_* below)
_GRAD_BITS = 16
_SL_SHIFT = 16
_ZNZ_SHIFT = 25
_TFG_SHIFT = 26

_Q_SL_MASK = 0x1FF
_Q_NZ_SHIFT = 9
_Q_SIG_SHIFT = 10
_Q_HE_SHIFT = 11


# -------------------------------------------------------------------------
# device slice numbers
# -------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _lut_tables():
    """Per-class padded integer LUT tables for the exact device argmin.

    Every in-range LUT entry has a dominant channel value of 255
    (asserted below), so the nearest-ratio comparison
        |s/p - S_i/255|  ->  argmin_i |255*s - S_i*p|
    is EXACT in int32 (max magnitude 255*255*255 ~ 1.66e7), reproducing
    the float64 oracle bit-for-bit including first-minimum tie-breaks.

    Returns (secondaries i32 [6, L] with huge padding, starts i32 [6]).
    """
    lut = RAINBOW_LUT
    r, g, b = lut[:, 0], lut[:, 1], lut[:, 2]
    r_dom = (r >= g) & (r >= b)
    g_dom = ~r_dom & (g >= r) & (g >= b)
    prim = np.where(r_dom, r, np.where(g_dom, g, b))
    sec = np.where(r_dom, np.maximum(g, b),
                   np.where(g_dom, np.maximum(r, b), np.maximum(r, g)))
    rows, starts = [], []
    max_len = max(hi - lo + 1 for lo, hi in SLICE_LUT_RANGES.values())
    for cid in range(1, 7):
        lo, hi = SLICE_LUT_RANGES[cid]
        assert (prim[lo:hi + 1] == 255).all(), \
            "LUT dominant channel must be 255 for the exact integer scan"
        s_row = sec[lo:hi + 1].astype(np.int64)
        pad = np.full(max_len - s_row.size, 1 << 20, np.int64)
        rows.append(np.concatenate([s_row, pad]))
        starts.append(lo)
    return (np.asarray(rows, np.int32), np.asarray(starts, np.int32))


def slice_numbers_device(rgb: jax.Array) -> jax.Array:
    """int32 z-slice numbers (1..256; 0 for black) for uint8 [..., 3] rgb.

    Device equivalent of oracle.shape.slice_numbers: >=-tie classification
    (R,G,B priority), nearest-ratio scan with first-minimum tie-breaking,
    evaluated in exact integer arithmetic (see _lut_tables).

    NOTE: at EXACT rational ties between two LUT distances this takes the
    first minimum, whereas the reference's float64 arithmetic lets
    rounding noise pick a side; for bit parity use
    ops.slice_lut.slice_numbers_lut (oracle-built table).  Everywhere
    else the orderings provably agree (margins >= 1/(255*255) >> f64
    error).
    """
    rows, starts = _lut_tables()
    r = rgb[..., 0].astype(jnp.int32)
    g = rgb[..., 1].astype(jnp.int32)
    b = rgb[..., 2].astype(jnp.int32)

    r_dom = (r >= g) & (r >= b)
    g_dom = ~r_dom & (g >= r) & (g >= b)
    # class ids 1..6 matching SLICE_LUT_RANGES keys (CLASS_*)
    cls = jnp.where(
        r_dom, jnp.where(g >= b, 5, 6),
        jnp.where(g_dom, jnp.where(r >= b, 4, 3),
                  jnp.where(r >= g, 1, 2)))
    p = jnp.where(r_dom, r, jnp.where(g_dom, g, b))
    s = jnp.where(r_dom, jnp.maximum(g, b),
                  jnp.where(g_dom, jnp.maximum(r, b), jnp.maximum(r, g)))

    table = jnp.asarray(rows)        # [6, L] secondaries (pad = huge)
    sec = table[cls - 1]             # [..., L]
    # padded entries: 255*s - huge*p is large negative -> abs huge, never
    # the minimum (p >= 1 for non-black pixels)
    keys = jnp.abs(255 * s[..., None] - sec * p[..., None])
    idx = jnp.argmin(keys, axis=-1).astype(jnp.int32)  # first min wins
    slice_no = jnp.asarray(starts)[cls - 1] + idx + 1
    black = (r == 0) & (g == 0) & (b == 0)
    return jnp.where(black, 0, slice_no)


# -------------------------------------------------------------------------
# packing
# -------------------------------------------------------------------------


def pack_targets(t_rgb: np.ndarray, grad: np.ndarray,
                 zgap_rgb: np.ndarray, *, mask_threshold: int):
    """uint8 [T,H,W,3] x uint16 [T,H,W] x uint8 [T,H,W,3] -> (straight,
    mirror) packed uint32 [P, T] planes (device arrays).

    Slice numbers come from the exact full-RGB table (ops/slice_lut.py),
    so the pack is bit-faithful to the reference including f64 rounding at
    nearest-ratio ties.  The mirror pack flips the gradient and foreground
    fields horizontally while keeping the z-gap fields in place (see
    module docstring).
    """
    from colormipsearch_tpu.ops.slice_lut import slice_numbers_lut

    t = t_rgb.shape[0]
    sl = slice_numbers_lut(zgap_rgb).astype(np.uint32)
    znz = (zgap_rgb.astype(np.int32).sum(axis=-1) > 0).astype(np.uint32)
    tfg = (t_rgb > mask_threshold).any(axis=-1).astype(np.uint32)
    # pre-threshold the gradient (ShapeMatch zeroes values <= GAP_THRESHOLD
    # :219): the slice-gap branch can never fall below it (sg - 40 >= 40),
    # so folding the check into the pack removes it from the hot kernel
    grad_thr = np.where(grad > GAP_THRESHOLD, grad, 0)
    word = (grad_thr.astype(np.uint32)
            | (sl << _SL_SHIFT) | (znz << _ZNZ_SHIFT) | (tfg << _TFG_SHIFT))
    grad_fg = word & np.uint32(0xFFFF | (1 << _TFG_SHIFT))
    z_part = word & np.uint32((0x1FF << _SL_SHIFT) | (1 << _ZNZ_SHIFT))
    mirror = z_part | grad_fg[:, :, ::-1]
    flat = jnp.asarray(np.ascontiguousarray(word.reshape(t, -1).T))
    flat_m = jnp.asarray(np.ascontiguousarray(mirror.reshape(t, -1).T))
    return flat, flat_m


def high_expression_ring(q: np.ndarray, *, fg: np.ndarray | None = None,
                         fg_sums: np.ndarray | None = None) -> np.ndarray:
    """Exact high-expression ring mask [H, W] bool — bit-identical to
    the reference's rgb_signal(combine2(maxFilter60(q), maxFilter20(q),
    drop-where-20-present), 0) but ~12x cheaper (the former per-mask
    query-pack hot spot, ColorDepthSearchAlgorithmProviderFactory
    .java:113-131).

    Derivation: signal-0 of a pixel of the r=60 per-channel-max dilation
    is 1 iff the sum of its per-channel maxes s' satisfies
    (2*((2s'+3)//6)+3)//6 > 0  <=>  s' >= 5; the r=20 drop term only
    tests any-foreground.  Both reduce to disk reachability because the
    ImageJ footprint is exactly the integer disk dy^2+dx^2 <= int(r^2)+1
    (oracle.shape.binary_dilate_disk): one Euclidean distance transform
    answers "foreground within r" for every radius at once.  A BRIGHT
    pixel (channel sum >= 5) in the 60-disk guarantees s' >= 5 since
    sum_c max_p >= max_p sum_c; only DIM foreground pixels (sum 1..4 —
    absent from real CDMs, where content is either black or saturated)
    need the true per-channel max, computed on the dim pixels alone.
    """
    if fg is None:
        fg = q.any(axis=-1)
    if not fg.any():
        return np.zeros(q.shape[:2], bool)
    if fg_sums is None:
        fg_sums = q.reshape(-1, 3)[fg.reshape(-1)].astype(np.int32) \
            .sum(axis=1)
    d = shape_oracle.ndimage.distance_transform_edt(~fg)
    # d is sqrt of an exact integer squared distance: comparing d to
    # sqrt(r2 + 0.5) is exactly d^2 <= r2 (gap between adjacent sqrt-of-
    # integer values >> f64 rounding), saving two full-plane float passes
    not20 = d > 20.0374  # sqrt(401.5), r2 = int(20^2)+1
    if not (fg_sums < 5).any():
        return (d <= 60.0125) & not20  # sqrt(3601.5), r2 = int(60^2)+1
    s = q.astype(np.int32).sum(axis=-1)
    bright60 = shape_oracle.binary_dilate_disk(s >= 5, 60)
    dim = fg & (s < 5)
    dim_img = np.where(dim[..., None], q, 0).astype(np.uint8)
    s60dim = shape_oracle.dilate_rgb(dim_img, 60).astype(np.int32) \
        .sum(axis=-1)
    return (bright60 | (s60dim >= 5)) & not20


def pack_query(q_rgb: np.ndarray, *, excluded_region=None,
               roi_keep=None) -> np.ndarray:
    """Query-side int32 [P] plane (host precompute, once per mask).

    Uses the oracle's exact integer signal formulas; the high-expression
    ring (r=60/r=20 — factory :113-131) runs through the exact EDT fast
    path, and the per-pixel fields are computed only at the sparse
    foreground (CDMs are ~98% black), so the whole pack is ~10x cheaper
    than the former full-plane max-filter construction.
    """
    from colormipsearch_tpu.ops.slice_lut import slice_numbers_lut

    q = shape_oracle.clear_region(q_rgb, excluded_region)
    h, w = q.shape[:2]
    flat_rgb = q.reshape(-1, 3)
    fg = q.any(axis=-1)
    fg_flat = fg.reshape(-1)
    idx = np.flatnonzero(fg_flat)
    vals = flat_rgb[idx].astype(np.int32)
    sums = vals.sum(axis=1)
    # sl/nz/sig are zero off-foreground (slice 0 for black; nz = fg;
    # sig requires gray16 signal > 2): gather/compute at support only
    sl_vals = slice_numbers_lut(flat_rgb[idx]).astype(np.int32)
    v16 = (2 * sums + 3) // 6
    sig_vals = ((2 * v16 + 3) // 6 > 2)
    he = high_expression_ring(q, fg=fg, fg_sums=sums)
    word = np.zeros(h * w, np.int32)
    word[idx] = (sl_vals | (1 << _Q_NZ_SHIFT)
                 | (sig_vals.astype(np.int32) << _Q_SIG_SHIFT))
    if roi_keep is not None:
        # nz/sig bits are gated by the ROI; the slice field is not (it
        # only ever multiplies against those bits in the kernel)
        word[idx] &= np.where(
            roi_keep.reshape(-1)[idx], -1,
            ~((1 << _Q_NZ_SHIFT) | (1 << _Q_SIG_SHIFT))).astype(np.int32)
        he &= roi_keep
    word |= he.reshape(-1).astype(np.int32) << _Q_HE_SHIFT
    return word


# -------------------------------------------------------------------------
# sparse (support-row) packing
# -------------------------------------------------------------------------
#
# Every term of the shape score has a query-side factor: the gap value is
# zero unless the query pixel is nonzero (overlap) or carries signal
# (gradient term), and the high-expression term needs the ring bit — so
# rows whose packed query word is 0 can NEVER contribute.  On fixture
# masks the support is ~5% of the plane (r=60 ring included), so packing
# ONLY the support rows cuts device ops, device-memory traffic, and host->device
# upload ~20x.  The target pack runs per mask group anyway (the zgap
# fallback depends on the mask's params), so the host slices support
# columns during packing and the device kernel stays a dense
# elementwise+reduce over [S, T] — shape_score_pairs works unchanged.


def support_positions(q_pack: np.ndarray,
                      q_pack_mirror: np.ndarray | None = None) -> np.ndarray:
    """int32 flat pixel indices whose query word is nonzero (union with
    the mirror-ROI pack when given) — the only rows that can contribute
    to any score term."""
    word = q_pack if q_pack_mirror is None else (q_pack | q_pack_mirror)
    return np.flatnonzero(word).astype(np.int32)


def sparse_query(q_pack: np.ndarray, pos: np.ndarray,
                 n_pad: int) -> np.ndarray:
    """Query plane sliced to the padded support rows (pad word = 0, which
    zeroes every contribution of the pad rows)."""
    out = np.zeros(n_pad, np.int32)
    out[:pos.size] = q_pack[pos]
    return out


def support_bucket(s: int, minimum: int = 4096) -> int:
    """Support sizes pad to the {1,1.25,1.5,1.75} x 2^k ladder so kernel
    shapes (and XLA compilations) are reused across masks."""
    from colormipsearch_tpu.ops.pixel_match import _bucket

    return _bucket(s, minimum=minimum)


def pack_target_rows(t_rgbs, grads, zgap_rgbs, pos: np.ndarray,
                     n_pad: int, *, mask_threshold: int,
                     excluded: np.ndarray | None = None,
                     mirror: bool = True):
    """Column-sliced pack_targets: ONE uint32 [2, S_pad, T] device plane
    (index 0 straight, 1 mirror; [1, S_pad, T] when mirror=False)
    holding only the query-support rows `pos` — stacked so both
    orientations upload and score in a single dispatch
    (shape_score_pairs_both).

    Accepts sequences (or stacks) of per-target [H, W(, 3)] images and
    slices the support columns per image, so no full-size [T, H, W]
    stack is materialized.  The mirror plane keeps z-gap fields in place
    and takes gradient/foreground from the horizontally mirrored pixel
    (same formulation as pack_targets), so the mirrored fields are
    sliced at the mirrored column indices.

    `excluded`: optional bool [H, W] ignored-region mask.  The dense
    path clears the target CDM in that region before packing, which
    only affects the foreground bit (grad/zgap are packed uncleaned),
    so here the tfg columns are masked directly — no per-image copy.
    """
    from colormipsearch_tpu.ops.slice_lut import slice_numbers_lut

    t = len(t_rgbs)
    w = t_rgbs[0].shape[1]
    if mirror:
        y, x = pos // w, pos % w
        both = np.concatenate([pos, y * w + (w - 1 - x)])
    else:
        both = pos

    zsel = np.stack([z.reshape(-1, 3)[pos] for z in zgap_rgbs])
    sl = slice_numbers_lut(zsel).astype(np.uint32)
    znz = (zsel.astype(np.int32).sum(axis=-1) > 0).astype(np.uint32)
    z_part = (sl << _SL_SHIFT) | (znz << _ZNZ_SHIFT)   # [T, S]

    # straight + mirrored gradient/foreground columns in one slice pass
    tsel = np.stack([i.reshape(-1, 3)[both] for i in t_rgbs])
    gsel = np.stack([g.reshape(-1)[both] for g in grads])
    tfg = (tsel > mask_threshold).any(axis=-1).astype(np.uint32)
    if excluded is not None:
        tfg &= (~excluded.reshape(-1)[both]).astype(np.uint32)
    g_thr = np.where(gsel > GAP_THRESHOLD, gsel, 0).astype(np.uint32)
    grad_fg = g_thr | (tfg << _TFG_SHIFT)              # [T, (1|2)S]

    s = pos.size
    n_or = 2 if mirror else 1
    out = np.zeros((n_or, n_pad, t), np.uint32)
    out[0, :s] = (z_part | grad_fg[:, :s]).T
    if mirror:
        out[1, :s] = (z_part | grad_fg[:, s:]).T
    return jnp.asarray(out)


# -------------------------------------------------------------------------
# split (gap-row / he-row) packing
# -------------------------------------------------------------------------
#
# The support rows partition into two DISJOINT classes:
#   * gap rows — query pixel non-black (q_sl != 0): the only rows where
#     the slice-gap / gradient term can be nonzero.  They never carry
#     the high-expression bit, because the HE ring is d60 MINUS d20 and
#     d20 contains every non-black query pixel.
#   * he rows — ring bit set (necessarily q_sl == 0): contribute only
#     `targetIsFG` to highExpressionArea; the gap term is identically 0
#     there (no overlap, no signal).
# Scoring them with two dedicated kernels removes the HE machinery from
# the gap rows and the whole 27-bit field extraction + select chain from
# the ring rows (whose per-target datum collapses to ONE uint8), cutting
# vector ops and memory traffic several-fold — the ring is usually the larger
# share of the support (r=60 disc vs the thin neuron mask).
# Reference semantics unchanged: ShapeMatchColorDepthSearchAlgorithm
# :191-240 (gap fold) and :221-238 (high-expression fold).
#
# Field layout (gap planes):
#   target uint32: bits 0..15 gradient (pre-thresholded), 16..24 z-gap
#                  slice number.  z_nz is implied by slice != 0 (the
#                  slice LUT maps exactly the black pixel to 0).
#   query  int32:  bits 0..8 slice, 9 nz, 10 signal (same as pack_query
#                  minus the he bit).


def support_split(q_pack: np.ndarray,
                  q_pack_mirror: np.ndarray | None = None):
    """(pos_gap, pos_he) int32 flat indices: rows with a nonzero query
    slice (gap rows) and rows with the high-expression ring bit in
    either pack (he rows).  Disjoint by construction (see above)."""
    word = q_pack if q_pack_mirror is None else (q_pack | q_pack_mirror)
    sl = word & _Q_SL_MASK
    he = (word >> _Q_HE_SHIFT) & 1
    pos_gap = np.flatnonzero(sl).astype(np.int32)
    pos_he = np.flatnonzero(he & (sl == 0)).astype(np.int32)
    return pos_gap, pos_he


def he_words(n_he_rows: int, minimum: int = 128) -> int:
    """Padded uint32 word count for n_he_rows bitpacked ring rows."""
    return support_bucket(-(-n_he_rows // 32), minimum=minimum)


def _packbits32(bits: np.ndarray, n_words: int) -> np.ndarray:
    """bool [..., S] -> uint32 [..., n_words]: bit b of word w is row
    32*w + b (little-endian packbits), zero-padded."""
    b = np.packbits(bits, axis=-1, bitorder="little")
    pad = n_words * 4 - b.shape[-1]
    if pad < 0:
        raise ValueError(f"{bits.shape[-1]} rows exceed {n_words} words")
    if pad:
        b = np.pad(b, [(0, 0)] * (b.ndim - 1) + [(0, pad)])
    return np.ascontiguousarray(b).view(np.uint32)


def sparse_query_split(q_pack: np.ndarray, pos_gap: np.ndarray,
                       n_gap_pad: int, pos_he: np.ndarray,
                       n_he_words: int):
    """(q_gap int32 [n_gap_pad], q_he uint32 [n_he_words]) query-side
    planes for the split kernel.  Gap pad rows are 0 (neutral); he rows
    bitpack 32 ring-row gates per word (see he_words)."""
    q_gap = np.zeros(n_gap_pad, np.int32)
    q_gap[:pos_gap.size] = q_pack[pos_gap] & ~(1 << _Q_HE_SHIFT)
    q_he = _packbits32(
        ((q_pack[pos_he] >> _Q_HE_SHIFT) & 1).astype(bool), n_he_words)
    return q_gap, q_he


def select_target_cols_split(t_rgb, grad, zgap_rgb,
                             pos_gap: np.ndarray, n_gap_pad: int,
                             pos_he: np.ndarray, n_he_words: int, *,
                             mask_threshold: int,
                             excluded: np.ndarray | None = None,
                             mirror: bool = True):
    """ONE target's split-pack columns: (gap_cols uint32 [n_or, Sg_pad],
    he_cols uint32 [n_or, n_he_words]) with n_or = 2 (straight, mirror)
    or 1.

    The per-target half of pack_target_rows_split, factored out so the
    engine's decode workers can slice the support columns right after
    decoding — the multi-MB images are dropped per TARGET (not per
    tile), and the select work parallelizes across the decode pool.
    assemble_target_rows_split stacks the columns into dispatch planes.
    """
    from colormipsearch_tpu.ops.slice_lut import slice_numbers_lut

    w = t_rgb.shape[1]

    def mirror_of(pos):
        y, x = pos // w, pos % w
        return y * w + (w - 1 - x)

    n_or = 2 if mirror else 1
    sg = pos_gap.size

    # gap rows: slice part once, gradient per orientation
    zsel = zgap_rgb.reshape(-1, 3)[pos_gap]
    z_part = slice_numbers_lut(zsel).astype(np.uint32) << _SL_SHIFT
    g_pos = (np.concatenate([pos_gap, mirror_of(pos_gap)]) if mirror
             else pos_gap)
    gsel = grad.reshape(-1)[g_pos]
    g_thr = np.where(gsel > GAP_THRESHOLD, gsel, 0).astype(np.uint32)
    gap_cols = np.zeros((n_or, n_gap_pad), np.uint32)
    gap_cols[0, :sg] = z_part | g_thr[:sg]
    if mirror:
        gap_cols[1, :sg] = z_part | g_thr[sg:]

    # he rows: foreground bit only, bitpacked 32 rows/word
    h_pos = (np.concatenate([pos_he, mirror_of(pos_he)]) if mirror
             else pos_he)
    tsel = t_rgb.reshape(-1, 3)[h_pos]
    tfg = (tsel > mask_threshold).any(axis=-1)
    if excluded is not None:
        tfg &= ~excluded.reshape(-1)[h_pos]
    sh = pos_he.size
    he_cols = np.empty((n_or, n_he_words), np.uint32)
    he_cols[0] = _packbits32(tfg[:sh], n_he_words)
    if mirror:
        he_cols[1] = _packbits32(tfg[sh:], n_he_words)
    return gap_cols, he_cols


def split_gather_plan(pos_gap: np.ndarray, pos_he: np.ndarray, w: int, *,
                      mirror: bool = True,
                      excluded: np.ndarray | None = None):
    """Once-per-mask-group precompute for the packed-store gather path
    (io/shape_pack.py): the straight+mirror gradient/foreground gather
    indices and the per-he-row region gate.  Factoring these out of the
    per-target select leaves that select as pure gathers + packbits."""
    def mirror_of(pos):
        y, x = pos // w, pos % w
        return y * w + (w - 1 - x)

    g_pos = (np.concatenate([pos_gap, mirror_of(pos_gap)]) if mirror
             else pos_gap)
    h_pos = (np.concatenate([pos_he, mirror_of(pos_he)]) if mirror
             else pos_he)
    keep_he = None
    if excluded is not None:
        keep_he = ~excluded.reshape(-1)[h_pos]
    return g_pos, h_pos, keep_he


def select_target_cols_split_from_row(zsl: np.ndarray, grad_thr: np.ndarray,
                                      tfg_bits: np.ndarray,
                                      pos_gap: np.ndarray, n_gap_pad: int,
                                      n_he_words: int, gather_plan, *,
                                      mirror: bool = True):
    """select_target_cols_split from a persisted store row (full-plane
    zsl/grad_thr/tfg fields, io/shape_pack.ShapePackStore.row): no
    decode, no dilation, no slice LUT — column gathers only.  Produces
    bit-identical planes to the decode path (tests/test_shape_pack.py)."""
    g_pos, h_pos, keep_he = gather_plan
    n_or = 2 if mirror else 1
    sg = pos_gap.size

    z_part = zsl[pos_gap].astype(np.uint32) << _SL_SHIFT
    g = grad_thr[g_pos].astype(np.uint32)
    gap_cols = np.zeros((n_or, n_gap_pad), np.uint32)
    gap_cols[0, :sg] = z_part | g[:sg]
    if mirror:
        gap_cols[1, :sg] = z_part | g[sg:]

    tfg = ((tfg_bits[h_pos >> 3] >> (h_pos & 7)) & 1).astype(bool)
    if keep_he is not None:
        tfg &= keep_he
    sh = h_pos.size // n_or
    he_cols = np.empty((n_or, n_he_words), np.uint32)
    he_cols[0] = _packbits32(tfg[:sh], n_he_words)
    if mirror:
        he_cols[1] = _packbits32(tfg[sh:], n_he_words)
    return gap_cols, he_cols


def select_target_tile_from_store(store, rows, pos_gap: np.ndarray,
                                  n_gap_pad: int, n_he_words: int,
                                  gather_plan, *, mirror: bool = True):
    """Whole-dispatch-tile pack straight from a ShapePackStore: ONE
    threaded native pass (or, without the native library, one
    vectorized 2D gather per field) for T store rows, producing the
    assembled (t_gap uint32 [n_or, Sg_pad, T], t_he uint32
    [n_or, W, T]) planes — the store fast path's per-target Python
    cost collapses to ~zero (scripts/gradscore_host_profile.py).
    Both paths are bit-identical (tests/test_shape_pack.py)."""
    g_pos, h_pos, keep_he = gather_plan
    n_or = 2 if mirror else 1
    t = len(rows)
    sg = pos_gap.size
    sh = h_pos.size // n_or

    from colormipsearch_tpu.io import native_decoder

    if native_decoder.available():
        zsl_mm, grad_mm, tfg_mm = store.field_maps()
        native = native_decoder.shape_tile_from_store(
            zsl_mm, grad_mm, tfg_mm, np.asarray(rows, np.int64),
            pos_gap, g_pos, h_pos, keep_he, n_or, n_gap_pad,
            n_he_words, _SL_SHIFT)
        if native is not None:
            return native

    zsl = store.gather("zsl", rows, pos_gap)           # [T, Sg]
    grad = store.gather("grad", rows, g_pos)           # [T, n_or*Sg]
    tbytes = store.gather("tfg", rows, h_pos >> 3)     # [T, n_or*Sh]
    tfg = ((tbytes >> (h_pos & 7)[None, :]) & 1).astype(bool)
    if keep_he is not None:
        tfg &= keep_he[None, :]

    z_part = zsl.astype(np.uint32) << _SL_SHIFT
    t_gap = np.zeros((n_or, n_gap_pad, t), np.uint32)
    t_gap[0, :sg] = (z_part | grad[:, :sg]).T
    if mirror:
        t_gap[1, :sg] = (z_part | grad[:, sg:]).T
    t_he = np.empty((n_or, n_he_words, t), np.uint32)
    t_he[0] = _packbits32(tfg[:, :sh], n_he_words).T
    if mirror:
        t_he[1] = _packbits32(tfg[:, sh:], n_he_words).T
    return t_gap, t_he


def device_store_fields(store, rows=None):
    """Upload a ShapePackStore's query-independent fields ONCE as
    pixel-major device arrays: (zsl uint16 [n_px, R], grad uint16
    [n_px, R], tfg uint8 [ceil(n_px/8), R]).

    With the fields device-resident, each mask's t_gap/t_he dispatch planes
    are built ON DEVICE from ~KBs of uploaded support positions
    (shape_tile_device) instead of ~27 MB of host-assembled planes per
    mask.  Worth the multi-GB one-time upload only when amortized over
    many masks — the engine gates it behind CDS_SHAPE_STORE_DEVICE=1
    (or the gradientScores CLI's >= 32-mask auto-default).  ``rows`` restricts the upload to
    a subset of store rows (the device tile then indexes positions
    WITHIN that subset)."""
    zsl_mm, grad_mm, tfg_mm = store.field_maps()
    if rows is not None:
        rows = np.asarray(rows)
        zsl_mm = zsl_mm[rows]
        grad_mm = grad_mm[rows]
        tfg_mm = tfg_mm[rows]
    return (_upload_pixel_major(zsl_mm),
            _upload_pixel_major(grad_mm),
            _upload_pixel_major(tfg_mm))


@functools.partial(jax.jit, donate_argnums=0)
def _write_rows(buf, chunk, start):
    # module-level so the jit executable cache is shared across calls
    # and fields (a per-call closure re-traced every upload — review r5)
    return jax.lax.dynamic_update_slice(buf, chunk, (start, 0))


def _upload_pixel_major(field_mm, chunk_bytes: int = 256 << 20):
    """Transpose a [R, n_px] store field to pixel-major [n_px, R] on
    the device in bounded chunks: rows stream in <=chunk_bytes slices
    into a donated buffer, so peak host pinned memory and per-transfer
    size stay bounded at any store size."""
    n_r, n_px = field_mm.shape
    dt = field_mm.dtype
    total = n_r * n_px * dt.itemsize
    if total <= chunk_bytes:
        return jax.block_until_ready(
            jnp.asarray(np.ascontiguousarray(field_mm.T)))
    rows_per = max(1, int(chunk_bytes // (n_r * dt.itemsize)))
    buf = jnp.zeros((n_px, n_r), dt)
    for p0 in range(0, n_px, rows_per):
        sl = np.ascontiguousarray(field_mm[:, p0:p0 + rows_per].T)
        buf = _write_rows(buf, jnp.asarray(sl), jnp.int32(p0))
    return jax.block_until_ready(buf)


@functools.partial(jax.jit, static_argnames=("n_gap_pad", "n_he_words",
                                             "mirror"))
def _shape_tile_device(zsl_T: jax.Array, grad_T: jax.Array,
                       tfg_T: jax.Array, rows_sel: jax.Array,
                       pos_gap_p: jax.Array, g_pos_p: jax.Array,
                       h_pos_p: jax.Array, keep_he_p: jax.Array,
                       sg: jax.Array, sh: jax.Array, *,
                       n_gap_pad: int, n_he_words: int, mirror: bool):
    """Jitted core of shape_tile_device.  All position arrays arrive
    PRE-PADDED to their buckets (pad index 0) and the true support
    sizes sg/sh are TRACED scalars — otherwise every mask's raw
    support size would compile a fresh executable.  Pad rows are zeroed by masks, exactly
    matching the host path's zero-initialized planes."""
    n_or = 2 if mirror else 1
    t = rows_sel.shape[0]
    live_g = (jnp.arange(n_gap_pad) < sg)[:, None]        # [Sgp, 1]
    zs = jnp.take(jnp.take(zsl_T, pos_gap_p, axis=0), rows_sel, axis=1)
    z_part = zs.astype(jnp.uint32) << _SL_SHIFT           # [Sgp, T]
    g = jnp.take(jnp.take(grad_T, g_pos_p, axis=0), rows_sel, axis=1) \
        .astype(jnp.uint32)                          # [n_or*Sgp, T]
    gaps = [jnp.where(live_g, z_part | g[:n_gap_pad], 0)]
    if mirror:
        gaps.append(jnp.where(live_g, z_part | g[n_gap_pad:], 0))
    t_gap = jnp.stack(gaps)

    shp = n_he_words * 32
    live_h = (jnp.arange(shp) < sh)[:, None]              # [Shp, 1]
    tb = jnp.take(jnp.take(tfg_T, h_pos_p >> 3, axis=0), rows_sel,
                  axis=1)                            # [n_or*Shp, T]
    bits = ((tb >> (h_pos_p & 7)[:, None]) & 1).astype(jnp.uint32)
    bits = bits * keep_he_p[:, None].astype(jnp.uint32)
    he = []
    for o in range(n_or):
        b = jnp.where(live_h, bits[o * shp:(o + 1) * shp], 0)
        b = b.reshape(n_he_words, 32, t)
        w = (b << jnp.arange(32, dtype=jnp.uint32)[None, :, None]) \
            .sum(axis=1, dtype=jnp.uint32)
        he.append(w)
    return t_gap, jnp.stack(he)


def shape_tile_device(fields, rows_sel, pos_gap: np.ndarray,
                      g_pos: np.ndarray, h_pos: np.ndarray,
                      keep_he: np.ndarray | None, *, n_gap_pad: int,
                      n_he_words: int, mirror: bool):
    """Device twin of select_target_tile_from_store: builds the
    (t_gap uint32 [n_or, n_gap_pad, T], t_he uint32 [n_or, W, T])
    dispatch planes from device-resident store fields — bit-identical
    to the host path (tests/test_shape_pack.py), with only the mask's
    support positions crossing the wire.  Pads the positions to their
    buckets so kernel shapes are reused across masks."""
    n_or = 2 if mirror else 1
    sg = pos_gap.size
    sh = h_pos.size // n_or
    shp = n_he_words * 32

    def pad_to(a, n):
        out = np.zeros(n, np.int32)
        out[:a.size] = a
        return out

    pos_gap_p = pad_to(pos_gap, n_gap_pad)
    g_pos_p = np.zeros(n_or * n_gap_pad, np.int32)
    for o in range(n_or):
        g_pos_p[o * n_gap_pad:o * n_gap_pad + sg] = \
            g_pos[o * sg:(o + 1) * sg]
    h_pos_p = np.zeros(n_or * shp, np.int32)
    keep_p = np.zeros(n_or * shp, np.uint8)
    for o in range(n_or):
        h_pos_p[o * shp:o * shp + sh] = h_pos[o * sh:(o + 1) * sh]
        keep_p[o * shp:o * shp + sh] = \
            1 if keep_he is None else keep_he[o * sh:(o + 1) * sh]
    return _shape_tile_device(
        *fields, jnp.asarray(np.asarray(rows_sel, np.int32)),
        jnp.asarray(pos_gap_p), jnp.asarray(g_pos_p),
        jnp.asarray(h_pos_p), jnp.asarray(keep_p),
        jnp.int32(sg), jnp.int32(sh),
        n_gap_pad=n_gap_pad, n_he_words=n_he_words, mirror=mirror)


def assemble_target_rows_split(cols: list, n_gap_pad: int,
                               n_he_words: int, *, mirror: bool = True):
    """Stack per-target select_target_cols_split outputs into the
    (t_gap uint32 [n_or, Sg_pad, T], t_he uint32 [n_or, W, T]) host
    planes shape_score_pairs_split consumes.  Callers accumulate/pad on
    the host and upload once per dispatch (the jit converts on call),
    keeping device memory at a single plane set."""
    n_or = 2 if mirror else 1
    if not cols:
        return (np.zeros((n_or, n_gap_pad, 0), np.uint32),
                np.zeros((n_or, n_he_words, 0), np.uint32))
    t_gap = np.stack([c[0] for c in cols], axis=2)
    t_he = np.stack([c[1] for c in cols], axis=2)
    return t_gap, t_he


def pack_target_rows_split(t_rgbs, grads, zgap_rgbs,
                           pos_gap: np.ndarray, n_gap_pad: int,
                           pos_he: np.ndarray, n_he_words: int, *,
                           mask_threshold: int,
                           excluded: np.ndarray | None = None,
                           mirror: bool = True):
    """Split-plane target pack: (t_gap uint32 [n_or, Sg_pad, T],
    t_he uint32 [n_or, n_he_words, T]) with n_or = 2 (straight,
    mirror) or 1.

    Gap rows carry gradient|slice (z-gap fields stay in place across
    orientations; gradient comes from the mirrored column for the mirror
    plane).  He rows carry ONLY the target-foreground bit (straight and
    mirrored columns, masked by the excluded region like the dense
    pack), BITPACKED 32 ring rows per uint32 word — the he term is a
    popcount of t & q words.  Reference semantics:
    ShapeMatchColorDepthSearchAlgorithm:191-240.

    Composition of select_target_cols_split + assemble_target_rows_split
    (the engine calls those directly from its decode workers)."""
    cols = [select_target_cols_split(
                t, g, z, pos_gap, n_gap_pad, pos_he, n_he_words,
                mask_threshold=mask_threshold, excluded=excluded,
                mirror=mirror)
            for t, g, z in zip(t_rgbs, grads, zgap_rgbs)]
    return assemble_target_rows_split(cols, n_gap_pad, n_he_words,
                                      mirror=mirror)


# -------------------------------------------------------------------------
# pair scoring
# -------------------------------------------------------------------------


def shape_score_pairs_raw(t_pack: jax.Array, q_pack: jax.Array):
    """Score one query against T targets.

    Args:
      t_pack: uint32 [P, T] packed target planes.
      q_pack: int32 [P] packed query plane.
    Returns:
      (gap_hi, gap_lo, high_expr): int32 [T] each; the gradient area gap
      is gap_hi * 1024 + gap_lo (combined on host).
    """
    w = t_pack.astype(jnp.int32)
    grad = w & 0xFFFF
    z_sl = (w >> _SL_SHIFT) & 0x1FF
    z_nz = (w >> _ZNZ_SHIFT) & 1
    t_fg = (w >> _TFG_SHIFT) & 1

    q = q_pack[:, None]
    q_sl = q & _Q_SL_MASK
    q_nz = (q >> _Q_NZ_SHIFT) & 1
    q_sig = (q >> _Q_SIG_SHIFT) & 1
    q_he = (q >> _Q_HE_SHIFT) & 1

    # slice gap: if either slice is 0 the gap is the target slice
    sg = jnp.where((q_sl == 0) | (z_sl == 0), z_sl, jnp.abs(q_sl - z_sl))
    overlap = (q_nz & z_nz) == 1
    # grad is pre-thresholded at pack time (> GAP_THRESHOLD or 0) and the
    # slice-gap branch is always >= 2*flux - flux = 40 > GAP_THRESHOLD,
    # so no val threshold is needed here; select replaces the q_sig
    # multiply
    grad_term = jnp.where(q_sig == 1, grad, 0)
    val = jnp.where(overlap & (sg >= 2 * DEFAULT_COLOR_FLUX),
                    sg - DEFAULT_COLOR_FLUX, grad_term)

    gap_lo = (val & 0x3FF).sum(axis=0, dtype=jnp.int32)
    gap_hi = (val >> 10).sum(axis=0, dtype=jnp.int32)
    high_expr = (q_he & t_fg).sum(axis=0, dtype=jnp.int32)
    return gap_hi, gap_lo, high_expr


shape_score_pairs = jax.jit(shape_score_pairs_raw)


def shape_score_pairs_both_raw(t_pack2: jax.Array, q_pack2: jax.Array):
    """Both orientations in ONE dispatch: uint32 [2, S, T] stacked
    (straight, mirror) planes x int32 [2, S] query planes ->
    (gap_hi, gap_lo, high_expr) int32 [2, T] each."""
    return jax.vmap(shape_score_pairs_raw)(t_pack2, q_pack2)


shape_score_pairs_both = jax.jit(shape_score_pairs_both_raw)


def shape_score_pairs_split_raw(t_gap: jax.Array, q_gap: jax.Array,
                                t_he: jax.Array, q_he: jax.Array):
    """Split-row scoring, both orientations in one dispatch.

    Args (see pack_target_rows_split / sparse_query_split):
      t_gap: uint32 [n_or, Sg, T] gradient|slice gap-row planes.
      q_gap: int32 [n_or, Sg] query slice|nz|sig.
      t_he:  uint32 [n_or, W, T] bitpacked ring-row foreground bits
             (32 rows per word).
      q_he:  uint32 [n_or, W] bitpacked ring-row gates (ROI-masked).
    Returns (gap_hi, gap_lo, high_expr) int32 [n_or, T].

    The gap-row kernel drops the HE machinery and the z_nz/tfg field
    extractions of shape_score_pairs (z_nz == (z_sl != 0): the slice
    LUT maps exactly black to 0); the he-row kernel is
    popcount(t & q) — 32 ring rows per vector op.  Semantics equal the
    dense kernel's — proven row-partition-exact in
    tests/test_ops_shape_score.py.
    """

    def gap_one(t_p, q_p):
        w = t_p.astype(jnp.int32)
        grad = w & 0xFFFF
        z_sl = w >> _SL_SHIFT           # nothing packed above the slice
        q = q_p[:, None]
        q_sl = q & _Q_SL_MASK
        q_nz = (q >> _Q_NZ_SHIFT) & 1
        q_sig = (q >> _Q_SIG_SHIFT) & 1
        d = jnp.abs(q_sl - z_sl)
        # overlap ⇒ q_sl != 0 and z_sl != 0 ⇒ sg = |q_sl − z_sl|; the
        # slice-gap branch needs sg >= 2*flux (AbstractGradientBased…
        # pixel gap op); q_nz gate carries the ROI mask
        cond = (q_nz == 1) & (z_sl > 0) & (d >= 2 * DEFAULT_COLOR_FLUX)
        val = jnp.where(cond, d - DEFAULT_COLOR_FLUX,
                        jnp.where(q_sig == 1, grad, 0))
        return ((val & 0x3FF).sum(axis=0, dtype=jnp.int32),
                (val >> 10).sum(axis=0, dtype=jnp.int32))

    def he_one(t_h, q_h):
        gated = jax.lax.population_count(t_h & q_h[:, None])
        return gated.sum(axis=0, dtype=jnp.int32)

    gap_hi_lo = jax.vmap(gap_one)(t_gap, q_gap)
    high_expr = jax.vmap(he_one)(t_he, q_he)
    return gap_hi_lo[1], gap_hi_lo[0], high_expr


shape_score_pairs_split = jax.jit(shape_score_pairs_split_raw)


def combine_gap(gap_hi: np.ndarray, gap_lo: np.ndarray) -> np.ndarray:
    return gap_hi.astype(np.int64) * 1024 + gap_lo.astype(np.int64)


def score_shape_batch(t_pack, t_pack_mirror, q_pack, *, mirror: bool,
                      q_pack_mirror=None, pairs_fn=None):
    """Full shape scoring of one query vs T targets, both orientations.

    Returns (gradient_area_gap int64 [T], high_expression_area int64 [T],
    mirrored bool [T]) with the reference's mirror selection: the
    orientation with the LOWER negative score wins, straight on ties
    (ShapeMatchColorDepthSearchAlgorithm:172-179).

    q_pack_mirror: only needed with an ROI mask — the reference applies
    the (unmirrored) ROI after mirroring the query, which in the
    flip-the-target formulation becomes the query packed with a flipped
    ROI; without ROI both orientations share q_pack.

    pairs_fn: override for the (t_pack, q_pack) -> (hi, lo, he) step —
    the mesh-sharded step (parallel.mesh.make_sharded_shape_step) plugs
    in here; defaults to the single-device jit.
    """
    if pairs_fn is None:
        pairs_fn = shape_score_pairs
    hi, lo, he = pairs_fn(t_pack, jnp.asarray(q_pack))
    gap_s = combine_gap(np.asarray(hi), np.asarray(lo))
    he_s = np.asarray(he).astype(np.int64)
    if not mirror:
        return gap_s, he_s, np.zeros(gap_s.shape, bool)
    if q_pack_mirror is None:
        q_pack_mirror = q_pack
    hi_m, lo_m, he_m = pairs_fn(t_pack_mirror,
                                jnp.asarray(q_pack_mirror))
    gap_m = combine_gap(np.asarray(hi_m), np.asarray(lo_m))
    he_m = np.asarray(he_m).astype(np.int64)
    neg_s = gap_s + he_s // 2
    neg_m = gap_m + he_m // 2
    use_m = neg_m < neg_s
    return (np.where(use_m, gap_m, gap_s), np.where(use_m, he_m, he_s),
            use_m)


def score_shape_batch_stacked(t_rows, q_pack, *, mirror: bool,
                              q_pack_mirror=None, pairs_both_fn=None,
                              pairs_fn=None):
    """Stacked-plane form of score_shape_batch: t_rows is the
    [2, S, T] (or [1, S, T] when mirror=False) output of
    pack_target_rows; both orientations score in ONE device dispatch
    (shape_score_pairs_both).  Same mirror selection semantics: lower
    negative score wins, straight on ties
    (ShapeMatchColorDepthSearchAlgorithm:172-179).
    """
    if not mirror:
        if pairs_fn is None:
            pairs_fn = shape_score_pairs
        hi, lo, he = pairs_fn(t_rows[0], jnp.asarray(q_pack))
        gap_s = combine_gap(np.asarray(hi), np.asarray(lo))
        he_s = np.asarray(he).astype(np.int64)
        return gap_s, he_s, np.zeros(gap_s.shape, bool)
    if pairs_both_fn is None:
        pairs_both_fn = shape_score_pairs_both
    if q_pack_mirror is None:
        q_pack_mirror = q_pack
    q2 = jnp.asarray(np.stack([q_pack, q_pack_mirror]))
    hi, lo, he = (np.asarray(a) for a in pairs_both_fn(t_rows, q2))
    return _select_orientation(hi, lo, he)


def _select_orientation(hi, lo, he):
    """Reference mirror selection on stacked [2, T] (or [1, T]) scores:
    lower negative score wins, straight on ties
    (ShapeMatchColorDepthSearchAlgorithm:172-179)."""
    gap = combine_gap(hi, lo)
    he = he.astype(np.int64)
    if gap.shape[0] == 1:
        return gap[0], he[0], np.zeros(gap.shape[1], bool)
    neg = gap + he // 2
    use_m = neg[1] < neg[0]
    return (np.where(use_m, gap[1], gap[0]),
            np.where(use_m, he[1], he[0]), use_m)


def score_shape_batch_split(t_gap, t_he, q_gap, q_he, *,
                            pairs_split_fn=None):
    """Split-row scoring of one query vs T targets with the reference's
    mirror selection.  q_gap / q_he are the stacked [n_or, ...] query
    planes (n_or matches the packs: 2 with mirror, 1 without)."""
    if pairs_split_fn is None:
        pairs_split_fn = shape_score_pairs_split
    hi, lo, he = (np.asarray(a) for a in
                  pairs_split_fn(t_gap, jnp.asarray(q_gap),
                                 t_he, jnp.asarray(q_he)))
    return _select_orientation(hi, lo, he)

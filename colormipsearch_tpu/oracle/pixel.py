"""Float64-exact pixel-match scoring oracle.

Re-states the color-depth-search positive scoring semantics of the
reference (cds/AbstractColorDepthSearchAlgorithm.java:157-390 and
cds/PixelMatchColorDepthSearchAlgorithm.java) as vectorized numpy float64.
IEEE-754 float64 with identical operation order makes this bit-identical
to the Java implementation; it serves as the correctness oracle for the
device kernels and as the exact fallback for ambiguous boundary pixels.

Design notes (device reformulation, shared with ops/):
  * every RGB pixel is summarized by (class, s, p): a 6-way two-channel
    dominance class, the secondary channel value s and the primary
    channel value p; the hue ratio is s/p,
  * the z-gap between two pixels is a function of those summaries only,
    which lets the device kernels precompute per-image planes once.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from colormipsearch_tpu.constants import (
    BG_GB,
    BR_BG,
    CLASS_BG,
    CLASS_BR,
    CLASS_GB,
    CLASS_GR,
    CLASS_NONE,
    CLASS_RB,
    CLASS_RG,
    GB_GR,
    GR_RG,
    NO_MATCH_GAP,
    RG_RB,
)


def classify_rgb(rgb: np.ndarray):
    """Classify RGB pixels into dominance classes.

    Args:
      rgb: uint8 array [..., 3].

    Returns:
      (cls, s, p): int32 arrays of shape rgb.shape[:-1].
      cls is one of the CLASS_* ids (CLASS_NONE when there is no strictly
      dominant channel — including black pixels); p is the dominant channel
      value, s the larger of the two remaining channels per the class
      definition.  For CLASS_NONE both s and p are 0.
    """
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)

    cls = np.full(r.shape, CLASS_NONE, dtype=np.int32)
    s = np.zeros(r.shape, dtype=np.int32)
    p = np.zeros(r.shape, dtype=np.int32)

    b_dom = (b > r) & (b > g)
    g_dom = (g > b) & (g > r)
    r_dom = (r > b) & (r > g)

    br = b_dom & (r > g)
    bg = b_dom & ~(r > g)
    gb = g_dom & (b > r)
    gr = g_dom & ~(b > r)
    rg = r_dom & (g > b)
    rb = r_dom & ~(g > b)

    for mask, cid, sec, prim in (
        (br, CLASS_BR, r, b),
        (bg, CLASS_BG, g, b),
        (gb, CLASS_GB, b, g),
        (gr, CLASS_GR, r, g),
        (rg, CLASS_RG, g, r),
        (rb, CLASS_RB, b, r),
    ):
        cls = np.where(mask, cid, cls)
        s = np.where(mask, sec, s)
        p = np.where(mask, prim, p)
    return cls, s, p


def ratio_f64(cls: np.ndarray, s: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Hue ratio s/p in float64; 0 when the class is NONE or s == 0.

    Matches the reference, which only sets the ratio when both channels are
    non-zero (the primary channel is always >= 1 inside a class).
    """
    num = s.astype(np.float64)
    den = np.where(p == 0, 1, p).astype(np.float64)
    r = num / den
    return np.where((cls != CLASS_NONE) & (s != 0), r, 0.0)


def pixel_gap(c1, r1, c2, r2):
    """Vectorized z-gap between pixel summaries (float64-exact).

    Args:
      c1, c2: int class ids; r1, r2: float64 hue ratios.
    Returns:
      float64 gap; NO_MATCH_GAP where the hues are incompatible.

    Same operation order as the reference's calculatePixelGap so results
    are bit-identical, including the adjacent-class branches that can go
    negative and the zero-ratio corner cases.
    """
    c1 = np.asarray(c1)
    r1 = np.asarray(r1, dtype=np.float64)
    c2 = np.asarray(c2)
    r2 = np.asarray(r2, dtype=np.float64)

    gap = np.full(np.broadcast(c1, c2).shape, NO_MATCH_GAP, dtype=np.float64)

    same = (c1 == c2) & (c1 != CLASS_NONE) & (r1 > 0) & (r2 > 0)
    gap = np.where(same, np.abs(r2 - r1), gap)

    # Adjacent-class branches: (query class, target class, condition, value).
    # The sums below can be negative by design; both orderings in the
    # reference produce the same IEEE sum, so a single expression suffices.
    adjacent = (
        (CLASS_BR, CLASS_BG, (r1 < 0.44) & (r2 < 0.54), (r1 - BR_BG) + (r2 - BR_BG)),
        (CLASS_BG, CLASS_BR, (r1 < 0.54) & (r2 < 0.44), (r2 - BR_BG) + (r1 - BR_BG)),
        (CLASS_BG, CLASS_GB, (r1 > 0.8) & (r2 > 0.8), (BG_GB - r1) + (BG_GB - r2)),
        (CLASS_GB, CLASS_BG, (r1 > 0.8) & (r2 > 0.8), (BG_GB - r1) + (BG_GB - r2)),
        (CLASS_GB, CLASS_GR, (r1 < 0.7) & (r2 < 0.7), (r1 - GB_GR) + (r2 - GB_GR)),
        (CLASS_GR, CLASS_GB, (r1 < 0.7) & (r2 < 0.7), (r1 - GB_GR) + (r2 - GB_GR)),
        (CLASS_GR, CLASS_RG, (r1 > 0.8) & (r2 > 0.8), (GR_RG - r1) + (GR_RG - r2)),
        (CLASS_RG, CLASS_GR, (r1 > 0.8) & (r2 > 0.8), (GR_RG - r2) + (GR_RG - r1)),
        (CLASS_RG, CLASS_RB, (r1 < 0.7) & (r2 < 0.7), (r2 - RG_RB) + (r1 - RG_RB)),
        (CLASS_RB, CLASS_RG, (r1 < 0.7) & (r2 < 0.7), (r2 - RG_RB) + (r1 - RG_RB)),
    )
    for qc, tc, cond, value in adjacent:
        gap = np.where((c1 == qc) & (c2 == tc) & cond, value, gap)
    return gap


def shift_offsets(xy_shift: int):
    """Enumerate the xy-shift variants of the reference.

    For the first even radius (2), all 9 combinations of (dx, dy) in
    {-2, 0, 2}^2 in the reference's loop order; each further even radius
    i <= xy_shift adds its 8 non-identity offsets.  Total
    1 + (xy_shift/2)*8 — the variant-count the reference sizes its arrays
    for (generateShiftedMasks:113-130; its literal loop would emit the
    (0,0) identity once per radius, overflowing its own nshifts-sized
    array for xy_shift > 2, so de-duplicating the identity is both the
    intended semantics and one less gather pass per extra radius).
    """
    if xy_shift <= 0:
        return [(0, 0)]
    out = []
    for i in range(2, xy_shift + 1, 2):
        for dx in (-i, 0, i):
            for dy in (-i, 0, i):
                if (dx, dy) == (0, 0) and i > 2:
                    continue
                out.append((dx, dy))
    return out


def label_regions_mask(width: int, height: int,
                       with_name_label: bool = True,
                       with_color_scale_label: bool = True,
                       color_scale_width: int = 270) -> np.ndarray:
    """Boolean [H, W] mask of the text-label regions excluded from search.

    Matches cmd/AbstractColorDepthMatchArgs.getRegionGeneratorForTextLabels:
    the name label occupies x < 330, y < 100; the color scale occupies
    x >= width - color_scale_width, y < 90 (only when width > the scale
    width).
    """
    yy, xx = np.mgrid[0:height, 0:width]
    region = np.zeros((height, width), dtype=bool)
    if with_color_scale_label and width > color_scale_width:
        region |= (xx >= width - color_scale_width) & (yy < 90)
    if with_name_label:
        region |= (xx < 330) & (yy < 100)
    return region


@dataclasses.dataclass
class PixelMatchResult:
    matching_pixels: int
    matching_pixels_ratio: float
    mirrored: bool
    per_variant: np.ndarray | None = None  # int64 [V] scores, straight variants
    per_variant_mirror: np.ndarray | None = None


class PixelMatchOracle:
    """Exact scorer for one query (mask) image against target images.

    Precomputes the query foreground positions above the threshold outside
    the excluded regions plus all shifted/mirrored target lookup position
    arrays, mirroring cds/PixelMatchColorDepthSearchAlgorithm.java:29-158.
    """

    def __init__(self, query_rgb: np.ndarray, query_threshold: int,
                 *, mirror: bool, target_threshold: int, z_tolerance: float,
                 xy_shift: int, excluded_region: np.ndarray | None = None,
                 neg_query_rgb: np.ndarray | None = None,
                 neg_query_threshold: int = 0, mirror_neg_query: bool = False):
        assert query_rgb.ndim == 3 and query_rgb.shape[-1] == 3
        h, w = query_rgb.shape[:2]
        self.height, self.width = h, w
        self.target_threshold = int(target_threshold)
        self.z_tolerance = float(z_tolerance)
        self.mirror = bool(mirror)

        fg = (query_rgb > query_threshold).any(axis=-1)
        if excluded_region is not None:
            fg &= ~excluded_region
        # row-major positions, like the reference's position scan
        self.positions = np.flatnonzero(fg.reshape(-1)).astype(np.int64)
        self.query_size = int(self.positions.size)

        cls, s, p = classify_rgb(query_rgb.reshape(-1, 3))
        r = ratio_f64(cls, s, p)
        self.q_cls = cls[self.positions]
        self.q_ratio = r[self.positions]

        # shifted target-lookup position arrays (out of bounds -> -1)
        x = self.positions % w
        y = self.positions // w
        shifted = []
        for dx, dy in shift_offsets(xy_shift):
            nx, ny = x + dx, y + dy
            ok = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < h)
            pos = np.where(ok, ny * w + nx, -1)
            shifted.append(pos)
        self.variants = np.stack(shifted)  # >=1 offset always
        if mirror:
            vx = self.variants % w
            self.mirror_variants = np.where(
                self.variants < 0, -1, self.variants + (w - 1) - 2 * vx)
        else:
            self.mirror_variants = None

        # Negative-query state (PixelMatchColorDepthSearchAlgorithm:36-57,
        # 195-217).  The neg pass zips the POSITIVE query positions (source
        # pixels read from the negative image) with the shifted NEGATIVE
        # query position arrays (target lookups), truncated to the shorter
        # of the two (calculateScore's min-length loop :239).
        self.neg_query_size = 0
        if neg_query_rgb is not None:
            assert neg_query_rgb.shape[:2] == (h, w)
            neg_fg = (neg_query_rgb > neg_query_threshold).any(axis=-1)
            if excluded_region is not None:
                neg_fg &= ~excluded_region
            neg_positions = np.flatnonzero(neg_fg.reshape(-1)).astype(np.int64)
            self.neg_query_size = int(neg_positions.size)
            size = min(self.query_size, self.neg_query_size)
            ncls, ns, np_ = classify_rgb(neg_query_rgb.reshape(-1, 3))
            nr = ratio_f64(ncls, ns, np_)
            src = self.positions[:size]
            self.neg_src_cls = ncls[src]
            self.neg_src_ratio = nr[src]
            nx = neg_positions % w
            ny = neg_positions // w
            shifted = []
            for dx, dy in shift_offsets(xy_shift):
                sx, sy = nx + dx, ny + dy
                ok = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
                shifted.append(np.where(ok, sy * w + sx, -1)[:size])
            self.neg_variants = np.stack(shifted)
            if mirror_neg_query:
                vx = self.neg_variants % w
                self.neg_mirror_variants = np.where(
                    self.neg_variants < 0, -1,
                    self.neg_variants + (w - 1) - 2 * vx)
            else:
                self.neg_mirror_variants = None

    def _score_variants(self, t_cls, t_ratio, t_fgmax, variants,
                        src_cls=None, src_ratio=None) -> np.ndarray:
        if src_cls is None:
            src_cls, src_ratio = self.q_cls, self.q_ratio
        scores = np.zeros(len(variants), dtype=np.int64)
        for i, pos in enumerate(variants):
            ok = pos >= 0
            tp = pos[ok]
            sel = t_fgmax[tp] > self.target_threshold
            if not sel.any():
                continue
            gaps = pixel_gap(src_cls[ok][sel], src_ratio[ok][sel],
                             t_cls[tp][sel], t_ratio[tp][sel])
            scores[i] = int(np.count_nonzero(gaps <= self.z_tolerance))
        return scores

    def score(self, target_rgb: np.ndarray) -> PixelMatchResult:
        assert target_rgb.shape[:2] == (self.height, self.width), \
            "target image size must match the query image size"
        if self.query_size == 0:
            return PixelMatchResult(0, 0.0, False)
        flat = target_rgb.reshape(-1, 3)
        t_cls, t_s, t_p = classify_rgb(flat)
        t_ratio = ratio_f64(t_cls, t_s, t_p)
        t_fgmax = flat.astype(np.int32).max(axis=-1)

        straight = self._score_variants(t_cls, t_ratio, t_fgmax, self.variants)
        best = int(straight.max(initial=0))
        mirrored = False
        mirror_scores = None
        if self.mirror_variants is not None:
            mirror_scores = self._score_variants(
                t_cls, t_ratio, t_fgmax, self.mirror_variants)
            m = int(mirror_scores.max(initial=0))
            if m > best:
                best, mirrored = m, True
        ratio = best / self.query_size
        if self.neg_query_size > 0:
            # score subtraction: maxMatchingPixels -= round(negMax *
            # querySize / negQuerySize); the mirrored flag is decided by
            # the positive pass only (calculateMatchingScore:195-217)
            neg_max = int(self._score_variants(
                t_cls, t_ratio, t_fgmax, self.neg_variants,
                self.neg_src_cls, self.neg_src_ratio).max(initial=0))
            if self.neg_mirror_variants is not None:
                neg_max = max(neg_max, int(self._score_variants(
                    t_cls, t_ratio, t_fgmax, self.neg_mirror_variants,
                    self.neg_src_cls, self.neg_src_ratio).max(initial=0)))
            # Java Math.round(double) == floor(x + 0.5)
            best = int(np.floor(
                float(best)
                - float(neg_max) * self.query_size / self.neg_query_size
                + 0.5))
            ratio -= neg_max / self.neg_query_size
        return PixelMatchResult(
            matching_pixels=best,
            matching_pixels_ratio=ratio,
            mirrored=mirrored,
            per_variant=straight,
            per_variant_mirror=mirror_scores,
        )

"""Shared device-side pixel classification and packing.

The device reformulation of the reference's per-pixel hue logic
(cds/AbstractColorDepthSearchAlgorithm.java:157-390): every RGB pixel is
summarized once into a packed uint32

    bits  0..7   max channel value  (for the data threshold test)
    bits  8..15  s: secondary channel value
    bits 16..23  p: primary (dominant) channel value
    bits 24..26  dominance class id (CLASS_*)

so the pairwise z-gap predicate becomes integer/float32 arithmetic on two
summaries.  Target stacks are packed into pixel-major [P, T] planes: a
gather at a query position yields the lane-contiguous vector of all T
targets' summaries — the layout that makes query-position gathers
read contiguous rows and shards naturally over the target axis.
"""

from __future__ import annotations

import functools

from fractions import Fraction

import jax
import jax.numpy as jnp

from colormipsearch_tpu.constants import (
    CLASS_BG,
    CLASS_BR,
    CLASS_GB,
    CLASS_GR,
    CLASS_RB,
    CLASS_RG,
)


def classify(rgb: jax.Array):
    """uint8 [..., 3] -> (cls, s, p, maxch) int32 arrays.

    Same strict-dominance classification as the pixel-match oracle: ties
    (including black) produce class 0 with s = p = 0.
    """
    r = rgb[..., 0].astype(jnp.int32)
    g = rgb[..., 1].astype(jnp.int32)
    b = rgb[..., 2].astype(jnp.int32)

    b_dom = (b > r) & (b > g)
    g_dom = (g > b) & (g > r)
    r_dom = (r > b) & (r > g)
    rg_gt = r > g
    bg_gt = b > r
    gb_gt = g > b

    cls = jnp.where(
        b_dom, jnp.where(rg_gt, CLASS_BR, CLASS_BG),
        jnp.where(
            g_dom, jnp.where(bg_gt, CLASS_GB, CLASS_GR),
            jnp.where(r_dom, jnp.where(gb_gt, CLASS_RG, CLASS_RB), 0)))
    p = jnp.where(b_dom, b, jnp.where(g_dom, g, jnp.where(r_dom, r, 0)))
    s = jnp.where(
        b_dom, jnp.where(rg_gt, r, g),
        jnp.where(
            g_dom, jnp.where(bg_gt, b, r),
            jnp.where(r_dom, jnp.where(gb_gt, g, b), 0)))
    maxch = jnp.maximum(jnp.maximum(r, g), b)
    return cls, s, p, maxch


def pack_summary(cls, s, p, maxch) -> jax.Array:
    """Pack classification into uint32 (see module docstring)."""
    packed = (cls << 24) | (p << 16) | (s << 8) | maxch
    return packed.astype(jnp.uint32)


def unpack_summary(packed: jax.Array):
    """uint32 -> (cls, s, p, maxch) int32."""
    v = packed.astype(jnp.int32)
    return (v >> 24) & 0x7, (v >> 8) & 0xFF, (v >> 16) & 0xFF, v & 0xFF


@functools.partial(jax.jit, static_argnames=("data_threshold",))
def pack_target_planes(rgb_stack: jax.Array,
                       data_threshold: int | None = None) -> jax.Array:
    """uint8 [T, H, W, 3] -> packed uint32 [P, T] pixel-major planes.

    With `data_threshold`, below-threshold pixels pack to the zero word
    (class 0 matches nothing and flags nothing), so the kernel's
    per-element threshold test becomes dead code — callers then pass
    target_threshold=-1 to the scoring kernels and XLA folds the
    comparison away.
    """
    t = rgb_stack.shape[0]
    cls, s, p, maxch = classify(rgb_stack)
    packed = pack_summary(cls, s, p, maxch)
    if data_threshold is not None:
        packed = jnp.where(maxch > data_threshold, packed, 0)
    return packed.reshape(t, -1).T


@functools.partial(jax.jit, static_argnames=("data_threshold",))
def pack_target_planes_split(rgb_stack: jax.Array,
                             data_threshold: int):
    """uint8 [T, H, W, 3] -> (uint16 [P, T] (p<<8)|s, uint8 [P, T] cls).

    Split-plane layout for the pixel kernel: 3 gathered bytes/pixel
    instead of 4.  The data threshold is ALWAYS folded here (a dead
    pixel zeroes both planes; class 0 neither matches nor flags), so
    consumers score with target_threshold=-1.  Serves the opt-in split
    kernel path (pixel_match.score_query_batch_split).
    """
    t = rgb_stack.shape[0]
    cls, s, p, maxch = classify(rgb_stack)
    live = maxch > data_threshold
    sp = jnp.where(live, (p << 8) | s, 0).astype(jnp.uint16)
    c8 = jnp.where(live, cls, 0).astype(jnp.uint8)
    return sp.reshape(t, -1).T, c8.reshape(t, -1).T


def split_planes_from_packed(planes: jax.Array):
    """uint32 [P, T] packed planes -> the split-plane pair.

    The packed word already has the threshold folded when built with
    pack_target_planes(data_threshold=...); this just re-slices bits.
    """
    v = planes.astype(jnp.uint32)
    sp = ((v >> 8) & 0xFFFF).astype(jnp.uint16)   # (p<<8)|s
    c8 = ((v >> 24) & 0x7).astype(jnp.uint8)
    return sp, c8


# --- rank-key planes (interval predicate) --------------------------------
#
# Alternative target encoding for the pixel-match kernel: each valid pixel
# packs to key = (cls << KEY_RANK_BITS) | rank, where `rank` is the index
# of the pixel's hue ratio s/p in the sorted list of ALL achievable ratios
# (s < p <= 255 by strict dominance -> ~19.7k distinct rationals < 2^15).
# Because the reference's float64 match set for one query pixel against a
# fixed target class is an interval of that ratio order (same-class:
# |r2-r1| <= z is a window; adjacent-class: precondition and gap bound
# both one-sided), the whole per-element predicate collapses to three
# unsigned range tests on the gathered key — no unpack, no arithmetic on
# s/p, no float conversion, and (with host-side exact interval endpoints)
# no ambiguity band at all.

KEY_RANK_BITS = 15


@functools.lru_cache(maxsize=1)
def ratio_rank_table():
    """(vals float64 [R], rank int32 [256, 256]) for ratios s/p, s < p.

    `vals` is sorted ascending (vals[0] == 0.0); rank[s, p] is the index
    of float64(s/p) in vals.  Distinct rationals stay distinct in f64
    (the minimum spacing of fractions with denominators <= 255 is
    ~1.5e-5, ~1e11 ulps), so f64 order == rational order.  Entries with
    s >= p or p == 0 are unreachable (strict dominance) and map to 0.
    """
    import numpy as np

    sv, pv = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    valid = (pv >= 1) & (sv < pv)
    r = sv / np.maximum(pv, 1)
    vals = np.unique(r[valid])
    assert vals.size < (1 << KEY_RANK_BITS), vals.size
    rank = np.zeros((256, 256), np.int32)
    rank[valid] = np.searchsorted(vals, r[valid]).astype(np.int32)
    return vals, rank


@functools.lru_cache(maxsize=1)
def _rank_lut_flat():
    import numpy as np

    _, rank = ratio_rank_table()
    return np.ascontiguousarray(rank.reshape(-1))


def rank_lut_device() -> jax.Array:
    """The (s << 8) | p -> rank LUT as a device int32 [65536] array."""
    return jnp.asarray(_rank_lut_flat())


@functools.partial(jax.jit, static_argnames=("data_threshold",))
def pack_target_planes_keys(rgb_stack: jax.Array, data_threshold: int,
                            rank_lut: jax.Array) -> jax.Array:
    """uint8 [T, H, W, 3] -> int32 [P+1, T] rank-key planes.

    The data threshold is ALWAYS folded (key 0 neither matches nor
    flags); row P is an all-zero sentinel so query plans can encode
    padded / out-of-bounds positions as P and skip per-element validity
    masks in the kernel.
    """
    t = rgb_stack.shape[0]
    cls, s, p, maxch = classify(rgb_stack)
    rank = jnp.take(rank_lut, (s << 8) | p)
    key = (cls << KEY_RANK_BITS) | rank
    key = jnp.where((maxch > data_threshold) & (cls > 0), key, 0)
    planes = key.astype(jnp.int32).reshape(t, -1).T
    return jnp.pad(planes, ((0, 1), (0, 0)))


# elements per scatter chunk: bounds the scatter's index-tensor
# transient (XLA materializes [chunk, 2] s32 pairs — an UNCHUNKED
# 58.7M-element dress shard allocated 30 GB and OOMed) and gives every
# shard the same compiled chunk shape
_SCATTER_CHUNK = 4 << 20


@functools.partial(jax.jit, static_argnames=("t_pad", "n_px"),
                   donate_argnums=(0,))
def _scatter_key_chunk(planes: jax.Array, pos: jax.Array,
                       rgb: jax.Array, cum: jax.Array,
                       start: jax.Array, rank_lut: jax.Array, *,
                       t_pad: int, n_px: int) -> jax.Array:
    """Scatter one chunk of sparse foreground pixels into the donated
    [P+1, T] planes.  The target index is RECONSTRUCTED on device from
    the cumulative per-target foreground counts (elements arrive
    target-major from the COO select), saving 4 of the 9 uploaded
    bytes per pixel.  Pad elements (global index >= sum(counts)) carry
    pos = n_px (the sentinel row) and rgb = 0 -> key 0, and
    searchsorted sends them past the last target (clamped), so the
    sentinel row stays all-zero."""
    cls, s, p, _ = classify(rgb)
    rank = jnp.take(rank_lut, (s << 8) | p)
    key = jnp.where(cls > 0, (cls << KEY_RANK_BITS) | rank, 0) \
        .astype(jnp.int32)
    gidx = start + jnp.arange(pos.shape[0], dtype=cum.dtype)
    tidx = jnp.searchsorted(cum, gidx, side="right")
    tidx = jnp.minimum(tidx, t_pad - 1).astype(jnp.int32)
    return planes.at[pos, tidx].set(key, mode="drop",
                                    unique_indices=False)


def pack_target_planes_keys_sparse(stack: "object", data_threshold: int,
                                   rank_lut: jax.Array,
                                   t_pad: int) -> jax.Array:
    """Host uint8 [T, H, W, 3] -> device int32 [P+1, t_pad] key planes
    via a sparse COO upload.

    CDMs are ~98% black and the data threshold is folded into the pack,
    so only foreground pixels (any channel > threshold) influence the
    planes.  Uploading (position, target, rgb) triplets for those
    pixels moves ~25x fewer bytes than the dense uint8 stack (a
    production 4096-target shard is 8.4 GB dense vs ~350 MB sparse;
    whether that pays over PCIe is ROADMAP D3).  Bit-identical to pack_target_planes_keys: the
    same classify/rank runs on device, just only at foreground pixels
    (key 0 everywhere else in BOTH paths — proven in
    tests/test_ops_pixel_keys.py).
    """
    import time as _time

    import numpy as np

    from colormipsearch_tpu.utils.metrics import GLOBAL as _M

    t, h, w, _ = stack.shape
    n_px = h * w
    t0 = _time.time()
    sel = None
    try:
        from colormipsearch_tpu.io import native_decoder
        if stack.flags.c_contiguous:
            # threaded native select (~100x the numpy nonzero path,
            # which measured ~24 ms/target at production shape)
            sel = native_decoder.coo_select(stack, data_threshold)
    except ImportError:
        pass
    if sel is not None:
        pos, tidx, vals = sel
    else:
        flat = stack.reshape(t, n_px, 3)
        live = flat.max(axis=2) > data_threshold
        tidx, pos = np.nonzero(live)
        vals = flat[tidx, pos]
    n = pos.size
    # jax canonicalizes int64 to int32 (x64 is never enabled here), so
    # fail LOUDLY before indices could wrap instead of scattering to
    # wrong targets silently (review r4)
    assert n < 2**31, \
        f"sparse shard has {n} foreground pixels (>= 2^31): split the " \
        "shard (tile_size) before packing"
    counts = np.bincount(tidx, minlength=t_pad).astype(np.int32)
    # pad to whole scatter chunks: ONE compiled chunk shape serves
    # every shard size (and every run)
    n_pad = max(_SCATTER_CHUNK,
                -(-n // _SCATTER_CHUNK) * _SCATTER_CHUNK)
    pos_p = np.full(n_pad, n_px, np.int32)
    pos_p[:n] = pos
    vals_p = np.zeros((n_pad, 3), np.uint8)
    vals_p[:n] = vals
    _M.add("cds.packSelect.seconds", _time.time() - t0)
    t0 = _time.time()
    d_cum = jnp.asarray(np.cumsum(counts).astype(np.int64))
    planes = jnp.zeros((n_px + 1, t_pad), jnp.int32)
    for c0 in range(0, n_pad, _SCATTER_CHUNK):
        planes = _scatter_key_chunk(
            planes, jnp.asarray(pos_p[c0:c0 + _SCATTER_CHUNK]),
            jnp.asarray(vals_p[c0:c0 + _SCATTER_CHUNK]), d_cum,
            jnp.int64(c0), rank_lut, t_pad=t_pad, n_px=n_px)
    jax.block_until_ready(planes)  # honest stage timing
    _M.add("cds.packScatter.seconds", _time.time() - t0)
    return planes


@jax.jit
def key_planes_from_packed(planes: jax.Array,
                           rank_lut: jax.Array) -> jax.Array:
    """uint32 [P, T] packed planes (threshold folded) -> int32 [P+1, T]
    rank-key planes with the sentinel row appended."""
    v = planes.astype(jnp.int32)
    cls = (v >> 24) & 0x7
    s = (v >> 8) & 0xFF
    p = (v >> 16) & 0xFF
    rank = jnp.take(rank_lut, (s << 8) | p)
    key = jnp.where(cls > 0, (cls << KEY_RANK_BITS) | rank, 0)
    return jnp.pad(key.astype(jnp.int32), ((0, 1), (0, 0)))


def ztol_fraction(pix_color_fluctuation) -> tuple[int, int]:
    """Exact rational z-tolerance a/b from the CLI fluctuation value.

    The reference computes zTolerance = pixColorFluctuation / 100 in
    float64.  For the SAME-CLASS comparison every achievable gap is a
    rational with denominator <= 255*255, far from the float64 rounding
    of a/b, so comparing against the exact rational is equivalent (exact
    ties are flagged and resolved by the float64 oracle).  Adjacent-class
    gaps embed the float64 boundary constants and go through the
    banded-f32 path in ops/pixel_match instead.
    """
    f = Fraction(str(pix_color_fluctuation)) / 100
    return f.numerator, f.denominator

"""Multi-device sharding of the all-pairs search.

Replacement of the reference's distribution mechanisms (Spark RDD over
targets — cmd/cdsprocess/SparkColorMIPSearchProcessor.java:43-81; LSF
tile sharding — scripts/submitCDSBatch.sh): the target library is
sharded over a 1-D device mesh along the `targets` axis (each device
holds its shard of the packed uint32 summary planes in device memory),
masks are replicated, and one `shard_map`-ped step scores a mask
against every shard concurrently.  Cross-device reductions that the
reference does driver-side (per-mask global max for normalization,
top-k merge — CalculateGradientScoresCmd.java:443-459,
ItemsHandling.selectTopRanked) become collectives, which XLA hands to
NCCL: `pmax` for the global max, all_gather of per-shard top-k for the
merged ranking.  The cards of one host reach each other all to all over
NVLink, so the mesh stays 1-D over targets.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from colormipsearch_tpu.ops import pixel_match

TARGET_AXIS = "targets"


def create_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the available devices (the target-sharding axis)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (TARGET_AXIS,))


def shard_target_planes(mesh: Mesh, planes) -> jax.Array:
    """Place packed [..., P, T] planes with the trailing T axis sharded
    across the mesh (works for [P, T] planes and the shape pass's
    stacked [2, S, T] orientation planes).

    Under `jax.distributed` (process_count > 1, e.g. several hosts) the
    mesh spans non-addressable devices, so the placement goes through
    `make_array_from_callback`: every process holds the same host
    planes (each loads the full target list from the shared
    filesystem, like the reference's Spark executors) and contributes
    only its addressable shards."""
    spec = P(*([None] * (planes.ndim - 1)), TARGET_AXIS)
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() > 1:
        host = np.asarray(planes)
        return jax.make_array_from_callback(
            host.shape, sharding, lambda idx: host[idx])
    return jax.device_put(planes, sharding)


def local_target_mask(arr, t_pad: int) -> np.ndarray:
    """bool [t_pad]: the trailing-axis columns of a target-sharded
    array that THIS process's devices hold (all True single-process).
    The per-process write sharding of the multi-host CLI run derives
    from this mask."""
    mask = np.zeros(t_pad, bool)
    for s in arr.addressable_shards:
        mask[s.index[-1]] = True
    return mask


def pull_target_cols(arr) -> np.ndarray:
    """np.asarray for a target-sharded result that works across
    processes: single-process is a plain pull; multi-process returns a
    full-width array with ONLY this process's columns populated (other
    columns zero — score 0 / flag 0 emits nothing downstream), which
    is exactly the per-process sharded-write semantics."""
    if jax.process_count() == 1:
        return np.asarray(arr)
    out = np.zeros(arr.shape, arr.dtype)
    for s in arr.addressable_shards:
        out[s.index] = np.asarray(s.data)
    return out


def make_sharded_search_step(mesh: Mesh, *, target_threshold: int,
                             ztol_num: int, ztol_den: int,
                             n_straight: int, top_k: int = 0):
    """Build the jitted multi-device search step.

    Returns fn(planes[P, T], pos[V, Q], q_cls[Q], q_s[Q], q_p[Q]) ->
      (best[T], mirrored[T], pair_flags[T], global_max[],
       topk_scores[D*k], topk_idx[D*k])  (top-k parts only if top_k > 0).

    The step runs one query against every target shard in SPMD, then:
      * `pmax` over the target axis for the global best score (the
        per-mask max the reference reduces driver-side),
      * optional per-shard `lax.top_k` + `all_gather` so the host only
        sees D*k candidates instead of T scores.
    """

    def local_step(planes, pos, q_cls, q_s, q_p):
        scores, flags = pixel_match.score_query_against_planes_raw(
            planes, pos, q_cls, q_s, q_p,
            target_threshold=target_threshold,
            ztol_num=ztol_num, ztol_den=ztol_den)
        best, mirrored, pair_flags = pixel_match.reduce_variants_device(
            scores, flags, n_straight)
        global_max = jax.lax.pmax(best.max(), TARGET_AXIS)
        if top_k > 0:
            k = min(top_k, best.shape[0])
            top_scores, top_idx = jax.lax.top_k(best, k)
            # translate shard-local indices to global target indices
            shard = jax.lax.axis_index(TARGET_AXIS)
            top_idx = top_idx + shard * best.shape[0]
            top_scores = jax.lax.all_gather(top_scores, TARGET_AXIS,
                                            tiled=True)
            top_idx = jax.lax.all_gather(top_idx, TARGET_AXIS, tiled=True)
            return best, mirrored, pair_flags, global_max, top_scores, top_idx
        return best, mirrored, pair_flags, global_max

    out_specs = (P(TARGET_AXIS), P(TARGET_AXIS), P(TARGET_AXIS), P())
    if top_k > 0:
        out_specs = out_specs + (P(), P())

    step = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(None, TARGET_AXIS), P(None, None), P(None), P(None),
                  P(None)),
        out_specs=out_specs,
        check_vma=False)
    return jax.jit(step)


def make_sharded_batch_step_split(mesh: Mesh, *, ztol_num: int,
                                  ztol_den: int, n_straight: int):
    """Split-plane (u16 (p<<8)|s + u8 cls) twin of the dense
    make_sharded_batch_step: 3 gathered bytes/pixel instead of 4; the
    data threshold must be folded into the planes."""

    def local_step(t_sp, t_c8, pos, q_cls, q_s, q_p):
        def one(args):
            pos_b, cls_b, s_b, p_b = args
            scores, flags = \
                pixel_match.score_query_against_split_planes_raw(
                    t_sp, t_c8, pos_b, cls_b, s_b, p_b,
                    ztol_num=ztol_num, ztol_den=ztol_den)
            return pixel_match.reduce_variants_device(
                scores, flags, n_straight)

        best, mirrored, pair_flags = jax.lax.map(
            one, (pos, q_cls, q_s, q_p))
        global_max = jax.lax.pmax(best.max(axis=-1), TARGET_AXIS)
        return best, mirrored, pair_flags, global_max

    step = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(None, TARGET_AXIS), P(None, TARGET_AXIS),
                  P(None, None, None), P(None, None), P(None, None),
                  P(None, None)),
        out_specs=(P(None, TARGET_AXIS), P(None, TARGET_AXIS),
                   P(None, TARGET_AXIS), P(None)),
        check_vma=False)
    return jax.jit(step)


def make_sharded_shape_step(mesh: Mesh, *, both: bool = False):
    """Multi-device shape (gradient-area-gap) pass: packed target planes
    sharded on T, the packed query plane replicated; every device
    scores its target shard with the fused elementwise+reduce kernel
    (ops/shape_score.py).  No cross-device reduction is needed — scores
    are per (query, target) — so the outputs stay T-sharded and the
    per-mask normalization max happens host-side over the gathered
    values, mirroring CalculateGradientScoresCmd.updateNormalizedScores.

    both=False: fn(t_pack[P, T], q[P]) -> 3 x [T].
    both=True:  fn(t_pack2[2, S, T], q2[2, S]) -> 3 x [2, T] — straight
    and mirror orientations in one dispatch (shape_score_pairs_both).
    """
    from colormipsearch_tpu.ops import shape_score

    if both:
        def local_step(t_pack2, q_pack2):
            return shape_score.shape_score_pairs_both_raw(t_pack2, q_pack2)

        step = jax.shard_map(
            local_step, mesh=mesh,
            in_specs=(P(None, None, TARGET_AXIS), P(None, None)),
            out_specs=(P(None, TARGET_AXIS), P(None, TARGET_AXIS),
                       P(None, TARGET_AXIS)),
            check_vma=False)
        return jax.jit(step)

    def local_step(t_pack, q_pack):
        return shape_score.shape_score_pairs_raw(t_pack, q_pack)

    step = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(None, TARGET_AXIS), P(None)),
        out_specs=(P(TARGET_AXIS), P(TARGET_AXIS), P(TARGET_AXIS)),
        check_vma=False)
    return jax.jit(step)


def make_sharded_shape_split_step(mesh: Mesh):
    """Sharded form of the split-row shape kernel
    (ops/shape_score.shape_score_pairs_split): gap and he planes both
    sharded on the trailing target axis, query planes replicated;
    fn(t_gap[n_or, Sg, T], q_gap[n_or, Sg], t_he[n_or, Sh, T],
    q_he[n_or, Sh]) -> 3 x [n_or, T]."""
    from colormipsearch_tpu.ops import shape_score

    def local_step(t_gap, q_gap, t_he, q_he):
        return shape_score.shape_score_pairs_split_raw(
            t_gap, q_gap, t_he, q_he)

    step = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(None, None, TARGET_AXIS), P(None, None),
                  P(None, None, TARGET_AXIS), P(None, None)),
        out_specs=(P(None, TARGET_AXIS), P(None, TARGET_AXIS),
                   P(None, TARGET_AXIS)),
        check_vma=False)
    return jax.jit(step)


def _finish_batched_step(best, mirrored, pair_flags, top_k: int):
    """Shared tail of the batched sharded steps: pmax global max plus
    (when top_k > 0) the per-shard top-k merge — local top_k, mirror/flag
    selection, shard-offset global indices, psum'd flag-leak count, and
    the tiled all_gather of D*k candidates per mask."""
    global_max = jax.lax.pmax(best.max(axis=-1), TARGET_AXIS)
    if top_k <= 0:
        return best, mirrored, pair_flags, global_max
    k = min(top_k, best.shape[1])
    top_scores, local_idx = jax.lax.top_k(best, k)               # [B, k]
    take = jnp.take_along_axis
    top_mirrored = take(mirrored, local_idx, axis=1)
    top_flags = take(pair_flags, local_idx, axis=1)
    # ambiguity-flagged pairs OUTSIDE the per-shard top-k: their exact
    # (oracle) score may exceed selected fast scores, so the engine
    # falls back to a dense pull when any leak out (the bit-identity
    # contract beats the bandwidth saving on these rare batches; on
    # exact kernels flags are structurally zero and this folds away)
    n_flagged = jax.lax.psum(
        (pair_flags > 0).sum(axis=1, dtype=jnp.int32), TARGET_AXIS)
    shard = jax.lax.axis_index(TARGET_AXIS)
    top_idx = local_idx + shard * best.shape[1]
    gather = lambda x: jax.lax.all_gather(  # noqa: E731
        x, TARGET_AXIS, axis=1, tiled=True)
    return (gather(top_scores), gather(top_idx),
            gather(top_mirrored), gather(top_flags), global_max,
            n_flagged)


def _batched_out_specs(top_k: int):
    if top_k > 0:
        return (P(), P(), P(), P(), P(None), P(None))
    return (P(None, TARGET_AXIS), P(None, TARGET_AXIS),
            P(None, TARGET_AXIS), P(None))


def make_sharded_batch_step_keys(mesh: Mesh, *, n_straight: int,
                                 top_k: int = 0):
    """Rank-key twin of make_sharded_batch_step: planes are int32
    [P+1, T] keys (ops/common.pack_target_planes_keys), query args are
    sentinel-encoded positions + per-pixel key intervals, and the
    predicate is exact (flags are structurally zero — kept in the
    output for interface parity with the packed step)."""

    def local_step(t_keys, pos, lo, span):
        def one(args):
            pos_b, lo_b, span_b = args
            scores = pixel_match.score_query_against_key_planes_raw(
                t_keys, pos_b, lo_b, span_b)
            return pixel_match.reduce_variants_device(
                scores, jnp.zeros_like(scores), n_straight)

        best, mirrored, pair_flags = jax.lax.map(one, (pos, lo, span))
        return _finish_batched_step(best, mirrored, pair_flags, top_k)

    step = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(None, TARGET_AXIS), P(None, None, None),
                  P(None, None, None), P(None, None, None)),
        out_specs=_batched_out_specs(top_k),
        check_vma=False)
    return jax.jit(step)


def make_sharded_batch_step_union_keys(mesh: Mesh, *, top_k: int = 0,
                                       u2: int | None = None):
    """x-union lane twin of make_sharded_batch_step_keys: the same
    rank-key planes, but positions come as per-dy-set unions and the dx
    shifts are interval lanes (ops/pixel_match.build_union_key_plan) —
    half the gathered rows per mask.  Flags are structurally zero.
    ``u2`` = static slot-2 segmentation prefix (full-union plans)."""

    def local_step(t_keys, u_pos, mu_pos, lane_lo, lane_span):
        n_straight = u_pos.shape[1] * lane_lo.shape[1]

        def one(args):
            up, mp, lo, sp = args
            scores = pixel_match.score_query_union_keys_raw(
                t_keys, up, mp, lo, sp, u2=u2)
            return pixel_match.reduce_variants_device(
                scores, jnp.zeros_like(scores), n_straight)

        best, mirrored, pair_flags = jax.lax.map(
            one, (u_pos, mu_pos, lane_lo, lane_span))
        return _finish_batched_step(best, mirrored, pair_flags, top_k)

    step = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(None, TARGET_AXIS), P(None, None, None),
                  P(None, None, None), P(None, None, None, None),
                  P(None, None, None, None)),
        out_specs=_batched_out_specs(top_k),
        check_vma=False)
    return jax.jit(step)


def make_sharded_batch_step_union_qkeys(mesh: Mesh, *, top_k: int = 0,
                                        u2: int | None = None):
    """Qkey wire-form twin of make_sharded_batch_step_union_keys: plan
    args are (u_pos, mu_pos, qkeys) plus the replicated shared interval
    tables; per-lane bounds are gathered on device."""

    def local_step(t_keys, u_pos, mu_pos, qidx, key_list, tab_lo,
                   tab_span):
        n_straight = u_pos.shape[1] * qidx.shape[1]

        def one(args):
            up, mp, qi, kl = args
            scores = pixel_match.score_query_union_qkeys_raw(
                t_keys, up, mp, qi, kl, tab_lo, tab_span, u2=u2)
            return pixel_match.reduce_variants_device(
                scores, jnp.zeros_like(scores), n_straight)

        best, mirrored, pair_flags = jax.lax.map(
            one, (u_pos, mu_pos, qidx, key_list))
        return _finish_batched_step(best, mirrored, pair_flags, top_k)

    step = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(None, TARGET_AXIS), P(None, None, None),
                  P(None, None, None), P(None, None, None),
                  P(None, None), P(None, None), P(None, None)),
        out_specs=_batched_out_specs(top_k),
        check_vma=False)
    return jax.jit(step)


def make_sharded_batch_step(mesh: Mesh, *, target_threshold: int,
                            ztol_num: int, ztol_den: int, n_straight: int,
                            top_k: int = 0):
    """Batched variant: scores a stack of B query plans in one step.

    All query arrays gain a leading batch axis (replicated); the result is
    best[B, T] / mirrored[B, T] / flags[B, T] with T sharded.  This is the
    full production step jitted over the mesh — masks stream through in
    batches while the target shards stay resident.

    With `top_k > 0` the step instead returns only the merged per-shard
    top-k candidates per mask — (scores[B, D*k], idx[B, D*k],
    mirrored[B, D*k], flags[B, D*k], global_max[B]) — so the host pull
    is D*k entries instead of the dense T-wide score matrix (the
    collective replacement for the reference's driver-side collect +
    selectTopRanked, ItemsHandling.java:82-111)."""

    def local_step(planes, pos, q_cls, q_s, q_p):
        def one(args):
            pos_b, cls_b, s_b, p_b = args
            scores, flags = pixel_match.score_query_against_planes_raw(
                planes, pos_b, cls_b, s_b, p_b,
                target_threshold=target_threshold,
                ztol_num=ztol_num, ztol_den=ztol_den)
            return pixel_match.reduce_variants_device(
                scores, flags, n_straight)

        best, mirrored, pair_flags = jax.lax.map(
            one, (pos, q_cls, q_s, q_p))
        return _finish_batched_step(best, mirrored, pair_flags, top_k)

    step = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(None, TARGET_AXIS), P(None, None, None),
                  P(None, None), P(None, None), P(None, None)),
        out_specs=_batched_out_specs(top_k),
        check_vma=False)
    return jax.jit(step)

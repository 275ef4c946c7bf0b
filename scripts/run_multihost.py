#!/usr/bin/env python
"""Multi-process launcher for the sharded search.

Start ONE copy of this script per process, one process per GPU.  Under
a cluster launcher JAX detects the coordinator, the process count and
id, and each process's own card (its local rank) itself; by hand, give
--coordinator host:port, --num-processes and --process-id for processes
on one host, and process i claims card i.  A JAX process reserves most
of a card's memory, so a second process on the same card fails.  After
`jax.distributed` starts, `jax.devices()` spans every card of every
process and the colorDepthSearch mesh shards targets across all of
them (parallel/mesh.py): each process feeds its local shard, and the
per-mask maxima and top-k merges are collectives (NCCL) instead of the
reference's driver-side collect (SparkColorMIPSearchProcessor.java:43-81).

Everything after `--` is forwarded to the CLI, e.g.:

  python scripts/run_multihost.py --coordinator localhost:1234 \
      --num-processes 4 --process-id 0 -- colorDepthSearch -m masks.json ...
"""

from __future__ import annotations

import argparse
import sys


def selftest(out_path: str) -> int:
    """Distributed-mesh self-check: score a deterministic synthetic
    workload through the shard_map step over ALL processes' devices and
    verify it equals the single-device kernel, then dump the scores.

    Run by tests/test_multiprocess.py with 2 CPU processes to prove the
    process-spanning path (cross-process collectives) end to end — the
    reference has no distributed tests at all (SURVEY §4)."""
    import json

    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from colormipsearch_tpu.ops import common, pixel_match
    from colormipsearch_tpu.parallel.mesh import (
        create_mesh,
        make_sharded_batch_step,
    )

    rng = np.random.default_rng(0)
    h, w, n_targets, n_masks = 40, 64, 8, 2
    imgs = np.zeros((n_masks + n_targets, h, w, 3), np.uint8)
    for img in imgs:
        n = 400
        img[rng.integers(0, h, n), rng.integers(0, w, n)] = \
            rng.integers(0, 256, (n, 3))
    masks, targets = imgs[:n_masks], imgs[n_masks:]

    plans = [pixel_match.build_query_plan(
        m, 20, mirror=True, xy_shift=2, pix_color_fluctuation=2.0)
        for m in masks]
    pos = np.stack([pl.positions for pl in plans])
    q_cls = np.stack([pl.q_cls for pl in plans])
    q_s = np.stack([pl.q_s for pl in plans])
    q_p = np.stack([pl.q_p for pl in plans])

    host_planes = np.asarray(common.pack_target_planes(jnp.asarray(targets)))

    mesh = create_mesh()
    n_dev = len(mesh.devices.ravel())
    t_pad = ((n_targets + n_dev - 1) // n_dev) * n_dev
    planes_padded = np.pad(host_planes,
                           ((0, 0), (0, t_pad - n_targets)))
    sharding = NamedSharding(mesh, P(None, "targets"))
    # every process holds the full deterministic planes; each contributes
    # its addressable shards to the global array
    planes = jax.make_array_from_callback(
        planes_padded.shape, sharding, lambda idx: planes_padded[idx])

    step = make_sharded_batch_step(
        mesh, target_threshold=20,
        ztol_num=plans[0].ztol_num, ztol_den=plans[0].ztol_den,
        n_straight=plans[0].n_straight)
    best, mirrored, flags, gmax = step(planes, jnp.asarray(pos),
                                       jnp.asarray(q_cls),
                                       jnp.asarray(q_s), jnp.asarray(q_p))
    # assemble the T-sharded global scores on every process host
    best = np.asarray(multihost_utils.process_allgather(best, tiled=True))
    best = best[:, :n_targets]
    gmax = np.asarray(gmax)  # replicated (P()) => fully addressable

    # single-device reference on the local full planes
    ref_best, _, _ = jax.device_put(
        pixel_match.score_query_batch(
            jnp.asarray(host_planes), jnp.asarray(pos),
            jnp.asarray(q_cls), jnp.asarray(q_s), jnp.asarray(q_p),
            target_threshold=20, ztol_num=plans[0].ztol_num,
            ztol_den=plans[0].ztol_den,
            n_straight=plans[0].n_straight),
        jax.local_devices()[0])
    ref_best = np.asarray(ref_best)

    ok = bool((best == ref_best).all())

    # the rank-key interval kernel over the same process-spanning mesh
    # (exact predicate — its cross-process scores must equal the packed
    # kernel's, which this workload leaves un-flagged)
    from colormipsearch_tpu.parallel.mesh import make_sharded_batch_step_keys

    key_planes_host = np.asarray(common.key_planes_from_packed(
        jnp.asarray(np.where((planes_padded & 0xFF) > 20,
                             planes_padded, 0)),
        common.rank_lut_device()))
    kplans = [pixel_match.key_plan_from_query_plan(pl, h * w, 2.0)
              for pl in plans]
    key_planes = jax.make_array_from_callback(
        key_planes_host.shape, sharding, lambda idx: key_planes_host[idx])
    kstep = make_sharded_batch_step_keys(
        mesh, n_straight=plans[0].n_straight)
    kbest, _km, _kf, _kg = kstep(
        key_planes,
        jnp.asarray(np.stack([kp.positions for kp in kplans])),
        jnp.asarray(np.stack([kp.lo for kp in kplans])),
        jnp.asarray(np.stack([kp.span for kp in kplans])))
    kbest = np.asarray(multihost_utils.process_allgather(
        kbest, tiled=True))[:, :n_targets]
    # the packed step applies target_threshold=20 at runtime; the key
    # planes folded it above, so verdicts must agree exactly
    keys_ok = bool((kbest == ref_best).all())

    # the union-lane key kernels (x and full forms) over the same mesh:
    # every production pixel kernel gets a cross-process equality proof
    from colormipsearch_tpu.parallel.mesh import (
        make_sharded_batch_step_union_keys,
    )

    def union_batch(build):
        uplans = [build(m) for m in masks]
        *arrs, u2 = pixel_match.stack_union_plan_args(uplans, h * w)
        return tuple(jnp.asarray(a) for a in arrs), u2

    union_ok = True
    for build in (
            lambda m: pixel_match.build_union_key_plan(
                m, 20, mirror=True, xy_shift=2,
                pix_color_fluctuation=2.0),
            lambda m: pixel_match.build_full_union_key_plan(
                m, 20, mirror=True, xy_shift=2,
                pix_color_fluctuation=2.0)):
        uargs, u2 = union_batch(build)
        ustep = make_sharded_batch_step_union_keys(mesh, u2=u2)
        ubest = ustep(key_planes, *uargs)[0]
        ubest = np.asarray(multihost_utils.process_allgather(
            ubest, tiled=True))[:, :n_targets]
        union_ok = union_ok and bool((ubest == ref_best).all())

    # the split (gap-row / he-row) shape kernel over the same
    # process-spanning mesh vs the single-device jit
    from colormipsearch_tpu.ops import shape_score
    from colormipsearch_tpu.parallel.mesh import (
        make_sharded_shape_split_step,
    )

    s_gap, n_w = 64, 4
    t_gap = rng.integers(0, 1 << 25, (2, s_gap, t_pad)).astype(np.uint32)
    q_gap = rng.integers(0, 1 << 11, (2, s_gap)).astype(np.int32)
    t_he = rng.integers(0, 1 << 32, (2, n_w, t_pad),
                        dtype=np.uint64).astype(np.uint32)
    q_he = rng.integers(0, 1 << 32, (2, n_w),
                        dtype=np.uint64).astype(np.uint32)
    sharding3 = NamedSharding(mesh, P(None, None, "targets"))
    sh = lambda a: jax.make_array_from_callback(  # noqa: E731
        a.shape, sharding3, lambda idx: a[idx])
    sstep = make_sharded_shape_split_step(mesh)
    got = sstep(sh(t_gap), jnp.asarray(q_gap), sh(t_he),
                jnp.asarray(q_he))
    got = [np.asarray(multihost_utils.process_allgather(g, tiled=True))
           for g in got]
    ref = [np.asarray(x) for x in shape_score.shape_score_pairs_split(
        jnp.asarray(t_gap), jnp.asarray(q_gap), jnp.asarray(t_he),
        jnp.asarray(q_he))]
    shape_ok = all((r == g).all() for r, g in zip(ref, got))

    ok = ok and keys_ok and union_ok and shape_ok
    with open(out_path, "w") as f:
        json.dump({"process": jax.process_index(),
                   "num_processes": jax.process_count(),
                   "n_global_devices": len(jax.devices()),
                   "ok": ok, "keys_ok": keys_ok, "union_ok": union_ok,
                   "shape_ok": shape_ok,
                   "scores": best.tolist(),
                   "global_max": np.asarray(gmax).reshape(-1).tolist()}, f)
    print(f"[multihost] selftest ok={ok} (keys_ok={keys_ok}, "
          f"union_ok={union_ok}, shape_ok={shape_ok})", file=sys.stderr)
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--coordinator", default=None,
                   help="coordinator address host:port (process 0's; "
                        "optional under a cluster launcher)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--platform", default=None,
                   help="force a JAX platform (e.g. cpu for the "
                        "multi-process CPU selftest)")
    p.add_argument("--selftest", default=None, metavar="OUT_JSON",
                   help="run the distributed scoring self-check and "
                        "write results to OUT_JSON instead of running "
                        "the CLI")
    p.add_argument("rest", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    kwargs = {}
    if args.coordinator:
        kwargs["coordinator_address"] = args.coordinator
    if args.num_processes is not None:
        kwargs["num_processes"] = args.num_processes
    if args.process_id is not None:
        kwargs["process_id"] = args.process_id
        if args.platform != "cpu":
            # one card per process on one host; a cluster launcher's
            # local rank picks the card when the id is detected
            kwargs["local_device_ids"] = [args.process_id]
    jax.distributed.initialize(**kwargs)
    print(f"[multihost] process {jax.process_index()}/"
          f"{jax.process_count()}: {len(jax.local_devices())} local / "
          f"{len(jax.devices())} global devices", file=sys.stderr)

    if args.selftest:
        return selftest(args.selftest)

    # strip only the leading separator so a literal "--" can still be
    # forwarded to the downstream CLI
    cli_args = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    from colormipsearch_tpu.cli.main import main as cli_main
    return cli_main(cli_args)


if __name__ == "__main__":
    sys.exit(main())

"""Seeded synthetic color depth MIP libraries.

Draws neurite-like paths on a black background, coloured through the
reference's 256-entry depth LUT (``constants.RAINBOW_LUT``) by a depth
that varies smoothly along each path, at the JRC2018_Unisex_20x_HR
shape (566 rows x 1210 columns).  About 6% of a target's pixels are
foreground, like the production LM library.

Masks are sub-paths of some targets — some mirrored, some shifted by
2 px, i.e. by one of the search's own xyShift=2 offsets — so that true
matches exist; ``MaskSpec`` records where each mask came from.  Every
image is a pure function of (seed, index), so a library of any size is
written in parallel and never held in memory whole.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import multiprocessing
import os

import numpy as np

from colormipsearch_tpu.constants import RAINBOW_LUT
from colormipsearch_tpu.io.png import write_png

HEIGHT, WIDTH = 566, 1210  # JRC2018_Unisex_20x_HR color depth MIPs

# paths per target and steps per path: with the 3x3 brush this puts
# ~6% of a full-size image in the foreground
_TARGET_PATHS = 22
_PATH_STEPS = (800, 1600)
_BRUSH = np.array([(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
_SHIFTS = [(dx, dy) for dx in (-2, 0, 2) for dy in (-2, 0, 2)
           if (dx, dy) != (0, 0)]


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """How mask ``index`` was cut from target ``source``: which of the
    target's paths it keeps (and how far along), whether it was
    mirrored left-right, and its (dx, dy) shift."""
    index: int
    source: int
    paths: tuple[int, ...]
    length: float
    mirrored: bool
    shift: tuple[int, int]


def _target_paths(seed: int, t: int, shape) -> list:
    """Target ``t``'s neurites: smooth random walks inside the
    brain-shaped ellipse, each with its depth and brightness varying
    smoothly along it.  Returns [(ys, xs, rgb)] of their centre lines,
    all paths drawn at once."""
    rng = np.random.default_rng([seed, 0, t])
    h, w = shape
    n_p, n_max = _TARGET_PATHS, _PATH_STEPS[1]
    cy, cx, ry, rx = h / 2, w / 2, 0.46 * h, 0.47 * w
    n = rng.integers(*_PATH_STEPS, size=n_p)
    a = 2 * np.pi * rng.uniform(0, 0.7, n_p)
    r = np.sqrt(rng.uniform(0, 1, n_p))
    heading = (rng.uniform(0, 2 * np.pi, n_p)[:, None]
               + np.cumsum(rng.normal(0, 0.12, (n_p, n_max)), axis=1))
    ys = (cy + ry * r * np.sin(a))[:, None] + np.cumsum(np.sin(heading),
                                                        axis=1)
    xs = (cx + rx * r * np.cos(a))[:, None] + np.cumsum(np.cos(heading),
                                                        axis=1)
    depth = np.clip(rng.uniform(0, 255, n_p)[:, None]
                    + np.cumsum(rng.normal(0, 1.5, (n_p, n_max)), axis=1),
                    0, 255).astype(np.int64)
    bright = np.clip(0.8 + np.cumsum(rng.normal(0, 0.01, (n_p, n_max)),
                                     axis=1), 0.45, 1.0)
    rgb = np.rint(RAINBOW_LUT[depth] * bright[..., None]).astype(np.uint8)
    keep = ((((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2 < 1)
            & (np.arange(n_max) < n[:, None]))
    ys = np.rint(ys).astype(np.int64)
    xs = np.rint(xs).astype(np.int64)
    return [(ys[i][keep[i]], xs[i][keep[i]], rgb[i][keep[i]])
            for i in range(n_p)]


def _render(paths, shape) -> np.ndarray:
    """Stamp the 3x3 brush at every path point, in one scatter: a later
    point (and a later path) paints over an earlier one."""
    h, w = shape
    img = np.zeros((h * w, 3), np.uint8)
    ys = np.concatenate([p[0] for p in paths])[:, None] + _BRUSH[:, 0]
    xs = np.concatenate([p[1] for p in paths])[:, None] + _BRUSH[:, 1]
    rgb = np.repeat(np.concatenate([p[2] for p in paths]), len(_BRUSH),
                    axis=0)
    ys, xs = ys.ravel(), xs.ravel()
    ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    img[ys[ok] * w + xs[ok]] = rgb[ok]
    return img.reshape(h, w, 3)


def target_image(seed: int, t: int,
                 shape: tuple[int, int] = (HEIGHT, WIDTH)) -> np.ndarray:
    """uint8 [H, W, 3] color depth MIP of target ``t``."""
    return _render(_target_paths(seed, t, shape), shape)


def mask_spec(seed: int, m: int, n_targets: int) -> MaskSpec:
    """Mask ``m``: a cut of 1-3 paths of a target, every fourth mask
    mirrored and every fourth (offset by two) shifted."""
    rng = np.random.default_rng([seed, 1, m])
    n_paths = int(rng.integers(1, 4))
    paths = tuple(sorted(int(p) for p in rng.choice(
        _TARGET_PATHS, n_paths, replace=False)))
    shift = _SHIFTS[int(rng.integers(len(_SHIFTS)))] if m % 4 == 2 \
        else (0, 0)
    return MaskSpec(index=m, source=int(rng.integers(n_targets)),
                    paths=paths, length=float(rng.uniform(0.4, 1.0)),
                    mirrored=m % 4 == 1, shift=shift)


def mask_image(seed: int, spec: MaskSpec,
               shape: tuple[int, int] = (HEIGHT, WIDTH)) -> np.ndarray:
    """uint8 [H, W, 3] color depth MIP of the mask that ``spec``
    describes."""
    paths = _target_paths(seed, spec.source, shape)
    cut = []
    for p in spec.paths:
        ys, xs, rgb = paths[p]
        n = max(1, int(len(ys) * spec.length))
        cut.append((ys[:n], xs[:n], rgb[:n]))
    img = _render(cut, shape)
    dx, dy = spec.shift
    if dx or dy:
        img = np.roll(img, (dy, dx), axis=(0, 1))
        # drop what wrapped around the edges instead of keeping it
        if dy > 0:
            img[:dy] = 0
        elif dy < 0:
            img[dy:] = 0
        if dx > 0:
            img[:, :dx] = 0
        elif dx < 0:
            img[:, dx:] = 0
    if spec.mirrored:
        img = img[:, ::-1]
    return np.ascontiguousarray(img)


def target_name(t: int) -> str:
    return f"synth_t{t:05d}_CDM"


def mask_name(m: int) -> str:
    return f"synth_m{m:04d}_CDM"


def _write_image(job) -> None:
    path, kind, seed, index, shape = job
    rgb = (target_image(seed, index, shape) if kind == "target"
           else mask_image(seed, index, shape))
    write_png(path, rgb, level=1)


@contextlib.contextmanager
def _children_off_the_card():
    """Worker processes only run numpy; JAX_PLATFORMS=cpu in their
    environment keeps any JAX they import away from the accelerator,
    which belongs to the parent process."""
    old = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        yield
    finally:
        if old is None:
            del os.environ["JAX_PLATFORMS"]
        else:
            os.environ["JAX_PLATFORMS"] = old


def write_library(out_dir: str, *, seed: int, n_masks: int, n_targets: int,
                  shape: tuple[int, int] = (HEIGHT, WIDTH),
                  workers: int | None = None) -> list[MaskSpec]:
    """Write ``masks/`` and ``targets/`` PNG directories under
    ``out_dir``; returns the masks' specs.  Drawing is numpy-bound and
    holds the GIL, so large libraries are drawn in ``workers`` spawned
    processes (default: the core count); small ones in this process."""
    mdir = os.path.join(out_dir, "masks")
    tdir = os.path.join(out_dir, "targets")
    os.makedirs(mdir, exist_ok=True)
    os.makedirs(tdir, exist_ok=True)
    specs = [mask_spec(seed, m, n_targets) for m in range(n_masks)]
    jobs = [(os.path.join(tdir, target_name(t) + ".png"), "target", seed,
             t, shape) for t in range(n_targets)]
    jobs += [(os.path.join(mdir, mask_name(s.index) + ".png"), "mask",
              seed, s, shape) for s in specs]
    workers = workers or os.cpu_count() or 1
    if workers <= 1 or len(jobs) < 64:
        for job in jobs:
            _write_image(job)
        return specs
    with _children_off_the_card(), concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) \
            as pool:
        list(pool.map(_write_image, jobs, chunksize=16))
    return specs

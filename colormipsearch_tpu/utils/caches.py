"""Where the program keeps what it builds at run time.

In a checkout (the package beside ``pyproject.toml``) everything lives
under the checkout's ``.cache/`` (listed in ``.gitignore``), so a run
reads and writes nothing around it:

  * the XLA compilation cache — unless ``JAX_COMPILATION_CACHE_DIR`` is
    set, in which case JAX keeps it there and no other path is set;
  * host artifacts: the native decoder library and the RGB->slice
    table (``COLORMIPSEARCH_TPU_CACHE`` points them elsewhere, e.g. at
    a prebuilt library in a container image).

An installed package has no checkout: without the two variables it
keeps no compilation cache (JAX's default) and no host artifacts (the
decoder falls back to Pillow, the slice table is rebuilt per process).
"""

from __future__ import annotations

import os

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHECKOUT_CACHE = (os.path.join(_ROOT, ".cache")
                  if os.path.exists(os.path.join(_ROOT, "pyproject.toml"))
                  else None)


def artifact_dir() -> str | None:
    """Directory for host artifacts, or None outside a checkout with
    ``COLORMIPSEARCH_TPU_CACHE`` unset."""
    d = os.environ.get("COLORMIPSEARCH_TPU_CACHE") or CHECKOUT_CACHE
    if d is not None:
        os.makedirs(d, exist_ok=True)
    return d


def compilation_cache_dir() -> str | None:
    if "JAX_COMPILATION_CACHE_DIR" in os.environ:
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    return None if CHECKOUT_CACHE is None else os.path.join(CHECKOUT_CACHE,
                                                            "jax")


def enable_compilation_cache() -> str | None:
    """Persist XLA compilations across runs (the first compile of the
    scoring kernels is expensive; later runs reuse it).  Returns the
    cache directory, or None when no persistent cache is kept."""
    import jax

    d = compilation_cache_dir()
    if d is None:
        return None
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return d

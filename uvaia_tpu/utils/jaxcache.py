"""Persistent XLA compilation cache.

First compiles of the 30kb-genome kernels take tens of seconds; caching
executables on disk lets a repeat CLI invocation skip them.  Called by
every engine entry point.

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR``, when it is set: JAX reads it itself and
  no other directory is set here;
* otherwise ``.jax_cache/`` at the checkout root — a fixed path, so a
  later run finds what an earlier one wrote.  An installed package (no
  ``pyproject.toml`` beside it) or a checkout where that directory
  cannot be made runs uncached.

Only GPU executables are cached here; CPU runs stay uncached.
"""

from __future__ import annotations

import os
from pathlib import Path


def _checkout_cache(root: Path) -> Path | None:
    """``root/.jax_cache`` when ``root`` is a source checkout, else None."""
    return root / ".jax_cache" if (root / "pyproject.toml").is_file() else None


CACHE_DIR = _checkout_cache(Path(__file__).resolve().parents[2])

_done = False


def enable() -> None:
    global _done
    if _done:
        return
    _done = True
    import jax
    if jax.default_backend() != "gpu":
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        if CACHE_DIR is None:
            return
        try:
            CACHE_DIR.mkdir(exist_ok=True)
        except OSError:
            return          # read-only checkout: run uncached
        jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    # cache every executable, not only those that took over a second:
    # a GPU run compiles dozens of sub-second step variants
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

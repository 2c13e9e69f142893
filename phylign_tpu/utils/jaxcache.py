"""Persistent XLA compilation cache.

Extension/chain/match jits compile once per shape bucket; the persistent
cache makes that a one-time cost across runs. ``JAX_COMPILATION_CACHE_DIR``
chooses the directory when it is set; otherwise the cache lives in one fixed,
git-ignored directory of the checkout (the path is part of the cache key, so
it must not move between runs). JAX's own ``JAX_ENABLE_COMPILATION_CACHE=false``
turns it off.
"""

from __future__ import annotations

import os
from pathlib import Path

#: the in-checkout default (listed in .gitignore)
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> Path:
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else DEFAULT_DIR


def enable() -> Path | None:
    """Point JAX at the persistent compilation cache; idempotent. Call
    before the first compilation (JAX decides once per process whether the
    cache is used). Returns the directory, or None when it cannot be
    created (a read-only install): the run then compiles without a cache."""
    import jax

    target = cache_dir()
    try:
        target.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    jax.config.update("jax_compilation_cache_dir", str(target))
    # cache everything, including small/fast-compiling programs
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return target

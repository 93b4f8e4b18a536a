"""Persistent XLA compilation cache: compiled executables are serialized
to disk so that every process after the first skips the cold compiles.

The cache lives in `$JAX_COMPILATION_CACHE_DIR` when that is set, and in
`<repo>/.cache/jax_cache` otherwise.  The path is part of each entry's
key, so it must not move between runs: never a temporary or per-run
directory."""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compilation_cache_dir() -> str:
    """The directory the compile cache uses (see the module docstring)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, ".cache", "jax_cache"))


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at
    :func:`compilation_cache_dir` (created if missing) and return it.
    Idempotent — every entry point calls it; the 1 s min-compile-time
    floor keeps trivial programs out of the cache."""
    import jax

    cache_dir = compilation_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir

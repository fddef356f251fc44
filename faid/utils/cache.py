"""Persistent XLA compilation cache (the full-code decoder takes tens of
seconds to minutes to compile; cache hits bring reruns down to seconds).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, the cache lives there and
nowhere else; otherwise at a fixed in-checkout path, because the path is
part of what makes a later run find the entries again."""

from __future__ import annotations

import os
from pathlib import Path

_DEFAULT = Path(__file__).resolve().parent.parent.parent / ".jax_cache"


def cache_dir(default: str | Path = _DEFAULT) -> Path:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``default``."""
    return Path(os.environ.get("JAX_COMPILATION_CACHE_DIR") or default)


def enable_compilation_cache(default: str | Path = _DEFAULT) -> None:
    import jax

    cache = cache_dir(default)
    cache.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(cache))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

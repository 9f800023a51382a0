"""Persistent (on-disk) XLA compilation cache.

The in-process jit cache dies with the interpreter, so every new process
pays the full compile again -- for a NUTS-scale program that is most of a
short fit's wall time. JAX's persistent compilation cache serializes
compiled executables to disk keyed on the optimized HLO + compile options
+ backend version, so a *fresh process* running the same program loads
the executable instead of recompiling.

Where the cache lives: ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads it itself, and nothing here overrides it), else the fixed path
``<checkout>/.jax_cache``. The path is part of what makes a later process
find an entry, so it never depends on a temporary directory, a process
id or the time.

Safety: the cache key includes the HLO, so a code change that alters the
traced program is a miss (never stale). Entries are only ever added --
stale files cost disk, not correctness. Keyed per jaxlib/backend
version, so upgrades invalidate cleanly.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["enable_compilation_cache", "compilation_cache_dir"]

_JAX_ENV = "JAX_COMPILATION_CACHE_DIR"
_KILL_SWITCH = "DYNODE_COMPILATION_CACHE"
#: the checkout (or install prefix) that holds the ``dynode_tpu`` package
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compilation_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``."""
    return os.environ.get(_JAX_ENV) or os.path.join(_CHECKOUT, ".jax_cache")


def enable_compilation_cache(
    path: Optional[str] = None,
    *,
    min_compile_time_secs: float = 1.0,
) -> str:
    """Turn on JAX's persistent compilation cache for this process.

    Programs whose compile takes >= ``min_compile_time_secs`` are written
    to the cache directory; later processes that trace byte-identical HLO
    load the executable from disk instead of recompiling. The directory is
    ``$JAX_COMPILATION_CACHE_DIR`` whenever that is set (``path`` is then
    ignored), else ``path``, else :func:`compilation_cache_dir`. Call once,
    any time before the compile you want cached (idempotent).

    Returns the cache directory in use.

    Notes
    -----
    - ``DYNODE_COMPILATION_CACHE=0`` (or ``off``/``false``) disables the
      call entirely (returns "" without touching jax.config) -- an
      operator kill-switch for read-only filesystems.
    - The default 1s threshold skips toy programs; pass
      ``min_compile_time_secs=0.0`` to cache everything (tests do).
    """
    import jax

    env = os.environ.get(_KILL_SWITCH, "").strip().lower()
    if env in ("0", "off", "false", "no"):
        return ""
    cache_dir = os.environ.get(_JAX_ENV)
    if not cache_dir:
        cache_dir = os.path.expanduser(path) if path else compilation_cache_dir()
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_time_secs
    )
    # cache regardless of entry size (the default floor can skip small
    # executables whose *compile* was expensive)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir

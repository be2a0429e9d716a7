"""Persistent XLA compilation cache at one fixed place.

Compiling the G2 window executable is a large share of a cold run, and the
cache key includes the cache path, so the directory must not move between
runs: ``JAX_COMPILATION_CACHE_DIR`` when the environment sets it (JAX reads
that variable itself, and nothing here overrides it), else ``.jax_cache``
at the root of the checkout — never a temporary name, a process id or a
time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir() -> str:
    """The directory the cache uses: the environment's, else
    ``<checkout>/.jax_cache``."""
    return os.environ.get(ENV_VAR) or os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir`.

    Call before the first compile (JAX decides once per process whether the
    cache is on).  Returns the directory.
    """
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path

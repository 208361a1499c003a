"""JAX's persistent compilation cache, kept at one fixed place.

The device programs are long compiles (the automaton's while_loop at the
serving shape takes tens of seconds), and the cache key includes the
directory, so the directory must not move between runs.  Where
`JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this module
sets nothing.  Otherwise the cache goes to `<checkout>/.jax_cache`, the
directory holding this package, which .gitignore lists.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """`<checkout>/.jax_cache`: next to the `h263_tpu` package."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def cache_dir() -> str:
    """The directory the cache uses: the env var's, else the default."""
    return os.environ.get(ENV_VAR) or default_cache_dir()


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory.  Call before
    the first compile."""
    import jax

    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path

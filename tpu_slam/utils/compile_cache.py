"""Persistent XLA compilation cache.

SLAM missions re-create the same executables every run (the shape ladders
in models/karto/pipeline.py and solver/pose_graph.py keep their number
small), so entry points that time or smoke-test the system call
:func:`enable` before first device use. It is not enabled package-wide:
CPU test runs would trade compile time for cache writes.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no other directory. Otherwise the cache is one fixed directory
in the checkout, ``.jax_cache/`` at its root (git-ignored): the cache key
includes the path, so a directory that moved would never hit.
"""

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else the fixed one."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path

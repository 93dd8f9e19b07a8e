"""Where the persistent XLA compilation cache lives.

One rule for every entry point (``cli``, ``bench.py``, ``chip_smoke.py``):
``$JAX_COMPILATION_CACHE_DIR`` when it is set — JAX reads that variable
itself, so nothing else is set — and otherwise the fixed ``.jax_cache``
directory at the root of the checkout.  A fixed path matters: the path is
part of the cache key, so a directory that moves between runs never hits.
"""

from __future__ import annotations

import os

CHECKOUT_DIR = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir() -> str:
    """The directory the compilation cache uses."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT_DIR, ".jax_cache"))


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path

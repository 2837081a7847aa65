"""JAX persistent compilation cache at one fixed place.

The sampler's block executables and the setup graphs take seconds to
minutes to compile and are identical from run to run, so every entry
point (tests, ``chip_smoke.py``, ``bench.py``, examples, scripts) turns
the persistent cache on through :func:`enable_compile_cache`:

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX already reads it; that directory
  is the cache and no other is set in code.
- unset: ``<checkout>/.jax_cache`` (listed in ``.gitignore``). The path is
  fixed — part of the cache key is where the cache lives, so a directory
  named after a temporary name, a process id or the time never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT_ROOT, ".jax_cache")


def compile_cache_dir() -> str:
    """The cache directory: ``$JAX_COMPILATION_CACHE_DIR`` or the fixed
    in-checkout ``.jax_cache``."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache(min_compile_time_secs: float = 1.0) -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_time_secs
    )
    return path

"""One rule for JAX's persistent compilation cache.

The cache key includes the directory, so a path that moves between runs
(a temporary name, a pid, a time stamp) never hits. The rule:

* ``JAX_COMPILATION_CACHE_DIR`` set in the environment: JAX reads it
  itself, and nothing is set in code.
* otherwise: ``<checkout>/.jax_cache`` (git-ignored), the same directory
  for every process started from this checkout.

CPU test runs use no cache (see ``tests/conftest.py``).
"""

from __future__ import annotations

import os
from pathlib import Path

#: the checkout's root: ida_tpu/utils/compile_cache.py -> <root>
REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"


def enable_compile_cache() -> str:
    """Apply the rule above; return the cache directory in effect."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)

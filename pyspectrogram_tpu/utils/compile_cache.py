"""Where JAX keeps compiled programs between processes.

Every entry point (the ``pstpu`` CLI, the GUI, ``bench.py``,
``chip_smoke.py``, ``examples/demo.py``) calls :func:`enable_compile_cache`
before its first compile. The persistent cache keys on the directory, so it
is a fixed path: ``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads
the variable itself), otherwise ``<checkout>/.jax_cache``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

#: the directory holding the package (the repository checkout)
CHECKOUT = Path(__file__).resolve().parents[2]
DEFAULT_DIR = CHECKOUT / ".jax_cache"


def enable_compile_cache() -> Optional[Path]:
    """Point JAX's persistent compile cache at :data:`DEFAULT_DIR` unless
    ``JAX_COMPILATION_CACHE_DIR`` is set; returns the directory this call
    configured (None when the environment decides)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return DEFAULT_DIR

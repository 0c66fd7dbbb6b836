"""The persistent compile cache (``MXNET_COMPILE_CACHE_DIR``).

Counterpart of ``mxnet_tpu/step/cache.py``. What persists across
processes on this card is the kernels that ``nvcc`` builds from
``csrc/`` (:mod:`mxnet_tpu_torch._build`, one library per source, named
by a digest of the source, the shared headers and the flags): pointing
the cache at a directory lets a restarted worker, a second run or a fleet
sharing the directory load them instead of building them. Hits (a
library found) and misses (``nvcc`` ran) are counted as
``jax_compile_cache_hits_total`` / ``jax_compile_cache_misses_total``.
A captured CUDA graph holds device addresses of one process and cannot be
persisted: each process captures its fused steps anew (README, the
differences kept on purpose).
"""
from __future__ import annotations

import os

from .. import config

__all__ = ["enable_compile_cache", "maybe_enable_compile_cache"]


def enable_compile_cache(directory: str) -> bool:
    """Keep the built kernels in ``directory`` (made if missing) from now
    on. Returns True when the cache was enabled; idempotent."""
    if not directory:
        return False
    os.makedirs(directory, exist_ok=True)
    config.set_flag("MXNET_COMPILE_CACHE_DIR", directory)
    return True


def maybe_enable_compile_cache() -> bool:
    """Enable the cache when ``MXNET_COMPILE_CACHE_DIR`` is set."""
    return enable_compile_cache(config.get("MXNET_COMPILE_CACHE_DIR"))

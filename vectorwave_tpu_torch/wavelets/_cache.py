"""On-disk cache for generated filter coefficient arrays.

Filter generation (spectral factorization at 80 digits) is exact but takes
up to a second per high order; the coefficients are tiny arrays, so they are
memoized under ``config.cache_root()/filters_v1``, keyed by a generator key.
That directory belongs to this package alone: the JAX package keeps its own.
Delete it to force regeneration.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

from ..config import cache_root

_SCHEMA_VERSION = 1


def _cache_dir() -> str:
    path = os.path.join(cache_root(), f"filters_v{_SCHEMA_VERSION}")
    os.makedirs(path, exist_ok=True)
    return path


def cached_filter(key: str, generate: Callable[[], np.ndarray]) -> np.ndarray:
    """Return the cached array for ``key`` or generate-and-store it."""
    path = os.path.join(_cache_dir(), f"{key}.npy")
    try:
        return np.load(path)
    except (OSError, ValueError):
        pass
    arr = np.asarray(generate(), dtype=np.float64)
    # the temporary name must end in .npy, or np.save appends the suffix and
    # the rename below misses the file
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    try:
        np.save(tmp, arr)
        os.replace(tmp, path)
    except OSError:  # cache dir unwritable: still return the result
        pass
    return arr

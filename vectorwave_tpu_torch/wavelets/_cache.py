"""Generated filter coefficient arrays: a shipped table, else the generator.

Filter generation (spectral factorization at 80 digits, an mpmath polish for
the high coiflets) is exact but slow: up to a second for a high Daubechies
order and up to about 30 s for coif17.  So every key that the package's own
filter functions generate (``coif1``-``coif17``, ``db2``-``db38``,
``sym2``-``sym20``, the biorthogonal splines, ``dmey62`` and ``blem1``-``blem5``
at their default lengths) ships in :mod:`._filter_table`, exact float64 kept
as ``float.hex`` strings and written from the generators by
``tools/gen_filter_table.py``.  A key the table lacks (a Battle-Lemarié or
Meyer filter of another length) is generated; the filter functions'
``lru_cache`` keeps it for the process.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def table_filter(key: str) -> np.ndarray | None:
    """The shipped array for ``key``, or None where the table lacks it."""
    from ._filter_table import FILTERS

    hexes = FILTERS.get(key)
    if hexes is None:
        return None
    return np.array([float.fromhex(h) for h in hexes], dtype=np.float64)


def cached_filter(key: str, generate: Callable[[], np.ndarray]) -> np.ndarray:
    """Return the shipped array for ``key``, else ``generate()``'s."""
    arr = table_filter(key)
    return np.asarray(generate(), dtype=np.float64) if arr is None else arr

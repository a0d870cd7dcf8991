#!/usr/bin/env python3
"""Write the port's shipped filter table from its own filter generators.

Run from the root of a checkout (CPU only; about three minutes, most of it
the high coiflets' mpmath polish):

    python3 tools/gen_filter_table.py            # write the table
    python3 tools/gen_filter_table.py --times    # also print each key's seconds

It generates every key that ``vectorwave_tpu_torch.wavelets._cache.cached_filter``
is asked for by the package's filter functions (:func:`filter_calls`), each
through its family's uncached generator (:func:`generators`), and writes them
as exact float64 ``float.hex`` strings to
``vectorwave_tpu_torch/wavelets/_filter_table.py``.  Re-run it after any
change to a generator; ``tests/test_torch_filter_table.py`` holds the table
to the generators bit for bit.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time
from typing import Callable

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
TABLE = ROOT / "vectorwave_tpu_torch" / "wavelets" / "_filter_table.py"

HEADER = '''"""Every generated filter of the port, exact float64 as ``float.hex`` strings.

Written by ``tools/gen_filter_table.py`` from the package's own generators;
do not edit.  ``_cache.cached_filter`` reads it, so no filter of the
registry is generated at run time (``_cache``'s docstring).  The
biorthogonal entries pack ``[len(dec_lo), dec_lo..., rec_lo...]``.
"""

FILTERS = {
'''


def _families():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from vectorwave_tpu_torch.wavelets import biorthogonal as bior
    from vectorwave_tpu_torch.wavelets import coiflets, fourier_families, orthogonal

    return bior, coiflets, fourier_families, orthogonal


def filter_calls() -> dict[str, Callable[[], object]]:
    """Each table key and the package's filter function that asks for it,
    in the registry's order (the functions' own ``lru_cache`` bypassed)."""
    bior, coiflets, fourier, orthogonal = _families()
    calls: dict[str, Callable[[], object]] = {}
    for p in range(2, 39):
        calls[f"db{p}"] = lambda p=p: orthogonal.daubechies_filter.__wrapped__(p)
    for p in range(2, 21):
        calls[f"sym{p}"] = lambda p=p: orthogonal.symlet_filter.__wrapped__(p)
    for order in range(1, coiflets.MAX_ORDER + 1):
        calls[f"coif{order}"] = lambda o=order: coiflets.coiflet_filter.__wrapped__(o)
    for nr, nd in bior.VARIANTS:
        calls[f"bior{nr}.{nd}"] = (
            lambda nr=nr, nd=nd: bior.biorthogonal_filters.__wrapped__(nr, nd))
    calls["dmey62"] = lambda: fourier.dmey_filter.__wrapped__(62)
    for order in range(1, 6):
        calls[f"blem{order}_{4 * (order + 1)}"] = (
            lambda o=order: fourier.battle_lemarie_filter.__wrapped__(o))
    return calls


def generators() -> dict[str, Callable[[], np.ndarray]]:
    """Each table key and the uncached generator that makes its array, in
    :func:`filter_calls`' order."""
    bior, coiflets, fourier, orthogonal = _families()
    made: dict[str, Callable[[], np.ndarray]] = {}
    for p in range(2, 39):
        made[f"db{p}"] = lambda p=p: orthogonal._daubechies_filter_uncached(p)
    for p in range(2, 21):
        made[f"sym{p}"] = lambda p=p: orthogonal._symlet_filter_uncached(p)
    for order in range(1, coiflets.MAX_ORDER + 1):
        made[f"coif{order}"] = lambda o=order: coiflets._coiflet_filter_uncached(o)
    for nr, nd in bior.VARIANTS:
        made[f"bior{nr}.{nd}"] = (
            lambda nr=nr, nd=nd: bior._biorthogonal_packed_uncached(nr, nd))
    made["dmey62"] = lambda: fourier._dmey_filter_uncached(62)
    for order in range(1, 6):
        made[f"blem{order}_{4 * (order + 1)}"] = (
            lambda o=order: fourier._battle_lemarie_filter_uncached(o, 4 * (o + 1)))
    return made


def generate(key: str) -> np.ndarray:
    """``key``'s array as its generator makes it now (the table not read)."""
    return np.asarray(generators()[key](), dtype=np.float64)


def render(arrays: dict[str, np.ndarray]) -> str:
    lines = [HEADER]
    for key, arr in arrays.items():
        lines.append(f"    {key!r}: (\n")
        lines += [f"        {float(v).hex()!r},\n" for v in arr]
        lines.append("    ),\n")
    lines.append("}\n")
    return "".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--times", action="store_true", help="print each key's seconds")
    args = parser.parse_args(argv)
    arrays = {}
    for key in generators():
        t0 = time.perf_counter()
        arrays[key] = generate(key)
        if args.times:
            print(f"{key} {time.perf_counter() - t0:.3f} s", flush=True)
    TABLE.write_text(render(arrays))
    print(f"wrote {len(arrays)} filters to {TABLE.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

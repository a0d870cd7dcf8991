"""The port's shipped filter table (``wavelets/_filter_table.py``) against the
port's own filter generators, bit for bit.

``tools/gen_filter_table.py`` writes the table; ``_cache.cached_filter``
reads it, so no filter of the registry is generated at run time.  Here each
key is generated afresh through its family's uncached generator and its
float64 bits compared with the table's.  Tier 1 takes the keys whose
generation takes under about a second (coif1-5, db2-25, sym2-19, every
biorthogonal spline, dmey, blem1-5); the slow test takes every key (the
coiflets' mpmath polish costs up to 40 s each).  The table's agreement with
the JAX package's independent generation is held by
``tests/test_torch_wavelets.py::test_family_filters_match_jax``.
"""

import os
import re

import numpy as np
import pytest

from tools import gen_filter_table
from vectorwave_tpu_torch.wavelets import _cache
from vectorwave_tpu_torch.wavelets._filter_table import FILTERS

#: the keys whose generation takes over about a second (tools/gen_filter_table.py
#: --times on an 8-core CPU): the high coiflets, Daubechies and symlets
SLOW_KEYS = ({f"coif{n}" for n in range(6, 18)} | {f"db{p}" for p in range(26, 39)}
             | {"sym20"})
CHEAP_KEYS = [k for k in FILTERS if k not in SLOW_KEYS]


def _bits_equal(got: np.ndarray, want: np.ndarray) -> bool:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return got.shape == want.shape and np.array_equal(got.view(np.uint64),
                                                      want.view(np.uint64))


def test_the_table_holds_every_generated_key():
    assert list(FILTERS) == list(gen_filter_table.filter_calls())
    assert list(FILTERS) == list(gen_filter_table.generators())
    assert len(CHEAP_KEYS) == 68 and SLOW_KEYS < set(FILTERS)
    families = {re.match(r"[a-z]+", k).group() for k in FILTERS}
    assert families == {"db", "sym", "coif", "bior", "dmey", "blem"}


@pytest.mark.parametrize("key", CHEAP_KEYS)
def test_table_equals_the_generator_bit_for_bit(key):
    assert _bits_equal(_cache.table_filter(key), gen_filter_table.generate(key))


@pytest.mark.slow
@pytest.mark.parametrize("key", sorted(SLOW_KEYS))
def test_slow_keys_equal_the_generator_bit_for_bit(key):
    assert _bits_equal(_cache.table_filter(key), gen_filter_table.generate(key))


def test_an_empty_cache_generates_nothing(tmp_path, monkeypatch):
    """Every key through its filter function, with an empty cache root and
    every generator made to raise: each comes from the table, coif17 among
    them, and nothing is written under the cache root."""
    from vectorwave_tpu_torch.wavelets import biorthogonal, coiflets, fourier_families
    from vectorwave_tpu_torch.wavelets import orthogonal

    def refuse(*args):
        raise AssertionError(f"a filter was generated {args}")

    for module, name in ((orthogonal, "_daubechies_filter_uncached"),
                         (orthogonal, "_symlet_filter_uncached"),
                         (coiflets, "_coiflet_filter_uncached"),
                         (biorthogonal, "_biorthogonal_packed_uncached"),
                         (fourier_families, "_dmey_filter_uncached"),
                         (fourier_families, "_battle_lemarie_filter_uncached")):
        monkeypatch.setattr(module, name, refuse)
    monkeypatch.setenv("VECTORWAVE_TPU_TORCH_CACHE", str(tmp_path))
    got = {key: call() for key, call in gen_filter_table.filter_calls().items()}
    assert not any(files for _, _, files in os.walk(tmp_path))
    dec, rec = got["bior4.4"]
    packed = _cache.table_filter("bior4.4")
    assert _bits_equal(np.concatenate([[len(dec)], dec, rec]), packed)
    for key in ("coif17", "db38", "sym20", "dmey62", "blem5_24"):
        assert _bits_equal(got[key], _cache.table_filter(key)), key


def test_a_key_outside_the_table_is_generated_and_cached(tmp_path, monkeypatch):
    """A key the table lacks is generated, and the filter function's
    ``lru_cache`` keeps it for the process; nothing goes to disk."""
    from vectorwave_tpu_torch.wavelets import fourier_families

    monkeypatch.setenv("VECTORWAVE_TPU_TORCH_CACHE", str(tmp_path))
    assert _cache.table_filter("blem1_64") is None
    taps = fourier_families.battle_lemarie_filter.__wrapped__(1, 64)
    assert taps.shape == (64,) and abs(taps.sum() - np.sqrt(2.0)) < 1e-12
    assert _bits_equal(taps, fourier_families._battle_lemarie_filter_uncached(1, 64))
    first = fourier_families.battle_lemarie_filter(1, 64)
    assert fourier_families.battle_lemarie_filter(1, 64) is first
    assert not any(files for _, _, files in os.walk(tmp_path))

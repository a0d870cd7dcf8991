"""Wavelet registry: name -> wavelet resolution plus family/compat queries.

Counterpart of ``vectorwave_tpu/wavelets/registry.py``: a plain dict of lazy
factories keyed by lowercase string names (PyWavelets-compatible), with
results memoized.  Every family is registered: haar (alias db1),
db2-db38, sym2-sym20, coif1-coif17, the biorthogonal and reverse
biorthogonal splines, the discrete Meyer and Battle-Lemarie wavelets, and
the continuous wavelets of :mod:`.continuous`.  Further factories register
through :func:`register_wavelet`.
"""

from __future__ import annotations

import functools
from typing import Callable

from ..errors import ErrorCode, InvalidArgumentError
from . import biorthogonal as bior
from . import coiflets, continuous, fourier_families, orthogonal
from .base import ContinuousWavelet, DiscreteWavelet, TransformType, Wavelet, WaveletType

_FACTORIES: dict[str, Callable[[], Wavelet]] = {}
_ALIASES: dict[str, str] = {}


def register_wavelet(name: str, factory: Callable[[], Wavelet]) -> None:
    """Register a wavelet factory under ``name`` (case-insensitive)."""
    _FACTORIES[name.lower()] = factory
    wavelet.cache_clear()


def register_alias(alias: str, target: str) -> None:
    _ALIASES[alias.lower()] = target.lower()


def _register_builtins() -> None:
    _FACTORIES["haar"] = orthogonal.haar
    _ALIASES["db1"] = "haar"
    for order in range(2, 39):
        _FACTORIES[f"db{order}"] = functools.partial(orthogonal.daubechies, order)
    for order in range(2, 21):
        _FACTORIES[f"sym{order}"] = functools.partial(orthogonal.symlet, order)
    for order in range(1, coiflets.MAX_ORDER + 1):
        _FACTORIES[f"coif{order}"] = functools.partial(coiflets.coiflet, order)
    for nr, nd in bior.VARIANTS:
        _FACTORIES[f"bior{nr}.{nd}"] = functools.partial(bior.biorthogonal, nr, nd)
        _FACTORIES[f"rbio{nr}.{nd}"] = functools.partial(
            bior.reverse_biorthogonal, nr, nd
        )
    _FACTORIES["dmey"] = fourier_families.discrete_meyer
    for order in range(1, 6):
        _FACTORIES[f"blem{order}"] = functools.partial(
            fourier_families.battle_lemarie, order
        )
    continuous.register_continuous(_FACTORIES.__setitem__, _ALIASES.__setitem__)


_register_builtins()


@functools.lru_cache(maxsize=None)
def wavelet(name: str) -> Wavelet:
    """Resolve a wavelet by name (case-insensitive)."""
    key = name.lower()
    key = _ALIASES.get(key, key)
    factory = _FACTORIES.get(key)
    if factory is not None:
        return factory()
    close = [n for n in sorted(_FACTORIES) if n[:2] == key[:2]][:8]
    raise InvalidArgumentError(
        ErrorCode.CFG_UNSUPPORTED_WAVELET,
        f"Unknown wavelet: {name!r}",
        context={"requested": name},
        suggestions=(
            f"Known wavelets with similar names: {close}" if close else
            "Call vectorwave_tpu_torch.available_wavelets() for the full list",
        ),
    )


def as_wavelet(spec: str | Wavelet) -> Wavelet:
    """Accept either a wavelet object or a registry name."""
    if isinstance(spec, (DiscreteWavelet, ContinuousWavelet)):
        return spec
    return wavelet(spec)


def available_wavelets() -> list[str]:
    """All registered wavelet names, sorted."""
    return sorted(set(_FACTORIES) | set(_ALIASES))


def wavelets_of_type(wtype: WaveletType) -> list[str]:
    """Names of registered wavelets of the given type."""
    return [n for n in sorted(_FACTORIES) if wavelet(n).wavelet_type is wtype]


#: short registry prefixes accepted as family aliases (PyWavelets-style)
_FAMILY_SHORT = {
    "db": "daubechies",
    "sym": "symlet",
    "coif": "coiflet",
    "bior": "biorthogonalspline",
    "rbio": "reversebiorthogonalspline",
    "blem": "battlelemarie",
    "dmey": "discretemeyer",
}


def wavelets_in_family(family: str) -> list[str]:
    """Names in a family; accepts the full family name ('Daubechies') or the
    short name prefix ('db')."""
    fam = family.lower()
    fam = _FAMILY_SHORT.get(fam, fam)
    return [n for n in sorted(_FACTORIES) if wavelet(n).family.lower() == fam]


def supported_transforms(name: str | Wavelet) -> tuple[TransformType, ...]:
    """Transform-compatibility matrix: a discrete wavelet serves the MODWT
    and the SWT, a continuous one the CWT."""
    if isinstance(as_wavelet(name), DiscreteWavelet):
        return (TransformType.MODWT, TransformType.SWT)
    return (TransformType.CWT,)


def is_compatible(name: str | Wavelet, transform: TransformType) -> bool:
    """Whether a wavelet supports a transform."""
    return transform in supported_transforms(name)


def recommended_transform(name: str | Wavelet) -> TransformType:
    """Best default transform for a wavelet: the MODWT for a discrete one,
    the CWT for a continuous one."""
    if isinstance(as_wavelet(name), DiscreteWavelet):
        return TransformType.MODWT
    return TransformType.CWT

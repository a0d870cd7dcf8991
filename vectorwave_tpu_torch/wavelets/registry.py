"""Wavelet registry: name -> wavelet resolution.

Counterpart of ``vectorwave_tpu/wavelets/registry.py`` for the families
ported so far: haar (alias db1), db2-db38 and sym2-sym20, generated in
:mod:`.orthogonal`.  The JAX package's other registered names (coiflets,
biorthogonal and reverse-biorthogonal splines, discrete Meyer,
Battle-Lemarie and the continuous wavelets) raise
:class:`~vectorwave_tpu_torch.errors.InvalidArgumentError` saying that the
family is not yet ported.
"""

from __future__ import annotations

import functools
import re
from typing import Callable

from ..errors import ErrorCode, InvalidArgumentError
from . import orthogonal
from .base import DiscreteWavelet

_FACTORIES: dict[str, Callable[[], DiscreteWavelet]] = {}
_ALIASES: dict[str, str] = {"db1": "haar"}

_FACTORIES["haar"] = orthogonal.haar
for _order in range(2, 39):
    _FACTORIES[f"db{_order}"] = functools.partial(orthogonal.daubechies, _order)
for _order in range(2, 21):
    _FACTORIES[f"sym{_order}"] = functools.partial(orthogonal.symlet, _order)

#: Registered in the JAX package, not yet ported: the discrete families by
#: pattern, the continuous wavelets by name.
_NOT_YET_PORTED = re.compile(
    r"(coif\d+|bior\d\.\d+|rbio\d\.\d+|dmey|blem\d+"
    r"|cgau\d+|gaus\d+|dog\d*|paul\d*|herm\d+|mexh|mexh_matlab|mexican_hat"
    r"|ricker|gaussian|morl|morlet|cmor|shan|cshan|cshanb|shangabor|fbsp"
    r"|meyr|morse)"
)


@functools.lru_cache(maxsize=None)
def wavelet(name: str) -> DiscreteWavelet:
    """Resolve a wavelet by name (case-insensitive)."""
    key = name.lower()
    key = _ALIASES.get(key, key)
    factory = _FACTORIES.get(key)
    if factory is not None:
        return factory()
    if _NOT_YET_PORTED.fullmatch(key):
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_WAVELET,
            f"Wavelet family of {name!r} is not yet ported to vectorwave_tpu_torch",
            context={"requested": name},
            suggestions=("Ported families: haar, db1-db38, sym2-sym20",),
        )
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


def as_wavelet(spec: str | DiscreteWavelet) -> DiscreteWavelet:
    """Accept either a wavelet object or a registry name."""
    if isinstance(spec, DiscreteWavelet):
        return spec
    return wavelet(spec)


def available_wavelets() -> list[str]:
    """All registered (ported) wavelet names, sorted."""
    return sorted(set(_FACTORIES) | set(_ALIASES))

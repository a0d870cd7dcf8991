"""Global configuration of the PyTorch port.

Counterpart of ``vectorwave_tpu/config.py``: module-level knobs for the
compute backend, the precision tier of the kernel tier and the MAD-sigma
estimator of the fused denoise router; the cache directories; and
:class:`TransformConfig`, a bundle of transform options.

Backends are ``auto`` (the hand-written CUDA kernels on an eligible CUDA
tensor, plain PyTorch otherwise), ``torch`` (always the plain PyTorch path)
and ``kernel`` (force the kernel tier; on a CPU tensor a kernel wrapper
runs its plain version).  The JAX package's names ``jnp`` and ``pallas`` are
accepted as aliases of ``torch`` and ``kernel``.
"""

from __future__ import annotations

import dataclasses
import os

from .errors import ErrorCode, InvalidConfigurationError

_VALID_BACKENDS = ("auto", "torch", "kernel")
_BACKEND_ALIASES = {"jnp": "torch", "pallas": "kernel"}

_backend = "auto"

#: Precision tiers by name, with the error contracts of the JAX package
#: (float32 ~ f32-exact, bf16_3x ~ 1e-5 relative, bf16 ~ 3e-3 relative).  The
#: port's kernels compute every tier in fp32, which meets all three.
_VALID_PRECISIONS = ("float32", "bf16_3x", "bf16")

_fused_precision = "bf16_3x"

#: MAD-sigma estimator of the fused denoise router (denoise/denoiser.py):
#: "auto" decimates the level-1 detail to ~1/64 of its 128-sample rows for
#: large signals, "exact" forces the full-sample median, "decimated" forces
#: the subsample whenever the shape allows.
_VALID_SIGMA = ("auto", "exact", "decimated")

_sigma_estimator = "auto"


def _invalid(kind: str, name: str, valid) -> InvalidConfigurationError:
    return InvalidConfigurationError(
        ErrorCode.CFG_INVALID_CONFIG,
        f"Unknown {kind} {name!r}",
        suggestions=(f"Use one of {valid}",),
    )


def normalize_backend(name: str) -> str:
    """Map a backend name or alias to ``auto``, ``torch`` or ``kernel``."""
    name = _BACKEND_ALIASES.get(name, name)
    if name not in _VALID_BACKENDS:
        raise _invalid("backend", name, _VALID_BACKENDS + tuple(_BACKEND_ALIASES))
    return name


def set_backend(name: str) -> None:
    """Select the compute backend: ``auto``, ``torch`` or ``kernel``
    (``jnp``/``pallas`` are aliases)."""
    global _backend
    _backend = normalize_backend(name)


def get_backend() -> str:
    return _backend


def set_fused_precision(name: str) -> None:
    """Select the kernel-tier precision: float32 / bf16_3x / bf16."""
    if name not in _VALID_PRECISIONS:
        raise _invalid("fused precision", name, _VALID_PRECISIONS)
    global _fused_precision
    _fused_precision = name


def get_fused_precision() -> str:
    return _fused_precision


def set_sigma_estimator(name: str) -> None:
    """Select the fused-denoise MAD-sigma estimator: auto/exact/decimated."""
    if name not in _VALID_SIGMA:
        raise _invalid("sigma estimator", name, _VALID_SIGMA)
    global _sigma_estimator
    _sigma_estimator = name


def get_sigma_estimator() -> str:
    return _sigma_estimator


def cache_root() -> str:
    """Root directory of the port's on-disk caches (generated filters):
    ``$VECTORWAVE_TPU_TORCH_CACHE`` or ``~/.cache/vectorwave_tpu_torch``.

    It is not the JAX package's cache, so a parity test of the two packages'
    filters compares two independent generations."""
    return os.environ.get(
        "VECTORWAVE_TPU_TORCH_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "vectorwave_tpu_torch"),
    )


def enable_compilation_cache(path: str | None = None) -> str:
    """Keep the kernels' builds in a persistent directory.

    The port's counterpart of the JAX package's XLA compilation cache: the
    CUDA kernel library (``kernels/_build.py``) and the native ring
    (``native/``) are built at first use; this points both builds at
    ``path``, or at ``<cache_root()>/cuda``, so that later processes load
    them instead of compiling.  It applies to builds not yet loaded in this
    process.  Without the call they build into the package's own ``_build``
    directories.  Returns the directory used.
    """
    import pathlib

    from . import native
    from .kernels import _build

    target = pathlib.Path(path if path is not None else os.path.join(cache_root(), "cuda"))
    target.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = target
    native.BUILD_DIR = target
    return str(target)


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    """Bundle of transform options.

    ``boundary``: periodic / zero / symmetric.
    ``backend``: auto / torch / kernel (``jnp`` and ``pallas`` are taken as
    their aliases and stored as ``torch`` and ``kernel``).
    ``max_decomposition_levels``: safety cap (the multi-level transform
    itself caps at 10).
    """

    boundary: str = "periodic"
    backend: str = "auto"
    max_decomposition_levels: int = 20

    def __post_init__(self) -> None:
        object.__setattr__(self, "backend", normalize_backend(self.backend))

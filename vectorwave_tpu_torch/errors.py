"""Structured error hierarchy for vectorwave_tpu_torch.

The same codes and exception classes as ``vectorwave_tpu/errors.py``, so
code that catches one package's errors reads the other's the same way.
"""

from __future__ import annotations

import enum
from typing import Any


class ErrorCode(enum.Enum):
    """Stable error codes (mirrors the reference's VAL_/CFG_/STATE_/POOL_ scheme)."""

    # Validation
    VAL_NULL_ARGUMENT = "VAL_001"
    VAL_EMPTY_SIGNAL = "VAL_002"
    VAL_NON_FINITE_VALUES = "VAL_003"
    VAL_TOO_SHORT = "VAL_004"
    VAL_TOO_LARGE = "VAL_005"
    VAL_INVALID_LEVEL = "VAL_006"
    VAL_INVALID_SHAPE = "VAL_007"
    # Configuration
    CFG_UNSUPPORTED_WAVELET = "CFG_001"
    CFG_UNSUPPORTED_BOUNDARY = "CFG_002"
    CFG_INVALID_CONFIG = "CFG_003"
    CFG_UNSUPPORTED_TRANSFORM = "CFG_004"
    # State
    STATE_INVALID = "STATE_001"
    STATE_CLOSED = "STATE_002"
    # Sharding / distributed
    DIST_BAD_MESH = "DIST_001"
    DIST_TILE_TOO_SMALL = "DIST_002"


class VectorWaveError(ValueError):
    """Base error: carries an :class:`ErrorCode`, context and suggestions."""

    def __init__(
        self,
        code: ErrorCode,
        message: str,
        *,
        context: dict[str, Any] | None = None,
        suggestions: tuple[str, ...] = (),
    ) -> None:
        self.code = code
        self.context = dict(context or {})
        self.suggestions = tuple(suggestions)
        parts = [f"[{code.value}] {message}"]
        for key, value in self.context.items():
            parts.append(f"  {key}: {value}")
        for s in self.suggestions:
            parts.append(f"  Suggestion: {s}")
        super().__init__("\n".join(parts))


class InvalidArgumentError(VectorWaveError):
    """Invalid argument (reference: InvalidArgumentException)."""


class InvalidSignalError(VectorWaveError):
    """Invalid signal data (reference: InvalidSignalException)."""


class InvalidConfigurationError(VectorWaveError):
    """Invalid configuration (reference: InvalidConfigurationException)."""


class InvalidStateError(VectorWaveError):
    """Invalid object state (reference: InvalidStateException)."""

"""Q-shift filters for the dual-tree complex wavelet transform.

Counterpart of ``vectorwave_tpu/wavelets/qshift.py``, with the same angles to
the digit.  GENERATED, not tabulated: the committed ``QSHIFT_THETAS_14``
lattice angles were produced by ``tools/design_qshift.py`` (seeded and
reproducible — see its docstring for the method).  The filters themselves are rebuilt here
from those angles through the exact paraunitary lattice, so orthonormality
and perfect reconstruction hold to machine precision BY CONSTRUCTION —
the optimization only shaped the phase (passband group delay
``(L-1)/2 - 1/4``, the q-shift property) and the stopband.

Tree b of the DTCWT uses the time-reversed filters (group delay
``(L-1)/2 + 1/4``); the half-sample relative delay per stage makes the two
trees' wavelets an approximate Hilbert pair (Kingsbury 2001, Selesnick
2001 — method references, no coefficients taken from either).
"""

from __future__ import annotations

import numpy as np

__all__ = ["QSHIFT_THETAS_14", "lattice_filters", "qshift_filters"]


def lattice_filters(thetas: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact-orthonormal (lowpass, highpass) pair of length ``2K`` from
    ``K`` paraunitary-lattice rotations (float64 numpy; host-side)."""
    thetas = np.asarray(thetas, dtype=np.float64)
    K = thetas.shape[0]
    E = np.zeros((2, 2, K))
    c0, s0 = np.cos(thetas[0]), np.sin(thetas[0])
    E[:, :, 0] = [[c0, -s0], [s0, c0]]
    for i in range(1, K):
        delayed = np.zeros_like(E)
        delayed[0] = E[0]
        delayed[1, :, 1:] = E[1, :, :-1]
        c, s = np.cos(thetas[i]), np.sin(thetas[i])
        E = np.einsum("ab,bcn->acn", [[c, -s], [s, c]], delayed)
    h = np.zeros(2 * K)
    g = np.zeros(2 * K)
    h[0::2], h[1::2] = E[1, 0], E[1, 1]
    g[0::2], g[1::2] = E[0, 0], E[0, 1]
    return h, g


#: 14-tap q-shift design (tools/design_qshift.py, seed 0) — the K-1 FREE
#: lattice angles; the last is pi/4 - sum(free) so the lowpass has one
#: EXACT vanishing moment.  Achieved analyticity (negative-frequency energy
#: of psi_a - i psi_b): 10.1% at level 2, 2.4% at 3, 0.36% at 4, 0.05% at
#: 5; single-level reconstruction shift deviation 6.5% amplitude at level
#: 2, ~20% (4% energy) at levels 3-4 vs ~100% for the decimated DWT.
QSHIFT_THETAS_14: tuple[float, ...] = (
    0.349511967525913,
    -0.595747430067475,
    1.498756008071761,
    0.933008320203218,
    -1.069644516534759,
    1.038897182283517,
)


def qshift_filters(taps: int = 14) -> tuple[np.ndarray, np.ndarray]:
    """The tree-a q-shift (lowpass, highpass) pair; tree b is the reverse."""
    if taps != 14:
        raise ValueError(
            f"Only the 14-tap q-shift design is committed (got {taps}); "
            "run tools/design_qshift.py for other lengths"
        )
    if not QSHIFT_THETAS_14:
        raise RuntimeError("q-shift angles missing — run tools/design_qshift.py")
    thetas = np.asarray(QSHIFT_THETAS_14)
    angles = np.concatenate([thetas, [np.pi / 4 - thetas.sum()]])
    return lattice_filters(angles)

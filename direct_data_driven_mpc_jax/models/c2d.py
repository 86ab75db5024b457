"""Continuous-time to discrete-time plant conversion (ZOH).

The reference accepts only pre-discretized state-space matrices (the
four-tank YAML ships the linearized, already-sampled model). Real plant
models usually start continuous-time; this utility performs exact
zero-order-hold discretization so users can define plants as
``dx/dt = A_c x + B_c u`` and sample them at ``Ts``:

    [Ad  Bd]            [A_c  B_c]
    [ 0   I]  =  expm ( [ 0    0 ] * Ts )

``C``/``D`` are sampling-invariant under ZOH.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from direct_data_driven_mpc_jax.models.lti_model import LTIModel


def _expm(M: np.ndarray) -> np.ndarray:
    """Matrix exponential: scipy when available, otherwise a
    scaling-and-squaring Taylor fallback (float64)."""
    try:
        from scipy.linalg import expm as scipy_expm

        return scipy_expm(M)
    except ImportError:  # pragma: no cover
        norm = np.linalg.norm(M, 1)
        squarings = max(0, int(np.ceil(np.log2(max(norm, 1e-16)))) + 4)
        A = M / (2.0 ** squarings)
        out = np.eye(M.shape[0])
        term = np.eye(M.shape[0])
        for k in range(1, 20):
            term = term @ A / k
            out = out + term
        for _ in range(squarings):
            out = out @ out
        return out


def c2d_zoh(
    A_c: np.ndarray, B_c: np.ndarray, Ts: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact ZOH discretization of ``(A_c, B_c)`` at sample time ``Ts``.

    Returns ``(Ad, Bd)`` with ``x[k+1] = Ad x[k] + Bd u[k]`` for
    piecewise-constant inputs.
    """
    A_c = np.asarray(A_c, dtype=np.float64)
    B_c = np.asarray(B_c, dtype=np.float64)
    ns = A_c.shape[0]
    m = B_c.shape[1]
    if Ts <= 0:
        raise ValueError("Sample time Ts must be positive.")
    aug = np.zeros((ns + m, ns + m))
    aug[:ns, :ns] = A_c
    aug[:ns, ns:] = B_c
    E = _expm(aug * Ts)
    return E[:ns, :ns], E[:ns, ns:]


def discretize_plant(
    A_c: np.ndarray,
    B_c: np.ndarray,
    C: np.ndarray,
    D: Optional[np.ndarray] = None,
    Ts: float = 1.0,
    eps_max: float = 0.0,
) -> LTIModel:
    """Build a discrete-time :class:`LTIModel` from a continuous-time
    state-space model sampled with zero-order hold at ``Ts``."""
    Ad, Bd = c2d_zoh(A_c, B_c, Ts)
    C = np.asarray(C, dtype=np.float64)
    if D is None:
        D = np.zeros((C.shape[0], Bd.shape[1]))
    return LTIModel(A=Ad, B=Bd, C=C, D=D, eps_max=eps_max)

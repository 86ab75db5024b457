"""Random stable LTI plant generation (BASELINE config 5: the
10-input/10-output Monte-Carlo scaling benchmark).

The reference only ships the four-tank plant; large-scale scenario
sweeps need families of plants. Generation is host-side float64 and
seeded -- a given (seed, dims) pair always yields the same plant.
"""

from __future__ import annotations

import numpy as np

from direct_data_driven_mpc_jax.models.lti_model import LTIModel


def random_stable_lti(
    seed: int,
    ns: int,
    m: int,
    p: int,
    spectral_radius: float = 0.9,
    eps_max: float = 0.002,
    min_dc_gain_sv: float = 0.1,
) -> LTIModel:
    """Draw a random discrete-time LTI plant with guaranteed stability
    and a well-conditioned DC gain.

    ``A`` is a random matrix rescaled to the requested spectral radius;
    ``B``/``C`` are Gaussian with ``1/sqrt(ns)`` scaling; ``D = 0``.
    The DC gain ``C (I - A)^-1 B`` is re-scaled so its smallest singular
    value is at least ``min_dc_gain_sv`` (guarantees meaningful
    equilibrium-input computation and keeps the closed loop from
    demanding huge inputs).
    """
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(ns, ns)) / np.sqrt(ns)
    radius = max(abs(np.linalg.eigvals(A)))
    A = A * (spectral_radius / radius)
    B = rng.normal(size=(ns, m)) / np.sqrt(ns)
    C = rng.normal(size=(p, ns)) / np.sqrt(ns)
    D = np.zeros((p, m))

    M = C @ np.linalg.solve(np.eye(ns) - A, B)
    sv_min = np.linalg.svd(M, compute_uv=False).min()
    if sv_min < min_dc_gain_sv:
        B = B * (min_dc_gain_sv / sv_min)

    return LTIModel(A=A, B=B, C=C, D=D, eps_max=eps_max)

"""The four-tank plant of the paper's Section V (Berberich et al.,
IEEE TAC 2021), the system every bench configuration and smoke phase
drives. Matrices as in the reference's
``examples/config/models/four_tank_system_params.yaml``."""

from __future__ import annotations

import numpy as np

from direct_data_driven_mpc_jax.models.lti_model import LTIModel

FOUR_TANK_A = ((0.921, 0.0, 0.041, 0.0),
               (0.0, 0.918, 0.0, 0.033),
               (0.0, 0.0, 0.924, 0.0),
               (0.0, 0.0, 0.0, 0.937))
FOUR_TANK_B = ((0.017, 0.001), (0.001, 0.023), (0.0, 0.061), (0.072, 0.0))
FOUR_TANK_C = ((1.0, 0.0, 0.0, 0.0), (0.0, 1.0, 0.0, 0.0))
FOUR_TANK_EPS_MAX = 0.002


def four_tank_plant(eps_max: float = FOUR_TANK_EPS_MAX) -> LTIModel:
    """A fresh four-tank :class:`LTIModel` (zero initial state, output
    noise bound ``eps_max``)."""
    return LTIModel(
        A=np.array(FOUR_TANK_A), B=np.array(FOUR_TANK_B),
        C=np.array(FOUR_TANK_C), D=np.zeros((2, 2)), eps_max=eps_max,
    )

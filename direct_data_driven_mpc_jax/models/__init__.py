"""Plant models: functional LTI core + stateful convenience classes."""

from direct_data_driven_mpc_jax.models.four_tank import four_tank_plant
from direct_data_driven_mpc_jax.models.lti_model import (
    LTIModel,
    LTISystemModel,
)
from direct_data_driven_mpc_jax.ops.lti import LTIParams

__all__ = ["LTIModel", "LTISystemModel", "LTIParams", "four_tank_plant"]

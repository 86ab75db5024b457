"""Config loading, parameter derivation, RNG, and export utilities."""

from direct_data_driven_mpc_jax.utils.config import (
    load_yaml_config_params,
    get_data_driven_mpc_controller_params,
)
from direct_data_driven_mpc_jax.utils.export import export_controller

__all__ = [
    "load_yaml_config_params",
    "get_data_driven_mpc_controller_params",
    "export_controller",
]

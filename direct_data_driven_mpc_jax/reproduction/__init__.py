"""Paper Section V reproduction: multi-scheme simulation + plotting."""

from direct_data_driven_mpc_jax.reproduction.paper import (
    DataDrivenMPCScheme,
    DD_MPC_SCHEME_CONFIG,
    DD_MPC_SCHEME_LINE_PARAMS,
    get_equilibrium_state_from_output,
    create_data_driven_mpc_controllers_reproduction,
    simulate_data_driven_mpc_control_loops_reproduction,
    plot_input_output_reproduction,
)

__all__ = [
    "DataDrivenMPCScheme",
    "DD_MPC_SCHEME_CONFIG",
    "DD_MPC_SCHEME_LINE_PARAMS",
    "get_equilibrium_state_from_output",
    "create_data_driven_mpc_controllers_reproduction",
    "simulate_data_driven_mpc_control_loops_reproduction",
    "plot_input_output_reproduction",
]

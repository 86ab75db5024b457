"""Core math kernels: pure, shape-static, vmappable JAX functions."""

from direct_data_driven_mpc_jax.ops.hankel import (
    hankel_matrix,
    evaluate_persistent_excitation,
)
from direct_data_driven_mpc_jax.ops.lti import (
    lti_step,
    lti_rollout,
)
from direct_data_driven_mpc_jax.ops.estimation import (
    observability_matrix,
    toeplitz_input_output_matrix,
    estimate_initial_state,
    calculate_equilibrium_output_from_input,
    calculate_equilibrium_input_from_output,
)

__all__ = [
    "hankel_matrix",
    "evaluate_persistent_excitation",
    "lti_step",
    "lti_rollout",
    "observability_matrix",
    "toeplitz_input_output_matrix",
    "estimate_initial_state",
    "calculate_equilibrium_output_from_input",
    "calculate_equilibrium_input_from_output",
]

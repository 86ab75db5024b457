"""Host-side visualization: static + animated input-output plots."""

from direct_data_driven_mpc_jax.viz.plots import (
    plot_input_output,
    plot_input_output_animation,
    save_animation,
    create_input_output_figure,
    get_padded_limits,
)
from direct_data_driven_mpc_jax.viz.styles import (
    INPUT_OUTPUT_PLOT_PARAMS,
    INPUT_OUTPUT_PLOT_PARAMS_SMALL,
    SETPOINT_LINE_PARAMS,
    LEGEND_PARAMS,
)

__all__ = [
    "plot_input_output",
    "plot_input_output_animation",
    "save_animation",
    "create_input_output_figure",
    "get_padded_limits",
    "INPUT_OUTPUT_PLOT_PARAMS",
    "INPUT_OUTPUT_PLOT_PARAMS_SMALL",
    "SETPOINT_LINE_PARAMS",
    "LEGEND_PARAMS",
]

"""Robust data-driven MPC paper reproduction CLI (paper Fig. 2).

CLI parity with the reference's
``examples/robust_data_driven_mpc_reproduction.py`` (:89-322): the
three Robust schemes (TEC, TEC n-step, UCON) on the four-tank system
with the initial output forced to ``y_0 = [0.4, 0.4]``, overlaid in one
figure matching the paper's Fig. 2 axis limits.

Note (as in the reference, :21-28): the UCON closed loop is unstable by
design -- a default seed is provided to match the paper; other seeds
may diverge.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from direct_data_driven_mpc_jax.control.operation import (
    generate_initial_input_output_data,
    randomize_initial_system_state,
    simulate_n_input_output_measurements,
)
from direct_data_driven_mpc_jax.models.lti_model import LTISystemModel
from direct_data_driven_mpc_jax.reproduction.paper import (
    DataDrivenMPCScheme,
    create_data_driven_mpc_controllers_reproduction,
    get_equilibrium_state_from_output,
    plot_input_output_reproduction,
    simulate_data_driven_mpc_control_loops_reproduction,
)
from direct_data_driven_mpc_jax.utils.config import (
    get_data_driven_mpc_controller_params,
)

EXAMPLES_DIR = os.path.dirname(os.path.abspath(__file__))
MODEL_CONFIG = os.path.join(
    EXAMPLES_DIR, "config", "models", "four_tank_system_params.yaml"
)
CONTROLLER_CONFIG = os.path.join(
    EXAMPLES_DIR,
    "config",
    "controllers",
    "data_driven_mpc_example_params.yaml",
)

Y_0 = [0.4, 0.4]  # initial system output for reproduction
U_YLIMITS = [(-15.0, 15.0), (-15.0, 15.0)]
Y_YLIMITS = [(0.4, 1.0), (0.4, 1.0)]
SCHEMES = [
    DataDrivenMPCScheme.TEC,
    DataDrivenMPCScheme.TEC_N_STEP,
    DataDrivenMPCScheme.UCON,
]


def parse_args() -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Data-Driven MPC Controller Reproduction"
    )
    parser.add_argument(
        "--t_sim", type=int, default=600,
        help="Simulation length in time steps.",
    )
    parser.add_argument(
        "--seed", type=int, default=4,
        help="RNG seed (default 4 closely matches the paper figure).",
    )
    parser.add_argument(
        "--no_plot", action="store_true", default=False,
        help="Skip the figure (headless runs).",
    )
    parser.add_argument(
        "--save_fig", type=str, default=None,
        help="Save the reproduction figure to this path instead of "
        "showing it.",
    )
    parser.add_argument(
        "--verbose", type=int, default=2, choices=[0, 1, 2],
        help="0 = silent, 1 = minimal, 2 = detailed.",
    )
    return parser.parse_args()


def main() -> None:
    args = parse_args()
    verbose = args.verbose

    # 1. Plant + controller parameters (same steps as the example CLI).
    if verbose:
        print("Loading system parameters from configuration file")
    system_model = LTISystemModel(
        config_file=MODEL_CONFIG,
        model_key_value="FourTankSystem",
        verbose=verbose,
    )
    m = system_model.get_number_inputs()
    p = system_model.get_number_outputs()
    dd_mpc_config = get_data_driven_mpc_controller_params(
        config_file=CONTROLLER_CONFIG,
        controller_key_value="data_driven_mpc_params",
        m=m,
        p=p,
        verbose=verbose,
    )

    np_random = np.random.default_rng(seed=args.seed)
    if verbose:
        print(f"Random number generator initialized with seed: {args.seed}")

    # 2. Random initial state + excitation-phase data.
    if verbose:
        print("Randomizing initial system state")
    x_0 = randomize_initial_system_state(
        system_model=system_model,
        controller_config=dd_mpc_config,
        np_random=np_random,
    )
    system_model.set_state(state=x_0)

    if verbose:
        print("Generating initial input-output data")
    u_d, y_d = generate_initial_input_output_data(
        system_model=system_model,
        controller_config=dd_mpc_config,
        np_random=np_random,
    )

    # 3. One controller per scheme.
    if verbose:
        print("Initializing Data-Driven MPC controllers per scheme")
    controllers = create_data_driven_mpc_controllers_reproduction(
        controller_config=dd_mpc_config,
        u_d=u_d,
        y_d=y_d,
        data_driven_mpc_controller_schemes=SCHEMES,
    )

    # 4. Force the paper's initial output y_0 = [0.4, 0.4]: compute the
    # equilibrium state for y_0, set it, warm the plant for n steps at
    # the input setpoint, and re-seed each controller's past window.
    if verbose:
        print(f"Setting initial system output to {Y_0}")
    x_rep0 = get_equilibrium_state_from_output(
        system_model=system_model, y_eq=np.array(Y_0).reshape(-1, 1)
    )
    system_model.set_state(state=x_rep0)

    U_n, Y_n = simulate_n_input_output_measurements(
        system_model=system_model,
        controller_config=dd_mpc_config,
        np_random=np_random,
    )
    for controller in controllers:
        controller.set_past_input_output_data(
            u_past=U_n.reshape(-1, 1), y_past=Y_n.reshape(-1, 1)
        )

    # 5. Simulate each scheme from the same state.
    n = dd_mpc_config["n"]
    n_steps = args.t_sim + 1 - n
    if verbose:
        print("Simulating Data-Driven MPC control loops")
    u_sys_data, y_sys_data = (
        simulate_data_driven_mpc_control_loops_reproduction(
            system_model=system_model,
            data_driven_mpc_controllers=controllers,
            n_steps=n_steps,
            np_random=np_random,
            verbose=verbose,
        )
    )

    # 6. Prepend the warmup window so trajectories start at y_0.
    u_data = [np.vstack([U_n, u]) for u in u_sys_data]
    y_data = [np.vstack([Y_n, y]) for y in y_sys_data]

    if verbose:
        for scheme, y in zip(SCHEMES, y_data):
            err = np.abs(
                y[-1] - dd_mpc_config["y_s"].flatten()
            ).max()
            print(f"    {scheme.name}: final output error {err:.5f}")

    if args.no_plot and not args.save_fig:
        return

    if verbose:
        print("Displaying reproduction figure")
    fig = plot_input_output_reproduction(
        data_driven_mpc_controller_schemes=SCHEMES,
        u_data=u_data,
        y_data=y_data,
        u_s=dd_mpc_config["u_s"],
        y_s=dd_mpc_config["y_s"],
        u_ylimits=U_YLIMITS,
        y_ylimits=Y_YLIMITS,
        title="Robust Data-Driven MPC Schemes",
        show=args.save_fig is None,
    )
    if args.save_fig:
        fig.savefig(args.save_fig, dpi=150)
        if verbose:
            print(f"Figure saved to {args.save_fig}")


if __name__ == "__main__":
    from direct_data_driven_mpc_jax.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    main()

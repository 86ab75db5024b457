"""Direct data-driven MPC example CLI (four-tank system).

CLI parity with the reference's
``examples/direct_data_driven_mpc_example.py`` (args at :90-167,
pipeline at :169-425): load plant + controller YAML configs, randomize
the initial state, generate persistently-exciting data, build the
controller, run the closed loop, then plot/animate.

Additional flags beyond the reference:
  --engine {host,fused}   host = stateful step-by-step loop (reference
                          Algorithm 1/2 semantics); fused = the jitted
                          on-device scan engine (identical trajectories,
                          orders of magnitude faster).
  --no_plot               skip figures (headless benchmarking).
"""

import argparse
import math
import os
import sys

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from direct_data_driven_mpc_jax.control.creation import (
    create_data_driven_mpc_controller,
)
from direct_data_driven_mpc_jax.control.operation import (
    generate_initial_input_output_data,
    randomize_initial_system_state,
    simulate_data_driven_mpc_control_loop,
)
from direct_data_driven_mpc_jax.models.lti_model import LTISystemModel
from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)
from direct_data_driven_mpc_jax.utils.config import (
    get_data_driven_mpc_controller_params,
)

EXAMPLES_DIR = os.path.dirname(os.path.abspath(__file__))
DEFAULT_MODEL_CONFIG = os.path.join(
    EXAMPLES_DIR, "config", "models", "four_tank_system_params.yaml"
)
DEFAULT_CONTROLLER_CONFIG = os.path.join(
    EXAMPLES_DIR,
    "config",
    "controllers",
    "data_driven_mpc_example_params.yaml",
)
DEFAULT_ANIM_PATH = os.path.join(
    os.path.dirname(EXAMPLES_DIR),
    "animation_outputs",
    "data-driven_mpc_sim.gif",
)

CONTROLLER_TYPE_MAP = {
    "Nominal": DataDrivenMPCType.NOMINAL,
    "Robust": DataDrivenMPCType.ROBUST,
}
SLACK_TYPE_MAP = {
    "NonConvex": SlackVarConstraintTypes.NON_CONVEX,
    "Convex": SlackVarConstraintTypes.CONVEX,
    "None": SlackVarConstraintTypes.NONE,
}


def parse_args() -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Direct Data-Driven MPC Controller Example"
    )
    parser.add_argument(
        "--model_config_path", type=str, default=DEFAULT_MODEL_CONFIG,
        help="Path to the YAML file with the plant model parameters.",
    )
    parser.add_argument(
        "--model_key_value", type=str, default="FourTankSystem",
        help="Key of the model parameters in the config file.",
    )
    parser.add_argument(
        "--controller_config_path", type=str,
        default=DEFAULT_CONTROLLER_CONFIG,
        help="Path to the YAML file with the controller parameters.",
    )
    parser.add_argument(
        "--controller_key_value", type=str,
        default="data_driven_mpc_params",
        help="Key of the controller parameters in the config file.",
    )
    parser.add_argument(
        "--n_mpc_step", type=int, default=None,
        help="Consecutive optimal-input applications per solve "
        "(n-step scheme).",
    )
    parser.add_argument(
        "--controller_type", type=str, default=None,
        choices=["Nominal", "Robust"],
        help="Data-driven MPC controller type override.",
    )
    parser.add_argument(
        "--slack_var_const_type", type=str, default=None,
        choices=["None", "Convex", "NonConvex"],
        help="Slack variable constraint type override (Robust only).",
    )
    parser.add_argument(
        "--allow_nonconvex_slack", action="store_true", default=False,
        help="Actually SOLVE the NonConvex slack variant (paper Eq. 6d,"
        " convex-concave fixed point) instead of raising like the "
        "reference implementation.",
    )
    parser.add_argument(
        "--t_sim", type=int, default=400,
        help="Simulation length in time steps.",
    )
    parser.add_argument(
        "--seed", type=int, default=None,
        help="RNG seed for reproducible results.",
    )
    parser.add_argument(
        "--engine", type=str, default="host",
        choices=["host", "fused", "linear"],
        help="Closed-loop execution engine: host = stateful step loop; "
        "fused = jitted on-device scan; linear = condensed affine "
        "engine (slack-NONE controllers only).",
    )
    parser.add_argument(
        "--u_min", type=float, default=None,
        help="Lower actuator bound on every predicted input (requires "
        "--engine fused; beyond-reference capability via the box-ADMM "
        "solver, qp/box.py).",
    )
    parser.add_argument(
        "--u_max", type=float, default=None,
        help="Upper actuator bound on every predicted input (requires "
        "--engine fused).",
    )
    parser.add_argument(
        "--save_anim", action="store_true", default=False,
        help="Save the animation via ffmpeg to --anim_path.",
    )
    parser.add_argument(
        "--anim_path", type=str, default=DEFAULT_ANIM_PATH,
        help="Output path for the animation (extension selects format).",
    )
    parser.add_argument("--anim_fps", type=float, default=50.0)
    parser.add_argument("--anim_bitrate", type=int, default=4500)
    parser.add_argument("--anim_points_per_frame", type=int, default=5)
    parser.add_argument(
        "--no_plot", action="store_true", default=False,
        help="Skip figures entirely (headless runs).",
    )
    parser.add_argument(
        "--verbose", type=int, default=2, choices=[0, 1, 2],
        help="0 = silent, 1 = minimal, 2 = detailed.",
    )
    return parser.parse_args()


def main() -> None:
    args = parse_args()
    verbose = args.verbose

    # 1. Plant + controller parameters from YAML.
    if verbose:
        print("Loading system parameters from configuration file")
    system_model = LTISystemModel(
        config_file=args.model_config_path,
        model_key_value=args.model_key_value,
        verbose=verbose,
    )

    if verbose:
        print(
            "Loading Data-Driven MPC controller parameters from "
            "configuration file"
        )
    m = system_model.get_number_inputs()
    p = system_model.get_number_outputs()
    dd_mpc_config = get_data_driven_mpc_controller_params(
        config_file=args.controller_config_path,
        controller_key_value=args.controller_key_value,
        m=m,
        p=p,
        verbose=verbose,
    )

    # CLI overrides.
    if args.n_mpc_step is not None:
        dd_mpc_config["n_mpc_step"] = args.n_mpc_step
    if args.controller_type is not None:
        dd_mpc_config["controller_type"] = CONTROLLER_TYPE_MAP[
            args.controller_type
        ]
    if args.slack_var_const_type is not None:
        dd_mpc_config["slack_var_constraint_type"] = SLACK_TYPE_MAP[
            args.slack_var_const_type
        ]

    n_steps = args.t_sim + 1
    np_random = np.random.default_rng(seed=args.seed)
    if verbose:
        print(
            "Random number generator initialized with "
            + ("a random seed" if args.seed is None else f"seed: {args.seed}")
        )

    # 2. Random plausible initial state.
    if verbose:
        print("Randomizing initial system state")
    x_0 = randomize_initial_system_state(
        system_model=system_model,
        controller_config=dd_mpc_config,
        np_random=np_random,
    )
    system_model.set_state(state=x_0)

    # 3. Initial I/O data generation (excitation phase).
    if verbose:
        print("Generating initial input-output data")
    u_d, y_d = generate_initial_input_output_data(
        system_model=system_model,
        controller_config=dd_mpc_config,
        np_random=np_random,
    )

    # 4. Controller construction (builds + factorizes the QP once).
    ctype = dd_mpc_config["controller_type"].name.capitalize()
    if verbose:
        print(f"Initializing {ctype} Data-Driven MPC controller")
    dd_mpc_controller = create_data_driven_mpc_controller(
        controller_config=dd_mpc_config, u_d=u_d, y_d=y_d,
        allow_nonconvex_slack=args.allow_nonconvex_slack,
    )

    # 5. Closed-loop simulation.
    if verbose:
        print(
            f"Starting {ctype} Data-Driven MPC control system simulation "
            f"({args.engine} engine)"
        )
    if (
        (args.u_min is not None or args.u_max is not None)
        and args.engine != "fused"
    ):
        raise SystemExit(
            "--u_min/--u_max require --engine fused (the box-ADMM "
            "solver runs in the generic scan engine)."
        )
    if args.engine in ("fused", "linear"):
        import jax.numpy as jnp

        from direct_data_driven_mpc_jax.qp.spec import (
            SlackVarConstraintTypes as _S,
        )

        w_sys = system_model.get_eps_max() * np_random.uniform(
            -1.0, 1.0, (n_steps, p)
        )
        if args.engine == "linear":
            from direct_data_driven_mpc_jax.control.linear_engine import (
                build_linear_engine,
                linear_closed_loop_rollout,
            )

            if dd_mpc_controller.spec.slack_var_constraint_type in (
                _S.CONVEX,
                _S.NON_CONVEX,
            ):
                raise SystemExit(
                    f"--engine {args.engine} requires a slack-NONE "
                    "controller (the ADMM clip does not condense); use "
                    "--engine fused."
                )
            bm = build_linear_engine(
                dd_mpc_controller,
                system_model.as_params(),
                solves_per_block=min(
                    50,
                    -(-n_steps // dd_mpc_controller.n_mpc_step),
                ),
            )
            result = linear_closed_loop_rollout(
                bm,
                jnp.asarray(system_model.get_state(), jnp.float32),
                jnp.asarray(
                    dd_mpc_controller.u_past.reshape(-1, m),
                    jnp.float32,
                ),
                jnp.asarray(
                    dd_mpc_controller.y_past.reshape(-1, p),
                    jnp.float32,
                ),
                W=jnp.asarray(w_sys, jnp.float32),
                n_steps=n_steps,
                n_mpc_step=dd_mpc_controller.n_mpc_step,
            )
        else:
            from direct_data_driven_mpc_jax.control.loop import (
                closed_loop_rollout,
            )

            # The EFFECTIVE slack type: NOMINAL controllers ignore the
            # configured slack setting (the reference defines sigma
            # constraints only for ROBUST, ref :494-498).
            if args.u_min is not None or args.u_max is not None:
                # Actuator saturation via the general box-ADMM
                # (keeps a CONVEX slack box automatically if present).
                solver = dd_mpc_controller.box_admm_solver(
                    u_bounds=(args.u_min, args.u_max)
                )
            elif (
                dd_mpc_controller.spec.slack_var_constraint_type
                == _S.CONVEX
            ):
                solver = dd_mpc_controller.admm_solver()
            elif (
                dd_mpc_controller.spec.slack_var_constraint_type
                == _S.NON_CONVEX
            ):
                solver = dd_mpc_controller.nonconvex_admm_solver()
            else:
                solver = dd_mpc_controller.solution_map()
            result = closed_loop_rollout(
                system_model.as_params(),
                solver,
                jnp.asarray(system_model.get_state(), jnp.float32),
                jnp.asarray(
                    dd_mpc_controller.u_past.reshape(-1, m), jnp.float32
                ),
                jnp.asarray(
                    dd_mpc_controller.y_past.reshape(-1, p), jnp.float32
                ),
                jnp.asarray(w_sys, jnp.float32),
                n_steps=n_steps,
                n_mpc_step=dd_mpc_controller.n_mpc_step,
            )
        u_sys = np.asarray(result.u_sys, dtype=np.float64)
        y_sys = np.asarray(result.y_sys, dtype=np.float64)
        if verbose > 1:
            costs = np.asarray(result.costs)
            print(
                f"    Solves: {costs.shape[0]}, final cost "
                f"{costs[-1]:.4f}, all converged: "
                f"{bool(np.all(np.asarray(result.converged)))}"
            )
    else:
        u_sys, y_sys = simulate_data_driven_mpc_control_loop(
            system_model=system_model,
            data_driven_mpc_controller=dd_mpc_controller,
            n_steps=n_steps,
            np_random=np_random,
            verbose=verbose,
        )

    if verbose:
        y_err = np.abs(
            y_sys[-1] - dd_mpc_config["y_s"].flatten()
        ).max()
        print(f"Simulation finished; final output error {y_err:.5f}")

    if args.no_plot:
        return

    # 6. Plot + animate.
    from direct_data_driven_mpc_jax.viz.plots import (
        plot_input_output,
        plot_input_output_animation,
        save_animation,
    )
    from direct_data_driven_mpc_jax.viz.styles import (
        INPUT_OUTPUT_PLOT_PARAMS,
        INPUT_OUTPUT_PLOT_PARAMS_SMALL,
    )

    N = dd_mpc_config["N"]
    u_s = dd_mpc_config["u_s"]
    y_s = dd_mpc_config["y_s"]
    plot_title = f"{ctype} Data-Driven MPC"

    if verbose:
        print("Displaying control system inputs and outputs plot")
    plot_input_output(
        u_k=u_sys,
        y_k=y_sys,
        u_s=u_s,
        y_s=y_s,
        figsize=(14, 8),
        dpi=100,
        title=plot_title,
        **INPUT_OUTPUT_PLOT_PARAMS,
    )

    U = np.vstack([u_d, u_sys])
    Y = np.vstack([y_d, y_sys])
    if verbose:
        print(
            "Displaying control system inputs and outputs including "
            "initial input-output measurements"
        )
    plot_input_output(
        u_k=U,
        y_k=Y,
        u_s=u_s,
        y_s=y_s,
        initial_steps=N,
        figsize=(14, 8),
        dpi=100,
        title=plot_title,
        **INPUT_OUTPUT_PLOT_PARAMS_SMALL,
    )

    if verbose:
        print("Displaying animation from extended input-output data")
    anim = plot_input_output_animation(
        u_k=U,
        y_k=Y,
        u_s=u_s,
        y_s=y_s,
        initial_steps=N,
        figsize=(14, 8),
        dpi=100,
        interval=1000 / args.anim_fps,
        points_per_frame=args.anim_points_per_frame,
        title=plot_title,
        **INPUT_OUTPUT_PLOT_PARAMS_SMALL,
    )
    import matplotlib.pyplot as plt

    plt.show()

    if args.save_anim:
        data_length = N + n_steps
        anim_frames = (
            math.ceil((data_length - 1) / args.anim_points_per_frame) + 1
        )
        if verbose:
            print("Saving extended input-output animation to file")
        save_animation(
            animation=anim,
            total_frames=anim_frames,
            fps=args.anim_fps,
            bitrate=args.anim_bitrate,
            file_path=args.anim_path,
        )
        if verbose:
            print("Animation file saved successfully")
    plt.close()


if __name__ == "__main__":
    from direct_data_driven_mpc_jax.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    main()

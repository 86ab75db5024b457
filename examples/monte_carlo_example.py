"""Monte-Carlo closed-loop robustness study (batched on-device capability).

Beyond reference parity: simulate THOUSANDS of noise scenarios of a
data-driven MPC closed loop in one device call (the reference simulates
exactly one scenario per run), then plot the tracking-error percentile
bands and the per-solve cost distribution.

Example:
    python examples/monte_carlo_example.py --batch 4096 --t_sim 200 \\
        --seed 0 --save_fig mc.png
"""

import argparse
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
)
from direct_data_driven_mpc_jax.models.lti_model import LTISystemModel
from direct_data_driven_mpc_jax.utils.config import (
    get_data_driven_mpc_controller_params,
)
from direct_data_driven_mpc_jax.utils.profiling import Timer

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


def parse_args() -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Monte-Carlo data-driven MPC robustness study"
    )
    parser.add_argument("--batch", type=int, default=4096,
                        help="Number of noise scenarios.")
    parser.add_argument("--t_sim", type=int, default=200,
                        help="Closed-loop steps per scenario.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--solves_per_block", type=int, default=50,
                        help="QP solves composed per scan iteration.")
    parser.add_argument("--no_plot", action="store_true", default=False)
    parser.add_argument("--save_fig", type=str, default=None)
    parser.add_argument("--verbose", type=int, default=1,
                        choices=[0, 1, 2])
    return parser.parse_args()


def main() -> None:
    args = parse_args()
    verbose = args.verbose

    import jax
    import jax.numpy as jnp

    from direct_data_driven_mpc_jax.control.linear_engine import (
        build_linear_engine,
        closed_loop_spectrum,
        make_linear_batched_rollout,
    )

    # Plant + controller from the standard YAML configs.
    system_model = LTISystemModel(
        config_file=MODEL_CONFIG, model_key_value="FourTankSystem"
    )
    m = system_model.get_number_inputs()
    p = system_model.get_number_outputs()
    config = get_data_driven_mpc_controller_params(
        config_file=CONTROLLER_CONFIG,
        controller_key_value="data_driven_mpc_params",
        m=m,
        p=p,
    )
    config["n_mpc_step"] = 1
    rng = np.random.default_rng(args.seed)
    x_0 = randomize_initial_system_state(system_model, config, rng)
    system_model.set_state(x_0)
    u_d, y_d = generate_initial_input_output_data(
        system_model, config, rng
    )
    ctrl = create_data_driven_mpc_controller(config, u_d, y_d)
    n = ctrl.n
    from direct_data_driven_mpc_jax.qp.spec import SlackVarConstraintTypes

    if ctrl.slack_var_constraint_type == SlackVarConstraintTypes.CONVEX:
        raise SystemExit(
            "The Monte-Carlo example uses the condensed affine engine, "
            "which requires a slack-NONE controller (set "
            "slack_var_constraint_type: 0 in the controller config)."
        )

    # Condensed engine + stability certificate.
    bm = build_linear_engine(
        ctrl,
        system_model.as_params(),
        solves_per_block=args.solves_per_block,
    )
    spectrum = closed_loop_spectrum(bm)
    if verbose:
        print(
            f"Closed-loop spectral radius: "
            f"{spectrum['spectral_radius']:.4f} "
            f"({'stable' if spectrum['stable'] else 'UNSTABLE'})"
        )

    # One device call: all scenarios, in-scan noise.
    B, T = args.batch, args.t_sim
    x0s = jnp.tile(
        jnp.asarray(system_model.get_state(), jnp.float32)[None], (B, 1)
    )
    ups = jnp.tile(
        jnp.asarray(ctrl.u_past.reshape(n, m), jnp.float32)[None],
        (B, 1, 1),
    )
    yps = jnp.tile(
        jnp.asarray(ctrl.y_past.reshape(n, p), jnp.float32)[None],
        (B, 1, 1),
    )
    keys = jax.random.split(jax.random.key(args.seed), B)
    run = make_linear_batched_rollout(
        bm,
        n_steps=T,
        use_rng_noise=True,
        eps_max=system_model.get_eps_max(),
    )
    def run_synced(*a):
        return jax.block_until_ready(run(*a))

    timer = Timer()
    result = timer.timeit(run_synced, x0s, ups, yps, keys, iters=1,
                          warmup=1)
    if verbose:
        print(
            f"Simulated {B} scenarios x {T} steps "
            f"({B * T} QP solves) in {timer.best:.3f}s"
        )

    y_sys = np.asarray(result.y_sys, dtype=np.float64)
    costs = np.asarray(result.costs, dtype=np.float64)
    y_s = config["y_s"].flatten()
    err = np.linalg.norm(y_sys - y_s, axis=-1)  # (B, T)

    if verbose:
        print(
            f"Final tracking error: p50 {np.percentile(err[:, -1], 50):.4f}"
            f", p95 {np.percentile(err[:, -1], 95):.4f}, "
            f"max {err[:, -1].max():.4f}"
        )
        print(
            f"Final solve cost: p50 {np.percentile(costs[:, -1], 50):.4f}"
            f", p95 {np.percentile(costs[:, -1], 95):.4f}"
        )

    if args.no_plot and not args.save_fig:
        return

    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(13, 5))
    ts = np.arange(T)
    for lo, hi, alpha in ((5, 95, 0.2), (25, 75, 0.35)):
        ax1.fill_between(
            ts,
            np.percentile(err, lo, axis=0),
            np.percentile(err, hi, axis=0),
            alpha=alpha,
            color="tab:blue",
            label=f"p{lo}-p{hi}",
        )
    ax1.plot(
        ts, np.percentile(err, 50, axis=0), color="tab:blue",
        label="median",
    )
    ax1.set_yscale("log")
    ax1.set_xlabel("Time step $k$")
    ax1.set_ylabel(r"$\|y_k - y_s\|_2$")
    ax1.set_title(f"Tracking error across {B} noise scenarios")
    ax1.legend()

    ax2.hist(costs[:, -1], bins=60, color="tab:blue", alpha=0.8)
    ax2.set_xlabel("Final QP cost")
    ax2.set_ylabel("Scenarios")
    ax2.set_title("Terminal solve-cost distribution")
    fig.tight_layout()
    if args.save_fig:
        fig.savefig(args.save_fig, dpi=150)
        if verbose:
            print(f"Figure saved to {args.save_fig}")
    elif not args.no_plot:
        plt.show()


if __name__ == "__main__":
    from direct_data_driven_mpc_jax.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    main()

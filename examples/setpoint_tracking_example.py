"""Time-varying setpoint tracking through the condensed fused engine.

Beyond reference parity: drive the closed loop along a SCHEDULE of
references -- the reference implementation can retarget only by
re-running its entire init pipeline (Hankels + CVXPY problem build +
validation solve) per setpoint change
(/root/reference/direct_data_driven_mpc/direct_data_driven_mpc_controller.py:945-982),
while here the schedule is just extra input lanes of the condensed
block map (control/linear_engine.py tracking channel), so a batch of
scenarios tracks the staircase at full fused-engine throughput.

Example:
    python examples/setpoint_tracking_example.py --batch 512 \\
        --t_sim 400 --save_fig tracking.png
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
        description="Setpoint-schedule tracking via the condensed "
        "fused engine"
    )
    parser.add_argument("--batch", type=int, default=512,
                        help="Number of noise scenarios.")
    parser.add_argument("--t_sim", type=int, default=400,
                        help="Closed-loop steps per scenario.")
    parser.add_argument("--phases", type=int, default=4,
                        help="Number of staircase phases.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--solves_per_block", type=int, default=25,
                        help="QP solves per block (= the schedule "
                        "granularity in steps, for n_mpc_step=1).")
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
        build_tracking_engine,
    )
    from direct_data_driven_mpc_jax.ops.fused_rollout import (
        make_fused_batched_rollout,
    )
    from direct_data_driven_mpc_jax.parallel.batch import draw_noise_batch

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
    from direct_data_driven_mpc_jax.qp.spec import SlackVarConstraintTypes

    if ctrl.slack_var_constraint_type != SlackVarConstraintTypes.NONE:
        raise SystemExit(
            "The tracking engine condenses slack-NONE controllers "
            "(set slack_var_constraint_type: 0 in the config)."
        )

    K = args.solves_per_block
    bm = build_tracking_engine(
        ctrl, system_model.as_params(), solves_per_block=K
    )

    # Staircase of output references between 0.6x and 1.0x of the
    # configured setpoint; the equilibrium input comes from the plant's
    # DC gain per phase (the same rule the reference config uses).
    import math

    T, B = args.t_sim, args.batch
    n_outer = math.ceil(T / K)
    y_s = np.asarray(ctrl.y_s).ravel()
    scales = np.linspace(1.0, 0.6, args.phases)
    blocks_per_phase = max(n_outer // args.phases, 1)
    sched = np.zeros((n_outer, m + p))
    for i in range(n_outer):
        s = scales[min(i // blocks_per_phase, args.phases - 1)]
        y_ref = s * y_s
        u_ref = system_model.get_equilibrium_input_from_output(y_ref)
        sched[i] = np.concatenate([u_ref, y_ref])
    sched = jnp.asarray(sched, jnp.float32)

    dtype = jnp.float32
    n = ctrl.n
    x0s = jnp.tile(
        jnp.asarray(system_model.get_state(), dtype)[None], (B, 1)
    )
    ups = jnp.tile(
        jnp.asarray(ctrl.u_past.reshape(n, m), dtype)[None], (B, 1, 1)
    )
    yps = jnp.tile(
        jnp.asarray(ctrl.y_past.reshape(n, p), dtype)[None], (B, 1, 1)
    )
    Ws = draw_noise_batch(
        jax.random.key(args.seed), B, T, p,
        system_model.get_eps_max(), dtype=dtype,
    )

    run = jax.jit(make_fused_batched_rollout(bm, n_steps=T))
    res = run(x0s, ups, yps, Ws, sched)
    jax.block_until_ready(res)
    y = np.asarray(res.y_sys)  # (B, T, p)
    y_ref_steps = np.repeat(
        np.asarray(sched)[:, m:], K, axis=0
    )[:T]  # (T, p)
    rmse = float(
        np.sqrt(np.mean((y - y_ref_steps[None]) ** 2))
    )
    if verbose:
        print(
            f"Tracked {B} scenarios x {T} steps through "
            f"{args.phases} reference phases; RMS tracking error "
            f"{rmse:.4f} (noise floor ~{system_model.get_eps_max()})."
        )
        tail = np.abs(y[:, -1] - y_ref_steps[-1]).max()
        print(f"max final-step deviation from the last reference: "
              f"{tail:.4f}")

    if args.no_plot and not args.save_fig:
        print("Simulation finished.")
        return

    import matplotlib

    if args.no_plot or args.save_fig:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(p, 1, figsize=(9, 3 * p), sharex=True)
    axes = np.atleast_1d(axes)
    t = np.arange(T)
    for j, ax in enumerate(axes):
        lo, med, hi = np.percentile(y[:, :, j], [5, 50, 95], axis=0)
        ax.fill_between(t, lo, hi, alpha=0.25,
                        label="5-95% of scenarios")
        ax.plot(t, med, label="median $y$")
        ax.step(t, y_ref_steps[:, j], where="post", linestyle="--",
                color="black", label="reference schedule")
        ax.set_ylabel(f"$y_{j + 1}$")
        ax.legend(loc="best", fontsize=8)
    axes[-1].set_xlabel("time step $k$")
    fig.suptitle(
        f"Setpoint-schedule tracking: {B} scenarios, "
        f"{args.phases} phases (condensed tracking engine)"
    )
    fig.tight_layout()
    if args.save_fig:
        fig.savefig(args.save_fig, dpi=120)
        if verbose:
            print(f"Figure saved to {args.save_fig}")
    if not args.no_plot and not args.save_fig:
        plt.show()
    print("Simulation finished.")


if __name__ == "__main__":
    from direct_data_driven_mpc_jax.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    main()

"""Gradient-based tuning of the robust MPC regularization (JAX-native
capability).

Beyond reference parity: the robust scheme's ridge weights
(``lambda_alpha_epsilon_bar`` and ``lambda_sigma`` in the YAML schema;
reference cost at direct_data_driven_mpc_controller.py:713-716) are
tuned by GRADIENT DESCENT on the actual closed-loop Monte-Carlo
tracking objective -- the KKT solve, the affine solution operator, and
the fused closed-loop scan are all differentiable JAX code
(control/tuning.py). The reference's per-step CVXPY rebuild is not
differentiable; it can only grid-search.

Example:
    python examples/regularization_tuning_example.py --batch 8 \\
        --t_sim 80 --steps 25 --seed 0
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
        description=(
            "Gradient-descent the robust MPC regularization against "
            "the closed-loop Monte-Carlo tracking objective"
        )
    )
    parser.add_argument("--batch", type=int, default=8,
                        help="Noise scenarios in the tuning objective.")
    parser.add_argument("--t_sim", type=int, default=80,
                        help="Closed-loop steps per scenario.")
    parser.add_argument("--steps", type=int, default=25,
                        help="Adam steps.")
    parser.add_argument("--lr", type=float, default=0.4,
                        help="Adam learning rate (log-space).")
    parser.add_argument(
        "--inflate", type=float, default=100.0,
        help="Multiply the YAML alpha ridge by this factor before "
        "tuning (demonstrates recovery from a bad initial guess).",
    )
    parser.add_argument("--seed", type=int, default=0)
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

    # Tuning is init-time host work: the float64 KKT solve runs on the
    # CPU.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from direct_data_driven_mpc_jax.control.tuning import (
        make_closed_loop_objective,
        tune_regularization,
    )

    system_model = LTISystemModel(
        MODEL_CONFIG, "FourTankSystem", verbose=verbose
    )
    mpc_params = get_data_driven_mpc_controller_params(
        CONTROLLER_CONFIG,
        "data_driven_mpc_params",
        m=system_model.get_number_inputs(),
        p=system_model.get_number_outputs(),
        verbose=verbose,
    )

    rng = np.random.default_rng(args.seed)
    x0 = randomize_initial_system_state(system_model, mpc_params, rng)
    system_model.set_state(x0)
    u_d, y_d = generate_initial_input_output_data(
        system_model, mpc_params, rng
    )
    controller = create_data_driven_mpc_controller(mpc_params, u_d, y_d)

    n, m, p = controller.n, controller.m, controller.p
    B, T = args.batch, args.t_sim
    x0s = jnp.tile(jnp.asarray(system_model.get_state())[None], (B, 1))
    ups = jnp.tile(
        jnp.asarray(controller.u_past.reshape(n, m))[None], (B, 1, 1)
    )
    yps = jnp.tile(
        jnp.asarray(controller.y_past.reshape(n, p))[None], (B, 1, 1)
    )
    eps = system_model.get_eps_max()
    Ws = jnp.asarray(rng.uniform(-eps, eps, (B, T, p)))

    loss = make_closed_loop_objective(
        controller.spec, system_model.as_params(),
        x0s, ups, yps, Ws, n_steps=T,
        n_mpc_step=controller.n_mpc_step,
    )

    a_yaml = controller.lamb_alpha * controller.eps_max
    s_yaml = controller.lamb_sigma
    a0 = args.inflate * a_yaml
    print(
        f"YAML ridge: alpha_reg={a_yaml:.4e} sigma_reg={s_yaml:.4e} "
        f"(loss {float(loss(jnp.log(jnp.asarray([a_yaml, s_yaml])))):.6e})"
    )
    print(
        f"tuning from inflated start alpha_reg={a0:.4e} "
        f"({args.steps} adam steps, lr={args.lr})..."
    )
    out = tune_regularization(
        loss, alpha_reg0=a0, sigma_reg0=s_yaml,
        steps=args.steps, learning_rate=args.lr,
        verbose=verbose >= 2,
    )
    print(
        f"tuned: alpha_reg={out['alpha_reg']:.4e} "
        f"sigma_reg={out['sigma_reg']:.4e}; loss "
        f"{out['initial_loss']:.6e} -> {out['final_loss']:.6e} "
        f"({out['initial_loss'] / max(out['final_loss'], 1e-300):.2f}x "
        "better)"
    )

    if args.no_plot and not args.save_fig:
        return
    import matplotlib

    if args.save_fig or args.no_plot:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 3.5), layout="constrained")
    ax.semilogy(out["loss_history"], marker="o", ms=3)
    ax.set_xlabel("adam step")
    ax.set_ylabel("closed-loop tracking loss")
    ax.set_title("Gradient tuning of the robust MPC regularization")
    if args.save_fig:
        fig.savefig(args.save_fig, dpi=150)
        print(f"figure saved to {args.save_fig}")
    if not args.no_plot:
        plt.show()


if __name__ == "__main__":
    from direct_data_driven_mpc_jax.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    main()

"""Property-style engine parity across random problem dimensions.

The pairwise parity tests pin the four-tank shapes; this sweep checks
the host loop == generic engine == condensed engine == time-parallel
engine == fused rollout identity holds across arbitrary
(ns, n, m, p, L, N, n_mpc_step) combinations -- including plants whose
true order differs from the controller's model order, n-step cadence
with trailing-block trimming, and the UCON (no terminal constraint)
scheme.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.controller import (
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_jax.control.linear_engine import (
    build_linear_engine,
    linear_closed_loop_rollout,
    time_parallel_rollout,
)
from direct_data_driven_mpc_jax.control.loop import closed_loop_rollout
from direct_data_driven_mpc_jax.control.operation import (
    simulate_data_driven_mpc_control_loop,
)
from direct_data_driven_mpc_jax.models.random_lti import random_stable_lti
from direct_data_driven_mpc_jax.ops.fused_rollout import (
    fused_batched_rollout,
)
from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

CASES = [
    # (seed, ns, n, m, p, L, n_mpc_step, controller_type, use_terminal)
    (0, 3, 3, 1, 1, 8, 1, DataDrivenMPCType.ROBUST, True),
    (1, 5, 4, 2, 3, 9, 3, DataDrivenMPCType.ROBUST, True),
    (2, 2, 2, 3, 1, 6, 1, DataDrivenMPCType.NOMINAL, True),
    (3, 6, 5, 1, 2, 11, 5, DataDrivenMPCType.ROBUST, True),
    (4, 4, 3, 2, 2, 7, 2, DataDrivenMPCType.NOMINAL, True),
    # UCON: no terminal constraint (1-step and n-step cadence).
    (5, 4, 4, 2, 2, 9, 1, DataDrivenMPCType.ROBUST, False),
    (6, 3, 3, 1, 2, 8, 3, DataDrivenMPCType.ROBUST, False),
]


@pytest.mark.parametrize(
    "seed,ns,n,m,p,L,n_mpc_step,ctype,use_terminal", CASES
)
def test_all_engines_agree_on_random_dims(
    seed, ns, n, m, p, L, n_mpc_step, ctype, use_terminal
):
    rng = np.random.default_rng(seed)
    plant = random_stable_lti(
        seed=seed, ns=ns, m=m, p=p, spectral_radius=0.85
    )
    N = m * (L + 2 * n) + L + 2 * n - 1 + 10
    u_d = rng.uniform(-1, 1, (N, m))
    w_d = 0.002 * rng.uniform(-1, 1, (N, p))
    y_d = plant.simulate(u_d, w_d, N)
    u_s = 0.3 * np.ones((m, 1))
    y_s = plant.get_equilibrium_output_from_input(
        u_s.flatten()
    ).reshape(-1, 1)
    ctrl = DirectDataDrivenMPCController(
        n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(p * L), R=1e-4 * np.eye(m * L),
        u_s=u_s, y_s=y_s,
        eps_max=0.002, lamb_alpha=50.0, lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=ctype, n_mpc_step=n_mpc_step,
        use_terminal_constraint=use_terminal,
    )

    n_steps = 3 * n_mpc_step + 1  # non-multiple: exercises trimming
    w_sys = 0.002 * rng.uniform(-1, 1, (n_steps, p))
    x0 = plant.get_state().copy()
    up = ctrl.u_past.reshape(n, m).copy()
    yp = ctrl.y_past.reshape(n, p).copy()

    u_host, y_host = simulate_data_driven_mpc_control_loop(
        plant, ctrl, n_steps, rng, verbose=0, w_sys=w_sys
    )
    generic = closed_loop_rollout(
        plant.as_params(),
        ctrl.solution_map(dtype=jnp.float64),
        x0, up, yp, w_sys,
        n_steps=n_steps, n_mpc_step=n_mpc_step,
    )
    bm = build_linear_engine(
        plant=plant.as_params(), controller=ctrl,
        solves_per_block=2, dtype=jnp.float64,
    )
    linear = linear_closed_loop_rollout(
        bm, x0, up, yp, W=w_sys,
        n_steps=n_steps, n_mpc_step=n_mpc_step,
    )
    time_par = time_parallel_rollout(
        bm, x0, up, yp, w_sys,
        n_steps=n_steps, n_mpc_step=n_mpc_step,
    )
    # Fused condensed rollout (computes in float32).
    bm32 = build_linear_engine(
        plant=plant.as_params(), controller=ctrl,
        solves_per_block=2, dtype=jnp.float32,
    )
    fused = fused_batched_rollout(
        bm32,
        jnp.asarray(x0, jnp.float32)[None],
        jnp.asarray(up, jnp.float32)[None],
        jnp.asarray(yp, jnp.float32)[None],
        jnp.asarray(w_sys, jnp.float32)[None],
        n_steps=n_steps, n_mpc_step=n_mpc_step,
    )

    np.testing.assert_allclose(
        np.asarray(generic.u_sys), u_host, atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(linear.u_sys), u_host, atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(linear.y_sys), y_host, atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(time_par.u_sys), u_host, atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(time_par.y_sys), y_host, atol=1e-8
    )
    # Short rollouts: f32 fused parity well inside the 1e-4 budget.
    np.testing.assert_allclose(
        np.asarray(fused.u_sys[0]), u_host, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(fused.y_sys[0]), y_host, atol=1e-4
    )
    # Per-solve costs agree across engines too.
    np.testing.assert_allclose(
        np.asarray(linear.costs), np.asarray(generic.costs),
        atol=1e-7, rtol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(time_par.costs), np.asarray(generic.costs),
        atol=1e-7, rtol=1e-7,
    )

"""Tests for the NON_CONVEX slack-variable solver (paper Eq. 6d).

The reference raises NotImplementedError for this variant (reference
direct_data_driven_mpc_controller.py:666-670); qp/nonconvex.py solves
it with a convex-concave fixed point over the pre-factorized ADMM.
Certification strategy (no external solver needed):

- the returned iterate is FEASIBLE for the original non-convex
  constraint ||sigma_pred||_inf <= c*eps_max*(1 + ||alpha||_1);
- at the converged bound b*, the iterate is the OPTIMUM of the
  convexified box QP (checked against a long-run fixed-bound ADMM
  solve), i.e. a KKT/stationary point of the non-convex program;
- its objective never exceeds the CONVEX variant's (the CONVEX box is
  contained in every outer iterate's box);
- the device solve matches the float64 host twin.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from direct_data_driven_mpc_jax.qp.admm import admm_solve_np
from direct_data_driven_mpc_jax.qp.nonconvex import (
    compute_nonconvex_admm_solver,
    compute_nonconvex_operator_np,
    nonconvex_admm_solve,
    nonconvex_admm_solve_np,
)
from direct_data_driven_mpc_jax.qp.spec import SlackVarConstraintTypes

from test_qp import _small_problem


@pytest.fixture(scope="module")
def nc_problem():
    """NON_CONVEX spec with a c small enough that the box binds (the
    convex box would clip sigma, so the bound relaxation is material)."""
    spec, theta = _small_problem(
        slack=SlackVarConstraintTypes.NON_CONVEX,
        c=0.05,
        allow_nonconvex=True,
    )
    return spec, theta


def test_default_still_raises_reference_parity():
    with pytest.raises(NotImplementedError):
        _small_problem(slack=SlackVarConstraintTypes.NON_CONVEX)


def test_fixed_point_feasible_and_converged(nc_problem):
    spec, theta = nc_problem
    op = compute_nonconvex_operator_np(spec)
    u, cost, (s, w, bound), stats = nonconvex_admm_solve_np(op, theta)
    r_prim, r_dual, delta, viol, bound_out, converged = stats
    assert converged
    assert viol <= 1e-10
    assert delta <= 1e-9
    # Eq. 6d's bound is strictly wider than the CONVEX box whenever
    # alpha is nonzero (it always is: alpha reproduces the trajectory).
    assert bound_out > float(op["c_eps"])
    assert np.isfinite(u).all() and np.isfinite(cost)


def test_fixed_point_is_box_qp_optimum_at_final_bound(nc_problem):
    """At the converged bound b*, the iterate must be the exact optimum
    of the convexified box QP => a stationary (local-KKT) point of the
    non-convex program."""
    spec, theta = nc_problem
    op = compute_nonconvex_operator_np(spec)
    u, cost, (s, w, bound), stats = nonconvex_admm_solve_np(op, theta)
    op_fixed = dict(op)
    op_fixed["bound"] = bound
    u_ref, cost_ref, _, (_, _, conv) = admm_solve_np(
        op_fixed, theta, num_iters=20000, tol=1e-12
    )
    assert conv
    np.testing.assert_allclose(u, u_ref, atol=1e-8)
    assert abs(cost - cost_ref) <= 1e-8 * (1 + abs(cost_ref))


def test_cost_never_exceeds_convex_variant(nc_problem):
    spec, theta = nc_problem
    spec_cvx, _ = _small_problem(
        slack=SlackVarConstraintTypes.CONVEX, c=0.05
    )
    op = compute_nonconvex_operator_np(spec)
    _, cost_nc, _, stats = nonconvex_admm_solve_np(op, theta)
    assert stats[-1]
    from direct_data_driven_mpc_jax.qp.admm import (
        compute_admm_operator_np,
    )

    _, cost_cvx, _, (_, _, conv) = admm_solve_np(
        compute_admm_operator_np(spec_cvx), theta, num_iters=20000,
        tol=1e-12,
    )
    assert conv
    assert cost_nc <= cost_cvx + 1e-9 * (1 + abs(cost_cvx))


def test_device_solve_matches_host_twin(nc_problem):
    spec, theta = nc_problem
    op = compute_nonconvex_operator_np(spec)
    u_np, cost_np, _, stats_np = nonconvex_admm_solve_np(op, theta)
    solver = compute_nonconvex_admm_solver(spec, dtype=jnp.float64)
    u_dev, cost_dev, state, stats = jax.jit(
        lambda th: nonconvex_admm_solve(
            solver, th, outer_iters=20, inner_iters=2000, tol=1e-10
        )
    )(jnp.asarray(theta))
    assert bool(stats.converged)
    np.testing.assert_allclose(np.asarray(u_dev), u_np, atol=1e-8)
    assert abs(float(cost_dev) - cost_np) <= 1e-8 * (1 + abs(cost_np))
    np.testing.assert_allclose(
        float(stats.bound), stats_np[4], rtol=1e-8
    )


def test_warm_start_outer_converges_immediately(nc_problem):
    """Warm-started from a converged state, 1 outer iteration must
    already be at the fixed point (the closed-loop engine relies on
    this for its small fixed outer trip count)."""
    spec, theta = nc_problem
    solver = compute_nonconvex_admm_solver(spec, dtype=jnp.float64)
    theta_j = jnp.asarray(theta)
    _, _, state, _ = nonconvex_admm_solve(
        solver, theta_j, outer_iters=20, inner_iters=2000, tol=1e-10
    )
    u1, _, _, stats1 = nonconvex_admm_solve(
        solver, theta_j, outer_iters=1, inner_iters=200, state=state,
        tol=1e-10,
    )
    assert bool(stats1.converged)
    u_ref, _, _, _ = nonconvex_admm_solve(
        solver, theta_j, outer_iters=20, inner_iters=2000, tol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(u1), np.asarray(u_ref), atol=1e-8
    )


def test_closed_loop_with_nonconvex_solver():
    """Full fused rollout (lax.scan) with the Eq. 6d solver: all lanes
    converge, the loop is stable, and the output tracks the setpoint."""
    from direct_data_driven_mpc_jax.control.controller import (
        DirectDataDrivenMPCController,
    )
    from direct_data_driven_mpc_jax.control.loop import (
        closed_loop_rollout,
    )
    from direct_data_driven_mpc_jax.models.lti_model import LTIModel
    from direct_data_driven_mpc_jax.qp.spec import (
        DataDrivenMPCType,
    )

    rng = np.random.default_rng(0)
    plant = LTIModel(
        A=np.array([[0.9, 0.2], [0.0, 0.8]]),
        B=np.array([[0.0], [1.0]]),
        C=np.array([[1.0, 0.3]]),
        D=np.array([[0.1]]),
        eps_max=0.002,
    )
    N, L, n = 30, 6, 2
    u_d = rng.uniform(-1, 1, (N, 1))
    w_d = 0.002 * rng.uniform(-1, 1, (N, 1))
    y_d = plant.simulate(u_d, w_d, N)
    u_s = np.array([[0.5]])
    y_s = plant.get_equilibrium_output_from_input(
        np.array([0.5])
    ).reshape(-1, 1)
    ctrl = DirectDataDrivenMPCController(
        n=n, m=1, p=1, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(L), R=1e-4 * np.eye(L),
        u_s=u_s, y_s=y_s,
        eps_max=0.002, lamb_alpha=50.0, lamb_sigma=1000.0, c=0.05,
        slack_var_constraint_type=SlackVarConstraintTypes.NON_CONVEX,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
        allow_nonconvex_slack=True,
    )
    assert ctrl.get_problem_solve_status() == "optimal"

    solver = ctrl.nonconvex_admm_solver(dtype=jnp.float64)
    T = 100
    W = 0.002 * jax.random.uniform(
        jax.random.key(1), (T, 1), minval=-1, maxval=1,
        dtype=jnp.float64,
    )
    res = closed_loop_rollout(
        plant.as_params(dtype=np.float64), solver,
        jnp.zeros(n, jnp.float64),
        jnp.asarray(ctrl.u_past.reshape(n, 1)),
        jnp.asarray(ctrl.y_past.reshape(n, 1)),
        W, n_steps=T, admm_iters=300,
    )
    assert bool(jnp.all(res.converged))
    assert bool(jnp.isfinite(res.u_sys).all())
    # ~1% relative steady-state error (y_s = 5.8) from the measurement
    # noise + regularization; the CONVEX variant shows the identical
    # 0.057 on this config, so 0.1 bounds solver-induced error.
    y_err = float(jnp.abs(res.y_sys[-5:] - y_s.flatten()).max())
    assert y_err < 0.1, f"setpoint tracking error {y_err}"


def test_controller_nonconvex_parity_raise_and_optin():
    """The reference-parity raise stays the DEFAULT controller
    behavior; the opt-in flag unlocks the solver."""
    from direct_data_driven_mpc_jax.control.controller import (
        DirectDataDrivenMPCController,
    )
    from direct_data_driven_mpc_jax.models.lti_model import LTIModel
    from direct_data_driven_mpc_jax.qp.spec import DataDrivenMPCType

    rng = np.random.default_rng(0)
    plant = LTIModel(
        A=np.array([[0.9, 0.2], [0.0, 0.8]]),
        B=np.array([[0.0], [1.0]]),
        C=np.array([[1.0, 0.3]]),
        D=np.array([[0.1]]),
        eps_max=0.002,
    )
    N, L, n = 30, 6, 2
    u_d = rng.uniform(-1, 1, (N, 1))
    w_d = 0.002 * rng.uniform(-1, 1, (N, 1))
    y_d = plant.simulate(u_d, w_d, N)
    kwargs = dict(
        n=n, m=1, p=1, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(L), R=1e-4 * np.eye(L),
        u_s=np.array([[0.5]]),
        y_s=plant.get_equilibrium_output_from_input(
            np.array([0.5])
        ).reshape(-1, 1),
        eps_max=0.002, lamb_alpha=50.0, lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes.NON_CONVEX,
        controller_type=DataDrivenMPCType.ROBUST,
    )
    with pytest.raises(NotImplementedError):
        DirectDataDrivenMPCController(**kwargs)
    ctrl = DirectDataDrivenMPCController(
        **kwargs, allow_nonconvex_slack=True
    )
    assert ctrl.get_problem_solve_status() == "optimal"
    # Per-step re-solve works and warm-starts (host path).
    ctrl.store_input_output_measurement(
        np.array([[0.5]]), np.array([[0.4]])
    )
    ctrl.update_and_solve_data_driven_mpc()
    assert ctrl.get_problem_solve_status() == "optimal"
    assert np.isfinite(ctrl.optimal_u).all()

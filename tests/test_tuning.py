"""Differentiable regularization tuning (control/tuning.py).

The ridge weights (lambda_alpha * eps_max, lambda_sigma) enter the QP
Hessian; the KKT solve is done in JAX, so gradients of closed-loop
objectives w.r.t. the regularization are exact. The reference can only
grid-search these (its per-step CVXPY rebuild is not differentiable)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.tuning import (
    differentiable_solution_map,
    make_closed_loop_objective,
    tune_regularization,
)
from direct_data_driven_mpc_jax.qp.solution_map import (
    compute_solution_operator_np,
)

from tests.test_closed_loop import _make_setup


@pytest.fixture(scope="module")
def setup():
    plant, ctrl, rng = _make_setup(n_mpc_step=1)
    return plant, ctrl, rng


def test_matches_host_operator_at_current_weights(setup):
    """At the controller's own ridge weights the differentiable map
    reproduces the host float64 operator exactly."""
    plant, ctrl, rng = setup
    a0 = ctrl.lamb_alpha * ctrl.eps_max
    s0 = ctrl.lamb_sigma
    sol = differentiable_solution_map(
        ctrl.spec, jnp.float64(a0), jnp.float64(s0)
    )
    ref = compute_solution_operator_np(ctrl.spec)
    np.testing.assert_allclose(
        np.asarray(sol.U_gain), ref["U_gain"], atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(sol.u_base), ref["u_base"], atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(sol.cost_P), ref["cost_P"], atol=1e-7
    )


def _batch(plant, ctrl, rng, B=3, T=25):
    n, m, p = 4, 2, 2
    x0s = jnp.tile(jnp.asarray(plant.get_state())[None], (B, 1))
    ups = jnp.tile(
        jnp.asarray(ctrl.u_past.reshape(n, m))[None], (B, 1, 1)
    )
    yps = jnp.tile(
        jnp.asarray(ctrl.y_past.reshape(n, p))[None], (B, 1, 1)
    )
    Ws = jnp.asarray(0.002 * rng.uniform(-1, 1, (B, T, p)))
    return x0s, ups, yps, Ws, T


def test_gradient_matches_finite_differences(setup):
    plant, ctrl, rng = setup
    x0s, ups, yps, Ws, T = _batch(plant, ctrl, rng)
    loss = make_closed_loop_objective(
        ctrl.spec, plant.as_params(), x0s, ups, yps, Ws, n_steps=T
    )
    log0 = jnp.log(
        jnp.asarray(
            [ctrl.lamb_alpha * ctrl.eps_max, ctrl.lamb_sigma],
            jnp.float64,
        )
    )
    g = jax.grad(loss)(log0)
    assert bool(jnp.all(jnp.isfinite(g)))
    eps = 1e-5
    for i in range(2):
        e = jnp.zeros(2, jnp.float64).at[i].set(eps)
        fd = (loss(log0 + e) - loss(log0 - e)) / (2 * eps)
        assert float(jnp.abs(g[i] - fd)) < 1e-6 + 1e-4 * abs(float(fd)), (
            f"coordinate {i}: grad {float(g[i])} vs FD {float(fd)}"
        )


def test_tuning_improves_closed_loop_objective(setup):
    """Starting from a deliberately over-regularized controller, a few
    adam steps in log-space must reduce the Monte-Carlo tracking
    loss."""
    plant, ctrl, rng = setup
    x0s, ups, yps, Ws, T = _batch(plant, ctrl, rng, B=4, T=30)
    loss = make_closed_loop_objective(
        ctrl.spec, plant.as_params(), x0s, ups, yps, Ws, n_steps=T
    )
    # 100x over-regularized alpha ridge: sluggish tracking.
    out = tune_regularization(
        loss,
        alpha_reg0=100.0 * ctrl.lamb_alpha * ctrl.eps_max,
        sigma_reg0=ctrl.lamb_sigma,
        steps=12,
        learning_rate=0.5,
    )
    assert out["final_loss"] < out["initial_loss"]
    # The tuned ridge moved back toward (below) the inflated start.
    assert out["alpha_reg"] < 100.0 * ctrl.lamb_alpha * ctrl.eps_max


def test_rejects_nominal_and_slack_variants(setup):
    plant, ctrl, rng = setup
    import dataclasses

    nominal_spec = dataclasses.replace(
        ctrl.spec,
        controller_type=type(ctrl.spec.controller_type).NOMINAL,
    )
    with pytest.raises(ValueError, match="ROBUST"):
        differentiable_solution_map(
            nominal_spec, jnp.float64(1.0), jnp.float64(1.0)
        )

"""Differentiability: the whole closed loop is differentiable JAX code,
so gradients flow through rollouts -- a capability the reference's
CVXPY-per-step architecture cannot offer (useful for tuning setpoints,
weights, or data against closed-loop objectives)."""

import numpy as np

import jax
import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.linear_engine import (
    build_affine_block_map,
    linear_closed_loop_rollout,
)
from direct_data_driven_mpc_jax.control.loop import closed_loop_rollout

from tests.test_closed_loop import _make_setup


def test_grad_through_closed_loop_wrt_initial_state():
    plant, ctrl, rng = _make_setup(n_mpc_step=1)
    params = plant.as_params()
    sol = ctrl.solution_map(dtype=jnp.float64)
    up = jnp.asarray(ctrl.u_past.reshape(4, 2))
    yp = jnp.asarray(ctrl.y_past.reshape(4, 2))
    W = jnp.asarray(0.002 * rng.uniform(-1, 1, (20, 2)))
    y_s = jnp.array([0.65, 0.77])

    def tracking_loss(x0):
        res = closed_loop_rollout(
            params, sol, x0, up, yp, W, n_steps=20
        )
        return jnp.sum((res.y_sys - y_s) ** 2)

    x0 = jnp.asarray(plant.get_state())
    g = jax.grad(tracking_loss)(x0)
    assert g.shape == x0.shape
    assert bool(jnp.isfinite(g).all())
    # Finite-difference check on one coordinate.
    eps = 1e-6
    e0 = jnp.zeros_like(x0).at[0].set(eps)
    fd = (tracking_loss(x0 + e0) - tracking_loss(x0 - e0)) / (2 * eps)
    assert float(jnp.abs(g[0] - fd)) < 1e-4 * max(1.0, abs(float(fd)))


def test_grad_through_linear_engine_wrt_noise():
    plant, ctrl, rng = _make_setup(n_mpc_step=1)
    bm = build_affine_block_map(
        plant.as_params(), ctrl._op, n=4, m=2, p=2,
        solves_per_block=5, dtype=jnp.float64,
    )
    x0 = jnp.asarray(plant.get_state())
    up = jnp.asarray(ctrl.u_past.reshape(4, 2))
    yp = jnp.asarray(ctrl.y_past.reshape(4, 2))

    def worst_case_cost(W):
        res = linear_closed_loop_rollout(
            bm, x0, up, yp, W=W, n_steps=20
        )
        return res.costs[-1]

    W = jnp.asarray(0.002 * rng.uniform(-1, 1, (20, 2)))
    g = jax.grad(worst_case_cost)(W)
    assert g.shape == W.shape
    assert bool(jnp.isfinite(g).all())
    assert float(jnp.abs(g).max()) > 0.0

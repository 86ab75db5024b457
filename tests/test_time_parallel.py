"""Time-parallel (associative-scan) rollout vs the sequential engine."""

import numpy as np
import pytest

import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.linear_engine import (
    build_affine_block_map,
    linear_closed_loop_rollout,
    time_parallel_rollout,
)

from tests.test_closed_loop import _make_setup


@pytest.mark.parametrize(
    "n_mpc_step,K,n_steps",
    [(1, 1, 40), (1, 8, 40), (1, 8, 37), (4, 4, 42)],
)
def test_time_parallel_matches_sequential(n_mpc_step, K, n_steps):
    plant, ctrl, rng = _make_setup(n_mpc_step=n_mpc_step)
    bm = build_affine_block_map(
        plant.as_params(), ctrl._op, n=4, m=2, p=2,
        n_mpc_step=n_mpc_step, solves_per_block=K, dtype=jnp.float64,
    )
    x0 = plant.get_state().copy()
    up = ctrl.u_past.reshape(4, 2).copy()
    yp = ctrl.y_past.reshape(4, 2).copy()
    W = 0.002 * rng.uniform(-1, 1, (n_steps, 2))

    seq = linear_closed_loop_rollout(
        bm, x0, up, yp, W=W, n_steps=n_steps, n_mpc_step=n_mpc_step
    )
    par = time_parallel_rollout(
        bm, x0, up, yp, W=W, n_steps=n_steps, n_mpc_step=n_mpc_step
    )
    np.testing.assert_allclose(
        np.asarray(par.u_sys), np.asarray(seq.u_sys), atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(par.y_sys), np.asarray(seq.y_sys), atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(par.costs), np.asarray(seq.costs), rtol=1e-7,
        atol=1e-9,
    )
    np.testing.assert_allclose(
        np.asarray(par.x_final), np.asarray(seq.x_final), atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(par.u_past), np.asarray(seq.u_past), atol=1e-9
    )

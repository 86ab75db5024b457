"""Super-block composition (K solves per scan iteration) must be exact
vs K=1 and vs the generic engine, including trimming."""

import numpy as np
import pytest

import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.linear_engine import (
    build_affine_block_map,
    linear_closed_loop_rollout,
)
from direct_data_driven_mpc_jax.control.loop import closed_loop_rollout

from tests.test_closed_loop import _make_setup


@pytest.mark.parametrize(
    "n_mpc_step,K,n_steps",
    [
        (1, 8, 40),   # exact multiple
        (1, 8, 37),   # trailing trim inside a super-block
        (4, 4, 42),   # Algorithm 2 + super-block + trim
        (1, 16, 50),
    ],
)
def test_superblock_matches_generic(n_mpc_step, K, n_steps):
    plant, ctrl, rng = _make_setup(n_mpc_step=n_mpc_step)
    params = plant.as_params()
    sol = ctrl.solution_map(dtype=jnp.float64)
    x0 = plant.get_state().copy()
    up = ctrl.u_past.reshape(4, 2).copy()
    yp = ctrl.y_past.reshape(4, 2).copy()
    W = 0.002 * rng.uniform(-1, 1, (n_steps, 2))

    ref = closed_loop_rollout(
        params, sol, x0, up, yp, W,
        n_steps=n_steps, n_mpc_step=n_mpc_step,
    )
    bm = build_affine_block_map(
        params, ctrl._op, n=4, m=2, p=2,
        n_mpc_step=n_mpc_step, solves_per_block=K, dtype=jnp.float64,
    )
    lin = linear_closed_loop_rollout(
        bm, x0, up, yp, W, n_steps=n_steps, n_mpc_step=n_mpc_step
    )
    np.testing.assert_allclose(
        np.asarray(lin.u_sys), np.asarray(ref.u_sys), atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(lin.y_sys), np.asarray(ref.y_sys), atol=1e-9
    )
    # Costs are per solve; generic emits ceil(n_steps / n_mpc_step).
    n_solves = -(-n_steps // n_mpc_step)
    np.testing.assert_allclose(
        np.asarray(lin.costs)[:n_solves],
        np.asarray(ref.costs)[:n_solves],
        rtol=1e-7,
        atol=1e-9,
    )

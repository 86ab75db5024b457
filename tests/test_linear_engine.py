"""The condensed affine engine must reproduce the generic fused engine
exactly (same algebra, different factorization of the computation)."""

import numpy as np
import pytest

import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.linear_engine import (
    build_affine_block_map,
    linear_closed_loop_rollout,
    make_linear_batched_rollout,
)
from direct_data_driven_mpc_jax.control.loop import closed_loop_rollout

from tests.test_closed_loop import _make_setup
from direct_data_driven_mpc_jax.qp.spec import DataDrivenMPCType


@pytest.mark.parametrize(
    "n_mpc_step,n_steps",
    [(1, 40), (4, 42)],  # 1-step and n-step (with trailing trim)
)
def test_linear_engine_matches_generic_engine(n_mpc_step, n_steps):
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
        params, ctrl._op, n=4, m=2, p=2, n_mpc_step=n_mpc_step,
        dtype=jnp.float64,
    )
    lin = linear_closed_loop_rollout(
        bm, x0, up, yp, W, n_steps=n_steps, n_mpc_step=n_mpc_step
    )
    np.testing.assert_allclose(
        np.asarray(lin.u_sys), np.asarray(ref.u_sys), atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(lin.y_sys), np.asarray(ref.y_sys), atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(lin.costs), np.asarray(ref.costs), rtol=1e-8, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(lin.u_past), np.asarray(ref.u_past), atol=1e-10
    )


def test_linear_engine_nominal_variant():
    plant, ctrl, rng = _make_setup(
        controller_type=DataDrivenMPCType.NOMINAL, n_mpc_step=1
    )
    params = plant.as_params()
    sol = ctrl.solution_map(dtype=jnp.float64)
    x0 = plant.get_state().copy()
    up = ctrl.u_past.reshape(4, 2).copy()
    yp = ctrl.y_past.reshape(4, 2).copy()
    W = 0.002 * rng.uniform(-1, 1, (30, 2))
    ref = closed_loop_rollout(params, sol, x0, up, yp, W, n_steps=30)
    bm = build_affine_block_map(
        params, ctrl._op, n=4, m=2, p=2, dtype=jnp.float64
    )
    lin = linear_closed_loop_rollout(bm, x0, up, yp, W, n_steps=30)
    np.testing.assert_allclose(
        np.asarray(lin.u_sys), np.asarray(ref.u_sys), atol=1e-9
    )


def test_linear_engine_batched():
    plant, ctrl, rng = _make_setup(n_mpc_step=1)
    bm = build_affine_block_map(
        plant.as_params(), ctrl._op, n=4, m=2, p=2, dtype=jnp.float64
    )
    B, n_steps = 3, 12
    x0 = plant.get_state().copy()
    up = ctrl.u_past.reshape(4, 2)
    yp = ctrl.y_past.reshape(4, 2)
    x0s = jnp.tile(jnp.asarray(x0)[None], (B, 1))
    ups = jnp.tile(jnp.asarray(up)[None], (B, 1, 1))
    yps = jnp.tile(jnp.asarray(yp)[None], (B, 1, 1))
    Ws = jnp.asarray(0.002 * rng.uniform(-1, 1, (B, n_steps, 2)))
    run = make_linear_batched_rollout(bm, n_steps=n_steps)
    batch = run(x0s, ups, yps, Ws)
    for b in range(B):
        single = linear_closed_loop_rollout(
            bm, x0s[b], ups[b], yps[b], Ws[b], n_steps=n_steps
        )
        np.testing.assert_allclose(
            np.asarray(batch.u_sys[b]), np.asarray(single.u_sys), atol=1e-12
        )


def _integrator_setup(a_diag: float):
    """Synthetic 1-state plant + zero-gain 'controller': the condensed
    closed loop is the open-loop plant + window shift, so its spectral
    radius equals ``a_diag`` -- an eigenvalue at/near 1 makes I - M
    (near-)singular, the centering robustness edge (VERDICT round-3
    weak #6)."""
    from direct_data_driven_mpc_jax.ops.lti import LTIParams

    plant = LTIParams(
        A=np.array([[a_diag]]),
        B=np.array([[1.0]]),
        C=np.array([[1.0]]),
        D=np.array([[0.0]]),
    )
    n_theta = 2  # n=1, m=1, p=1
    op = {
        # Zero feedback, constant input 0.5: the integrator drifts, so
        # no closed-loop fixed point exists.
        "U_gain": np.zeros((2, n_theta)),
        "u_base": np.full(2, 0.5),
        "cost_P": np.eye(n_theta),
        "cost_q": np.zeros(n_theta),
        "cost_r": np.float64(0.0),
    }
    return plant, op


@pytest.mark.parametrize("a_diag", [1.0, 1.0 - 1e-7])
def test_centering_falls_back_near_integrator(a_diag):
    """cond(I - M) blows up (exact integrator) or s* is absurdly large
    (near-integrator): centering must disable itself with a warning and
    produce the SAME map as center=False."""
    plant, op = _integrator_setup(a_diag)
    with pytest.warns(RuntimeWarning, match="centering disabled"):
        bm_c = build_affine_block_map(
            plant, op, n=1, m=1, p=1, dtype=jnp.float64
        )
    bm_u = build_affine_block_map(
        plant, op, n=1, m=1, p=1, center=False, dtype=jnp.float64
    )
    assert float(jnp.abs(bm_c.s_star).max()) == 0.0
    for f_c, f_u in zip(bm_c, bm_u):
        if f_c is None or isinstance(f_c, int):
            assert f_c == f_u
            continue
        np.testing.assert_array_equal(np.asarray(f_c), np.asarray(f_u))


def test_centering_fallback_f32_rollout_budget():
    """The f32 rollout on the (fallen-back) centered map stays within
    the 1e-4 budget of the exact f64 rollout -- the failure mode the
    guard prevents is exactly this accuracy loss."""
    plant, op = _integrator_setup(1.0)
    n_steps = 50
    rng = np.random.default_rng(0)
    W = 0.002 * rng.uniform(-1, 1, (n_steps, 1))
    x0 = np.array([0.3])
    up = np.array([[0.1]])
    yp = np.array([[0.2]])
    outs = {}
    for dtype in (jnp.float64, jnp.float32):
        with pytest.warns(RuntimeWarning, match="centering disabled"):
            bm = build_affine_block_map(
                plant, op, n=1, m=1, p=1, dtype=dtype
            )
        outs[dtype] = linear_closed_loop_rollout(
            bm,
            jnp.asarray(x0, dtype),
            jnp.asarray(up, dtype),
            jnp.asarray(yp, dtype),
            jnp.asarray(W, dtype),
            n_steps=n_steps,
        )
    du = np.abs(
        np.asarray(outs[jnp.float32].u_sys, np.float64)
        - np.asarray(outs[jnp.float64].u_sys)
    ).max()
    dy = np.abs(
        np.asarray(outs[jnp.float32].y_sys, np.float64)
        - np.asarray(outs[jnp.float64].y_sys)
    ).max()
    assert du < 1e-4 and dy < 1e-4, (du, dy)
    # The drift really happened (the loop is marginally stable, state
    # grows ~0.5/step): the test exercises large-magnitude f32 adds.
    assert float(np.asarray(outs[jnp.float64].y_sys)[-1]) > 5.0

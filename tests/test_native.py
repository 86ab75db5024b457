"""Native C hot path vs the NumPy reference implementations."""

import numpy as np
import pytest

from direct_data_driven_mpc_jax import native
from direct_data_driven_mpc_jax.qp.admm import admm_solve_np

from tests.test_qp import _small_problem
from direct_data_driven_mpc_jax.qp.admm import compute_admm_operator_np
from direct_data_driven_mpc_jax.qp.solution_map import (
    compute_solution_operator_np,
)
from direct_data_driven_mpc_jax.qp.spec import SlackVarConstraintTypes

pytestmark = pytest.mark.skipif(
    native.get_lib() is None, reason="no C compiler available"
)


def test_native_affine_matches_numpy():
    spec, theta = _small_problem()
    op = compute_solution_operator_np(spec)
    solver = native.NativeAffineSolver(op)
    u_c, cost_c = solver.solve(theta)
    u_np = op["u_base"] + op["U_gain"] @ theta
    cost_np = float(
        theta @ op["cost_P"] @ theta + op["cost_q"] @ theta + op["cost_r"]
    )
    np.testing.assert_allclose(u_c, u_np, rtol=1e-13, atol=1e-13)
    assert cost_c == pytest.approx(cost_np, rel=1e-12)


def test_native_admm_matches_numpy():
    spec, theta = _small_problem(
        slack=SlackVarConstraintTypes.CONVEX, c=1e-4
    )
    op = compute_admm_operator_np(spec)
    solver = native.NativeADMMSolver(op)
    nbox = solver.nbox
    s = np.zeros(nbox)
    w = np.zeros(nbox)
    u_c, cost_c, iters, rp, rd = solver.solve(theta, s, w, 500, 1e-10)
    u_np, cost_np, (s_np, w_np), (rp_np, rd_np, conv) = admm_solve_np(
        op, theta, num_iters=500, tol=1e-10
    )
    assert conv and rp <= 1e-10
    np.testing.assert_allclose(u_c, u_np, atol=1e-10)
    np.testing.assert_allclose(s, s_np, atol=1e-10)
    assert cost_c == pytest.approx(cost_np, abs=1e-9)


def test_controller_uses_native_and_matches(monkeypatch):
    """The controller must produce the same trajectory with and without
    the native path."""
    from tests.test_closed_loop import _make_setup
    from direct_data_driven_mpc_jax.control.operation import (
        simulate_data_driven_mpc_control_loop,
    )

    results = {}
    for disable_native in (False, True):
        if disable_native:
            monkeypatch.setattr(native, "get_lib", lambda: None)
        plant, ctrl, rng = _make_setup(seed=3, n_mpc_step=1)
        assert (ctrl._native is None) == disable_native
        w = 0.002 * rng.uniform(-1, 1, (20, 2))
        u_sys, y_sys = simulate_data_driven_mpc_control_loop(
            plant, ctrl, 20, rng, verbose=0, w_sys=w
        )
        results[disable_native] = (u_sys, y_sys)
        monkeypatch.undo()
    np.testing.assert_allclose(
        results[False][0], results[True][0], atol=1e-12
    )
    np.testing.assert_allclose(
        results[False][1], results[True][1], atol=1e-12
    )

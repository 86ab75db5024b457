"""Controller-class API tests: validation rules, window management,
setpoint updates (reference semantics cited in controller.py)."""

import numpy as np
import pytest

from direct_data_driven_mpc_jax.control.controller import (
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_jax.models.lti_model import LTIModel
from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

from tests.test_closed_loop import FOUR_TANK


def _make_controller(**overrides):
    rng = np.random.default_rng(0)
    plant = LTIModel(**FOUR_TANK)
    N, L = 400, 30
    u_d = rng.uniform(-1, 1, (N, 2))
    w_d = 0.002 * rng.uniform(-1, 1, (N, 2))
    y_d = plant.simulate(u_d, w_d, N)
    kwargs = dict(
        n=4,
        m=2,
        p=2,
        u_d=u_d,
        y_d=y_d,
        L=L,
        Q=3.0 * np.eye(2 * L),
        R=1e-4 * np.eye(2 * L),
        u_s=np.array([[1.0], [1.0]]),
        y_s=np.array([[0.65], [0.77]]),
        eps_max=0.002,
        lamb_alpha=50.0,
        lamb_sigma=1000.0,
        c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=DataDrivenMPCType.ROBUST,
        n_mpc_step=1,
    )
    kwargs.update(overrides)
    return DirectDataDrivenMPCController(**kwargs)


def test_construction_solves_initial_problem():
    ctrl = _make_controller()
    assert ctrl.get_problem_solve_status() == "optimal"
    assert ctrl.optimal_u.shape == (30 * 2,)
    assert np.isfinite(ctrl.get_optimal_cost_value())
    # Past windows seeded with the last n data samples as columns.
    assert ctrl.u_past.shape == (8, 1)
    assert ctrl.y_past.shape == (8, 1)
    np.testing.assert_allclose(
        ctrl.u_past.flatten(), ctrl.u_d[-4:].flatten()
    )


def test_pe_minimum_length_enforced():
    with pytest.raises(ValueError, match="persistently exciting"):
        _make_controller(
            u_d=np.random.default_rng(0).uniform(-1, 1, (50, 2)),
            y_d=np.zeros((50, 2)),
        )


def test_input_width_mismatch_rejected():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="number of inputs"):
        _make_controller(u_d=rng.uniform(-1, 1, (400, 3)))


def test_horizon_bounds_by_controller_type():
    with pytest.raises(ValueError, match="two times"):
        _make_controller(
            L=7,
            Q=3.0 * np.eye(2 * 7),
            R=1e-4 * np.eye(2 * 7),
        )  # robust needs L >= 2n = 8
    # Nominal accepts L >= n: L=8 is fine even though robust minimum
    # is also 8; use L=8 nominal to check no raise.
    _make_controller(
        L=8,
        Q=3.0 * np.eye(2 * 8),
        R=1e-4 * np.eye(2 * 8),
        controller_type=DataDrivenMPCType.NOMINAL,
    )


def test_weighting_matrix_shape_validation():
    with pytest.raises(ValueError, match="Q should be"):
        _make_controller(Q=np.eye(5))
    with pytest.raises(ValueError, match="R should be"):
        _make_controller(R=np.eye(5))


def test_missing_robust_params_rejected():
    with pytest.raises(ValueError, match="robust MPC parameters"):
        _make_controller(eps_max=None)


def test_store_measurement_shifts_window():
    ctrl = _make_controller()
    u_new = np.array([[0.1], [0.2]])
    y_new = np.array([[0.3], [0.4]])
    u_before = ctrl.u_past.copy()
    ctrl.store_input_output_measurement(u_new, y_new)
    np.testing.assert_allclose(ctrl.u_past[:-2], u_before[2:])
    np.testing.assert_allclose(ctrl.u_past[-2:], u_new)
    with pytest.raises(ValueError, match="Incorrect dimensions"):
        ctrl.store_input_output_measurement(np.zeros((3, 1)), y_new)


def test_set_past_data_validates_shapes():
    ctrl = _make_controller()
    ctrl.set_past_input_output_data(np.ones((8, 1)), np.ones((8, 1)))
    np.testing.assert_allclose(ctrl.u_past, np.ones((8, 1)))
    with pytest.raises(ValueError, match="u_past"):
        ctrl.set_past_input_output_data(np.ones((7, 1)), np.ones((8, 1)))


def test_optimal_input_step_slicing():
    ctrl = _make_controller()
    u0 = ctrl.get_optimal_control_input_at_step(0)
    assert u0.shape == (2,)
    np.testing.assert_allclose(u0, ctrl.optimal_u[:2])
    with pytest.raises(ValueError, match="out of range"):
        ctrl.get_optimal_control_input_at_step(30)


def test_setpoint_update_changes_solution():
    ctrl = _make_controller()
    u_before = ctrl.optimal_u.copy()
    ctrl.set_input_output_setpoints(
        np.array([[0.5], [0.5]]), np.array([[0.3], [0.4]])
    )
    assert ctrl.get_problem_solve_status() == "optimal"
    assert not np.allclose(ctrl.optimal_u, u_before)
    with pytest.raises(ValueError, match="u_s must have shape"):
        ctrl.set_input_output_setpoints(np.zeros((3, 1)), np.zeros((2, 1)))


def test_unsupported_slack_type_raises():
    with pytest.raises(NotImplementedError):
        _make_controller(
            slack_var_constraint_type=SlackVarConstraintTypes.NON_CONVEX
        )


def test_n_mpc_step_must_fit_in_horizon():
    with pytest.raises(ValueError, match="n_mpc_step"):
        _make_controller(n_mpc_step=31)  # L = 30
    with pytest.raises(ValueError, match="n_mpc_step"):
        _make_controller(n_mpc_step=0)

"""Unit tests for observability/Toeplitz/state-estimation/equilibrium math.

Expected values mirror the reference docstring example
(initial_state_estimation.py:57-70) and closed-form identities.
"""

import numpy as np

from direct_data_driven_mpc_jax.ops.estimation import (
    calculate_equilibrium_input_from_output,
    calculate_equilibrium_output_from_input,
    estimate_initial_state,
    observability_matrix,
    toeplitz_input_output_matrix,
)
from direct_data_driven_mpc_jax.ops.lti import LTIParams, lti_rollout


def _four_tank():
    A = np.array(
        [
            [0.921, 0, 0.041, 0],
            [0, 0.918, 0, 0.033],
            [0, 0, 0.924, 0],
            [0, 0, 0, 0.937],
        ]
    )
    B = np.array([[0.017, 0.001], [0.001, 0.023], [0, 0.061], [0.072, 0]])
    C = np.array([[1.0, 0, 0, 0], [0, 1, 0, 0]])
    D = np.zeros((2, 2))
    return A, B, C, D


def test_observability_matrix_closed_form():
    A, _, C, _ = _four_tank()
    Ot = np.asarray(observability_matrix(A, C))
    expected = np.vstack([C @ np.linalg.matrix_power(A, i) for i in range(4)])
    np.testing.assert_allclose(Ot, expected, rtol=1e-12)


def test_toeplitz_matches_reference_docstring_example():
    A = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], dtype=float)
    B = np.array([[1], [1], [0]], dtype=float)
    C = np.array([[1, 0, 2], [0, 1, 0]], dtype=float)
    D = np.array([[0], [1]], dtype=float)
    Tt = np.asarray(toeplitz_input_output_matrix(A, B, C, D, 3))
    expected = np.array(
        [
            [0.0, 0.0, 0.0],
            [1.0, 0.0, 0.0],
            [1.0, 0.0, 0.0],
            [1.0, 1.0, 0.0],
            [33.0, 1.0, 0.0],
            [9.0, 1.0, 1.0],
        ]
    )
    np.testing.assert_allclose(Tt, expected, rtol=1e-12)


def test_estimate_initial_state_roundtrip(rng):
    A, B, C, D = _four_tank()
    n = 4
    params = LTIParams(A=A, B=B, C=C, D=D)
    x0 = rng.normal(size=n)
    U = rng.uniform(-1, 1, (n, 2))
    W = np.zeros((n, 2))
    _, Y = lti_rollout(params, x0, U, W)
    Ot = observability_matrix(A, C)
    Tt = toeplitz_input_output_matrix(A, B, C, D, n)
    x0_hat = np.asarray(
        estimate_initial_state(Ot, Tt, U.flatten(), np.asarray(Y).flatten())
    )
    np.testing.assert_allclose(x0_hat, x0, atol=1e-8)


def test_equilibrium_pair_roundtrip():
    A, B, C, D = _four_tank()
    y_eq = np.array([0.65, 0.77])
    u_eq = np.asarray(calculate_equilibrium_input_from_output(A, B, C, D, y_eq))
    y_back = np.asarray(
        calculate_equilibrium_output_from_input(A, B, C, D, u_eq)
    )
    np.testing.assert_allclose(y_back, y_eq, atol=1e-10)
    # An equilibrium pair must be a fixed point of the dynamics: rolling
    # the plant from the implied steady state keeps the output at y_eq.
    x_eq = np.linalg.solve(np.eye(4) - A, B @ u_eq)
    params = LTIParams(A=A, B=B, C=C, D=D)
    _, Y = lti_rollout(
        params, x_eq, np.tile(u_eq, (10, 1)), np.zeros((10, 2))
    )
    np.testing.assert_allclose(np.asarray(Y), np.tile(y_eq, (10, 1)), atol=1e-10)

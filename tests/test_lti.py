"""Unit tests for the scannable LTI plant rollout."""

import numpy as np

from direct_data_driven_mpc_jax.ops.lti import LTIParams, lti_rollout, lti_step


def _numpy_rollout(A, B, C, D, x0, U, W):
    """Sequential loop reference (semantics of the reference's
    LTIModel.simulate, model_simulation.py:100-131: output before
    state update)."""
    x = x0.copy()
    Y = np.zeros((U.shape[0], C.shape[0]))
    for k in range(U.shape[0]):
        Y[k] = C @ x + D @ U[k] + W[k]
        x = A @ x + B @ U[k]
    return x, Y


def test_rollout_matches_loop(rng):
    n, m, p, T = 5, 3, 2, 50
    A = rng.normal(size=(n, n)) * 0.3
    B = rng.normal(size=(n, m))
    C = rng.normal(size=(p, n))
    D = rng.normal(size=(p, m))
    x0 = rng.normal(size=n)
    U = rng.normal(size=(T, m))
    W = rng.normal(size=(T, p)) * 0.01
    params = LTIParams(A=A, B=B, C=C, D=D)
    x_f, Y = lti_rollout(params, x0, U, W)
    x_ref, Y_ref = _numpy_rollout(A, B, C, D, x0, U, W)
    np.testing.assert_allclose(np.asarray(Y), Y_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(x_f), x_ref, rtol=1e-10, atol=1e-12)


def test_single_step_output_uses_pre_update_state(rng):
    n, m, p = 3, 2, 2
    A = rng.normal(size=(n, n))
    B = rng.normal(size=(n, m))
    C = rng.normal(size=(p, n))
    D = rng.normal(size=(p, m))
    x = rng.normal(size=n)
    u = rng.normal(size=m)
    w = rng.normal(size=p)
    params = LTIParams(A=A, B=B, C=C, D=D)
    x_next, y = lti_step(params, x, u, w)
    np.testing.assert_allclose(np.asarray(y), C @ x + D @ u + w, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(x_next), A @ x + B @ u, rtol=1e-12)

"""Property-based tests (hypothesis) for the core math layers."""

import numpy as np
from hypothesis import given, settings, strategies as st

from direct_data_driven_mpc_jax.models.c2d import c2d_zoh
from direct_data_driven_mpc_jax.ops.host import (
    estimate_initial_state_np,
    hankel_matrix_np,
    lti_rollout_np,
    observability_matrix_np,
    toeplitz_input_output_matrix_np,
)

SETTINGS = dict(max_examples=25, deadline=None)


@given(
    N=st.integers(3, 40),
    n=st.integers(1, 4),
    L=st.integers(1, 10),
    seed=st.integers(0, 2**31 - 1),
)
@settings(**SETTINGS)
def test_hankel_columns_are_windows(N, n, L, seed):
    if N < L:
        return
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, n))
    H = hankel_matrix_np(X, L)
    assert H.shape == (L * n, N - L + 1)
    for i in (0, (N - L) // 2, N - L):
        np.testing.assert_array_equal(H[:, i], X[i : i + L].ravel())


@given(
    ns=st.integers(1, 5),
    m=st.integers(1, 3),
    p=st.integers(1, 3),
    seed=st.integers(0, 2**31 - 1),
)
@settings(**SETTINGS)
def test_noise_free_state_estimation_recovers_x0(ns, m, p, seed):
    rng = np.random.default_rng(seed)
    # Random stable A keeps powers bounded; random C generically makes
    # the pair observable within ns steps (pinv handles the rest).
    A = rng.normal(size=(ns, ns)) * (0.5 / max(np.sqrt(ns), 1))
    B = rng.normal(size=(ns, m))
    C = rng.normal(size=(p, ns))
    D = rng.normal(size=(p, m))
    Ot = observability_matrix_np(A, C)
    if np.linalg.matrix_rank(Ot) < ns:
        return  # unobservable draw: estimator not applicable
    Tt = toeplitz_input_output_matrix_np(A, B, C, D, ns)
    x0 = rng.normal(size=ns)
    U = rng.normal(size=(ns, m))
    _, Y = lti_rollout_np(A, B, C, D, x0, U, np.zeros((ns, p)))
    x0_hat = estimate_initial_state_np(Ot, Tt, U.ravel(), Y.ravel())
    np.testing.assert_allclose(x0_hat, x0, atol=1e-6)


@given(
    ns=st.integers(1, 4),
    m=st.integers(1, 3),
    t1=st.floats(0.01, 1.0),
    t2=st.floats(0.01, 1.0),
    seed=st.integers(0, 2**31 - 1),
)
@settings(**SETTINGS)
def test_zoh_semigroup_property(ns, m, t1, t2, seed):
    """Discretizing at t1 + t2 equals composing the t1 and t2 steps
    (for the A part; B composes as Ad2 Bd1 + Bd2)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(ns, ns)) * 0.5
    B = rng.normal(size=(ns, m))
    Ad1, Bd1 = c2d_zoh(A, B, t1)
    Ad2, Bd2 = c2d_zoh(A, B, t2)
    Ad12, Bd12 = c2d_zoh(A, B, t1 + t2)
    np.testing.assert_allclose(Ad12, Ad2 @ Ad1, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(
        Bd12, Ad2 @ Bd1 + Bd2, rtol=1e-8, atol=1e-9
    )


@given(
    ns=st.integers(1, 4),
    T=st.integers(1, 20),
    seed=st.integers(0, 2**31 - 1),
)
@settings(**SETTINGS)
def test_rollout_superposition(ns, T, seed):
    """LTI linearity: response to (u1 + u2) from x0 = a + b equals the
    sum of the responses minus the zero-input/zero-state overlap."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(ns, ns)) * 0.4
    B = rng.normal(size=(ns, 2))
    C = rng.normal(size=(2, ns))
    D = np.zeros((2, 2))
    W = np.zeros((T, 2))
    x1 = rng.normal(size=ns)
    x2 = rng.normal(size=ns)
    U1 = rng.normal(size=(T, 2))
    U2 = rng.normal(size=(T, 2))
    _, Y_sum = lti_rollout_np(A, B, C, D, x1 + x2, U1 + U2, W)
    _, Ya = lti_rollout_np(A, B, C, D, x1, U1, W)
    _, Yb = lti_rollout_np(A, B, C, D, x2, U2, W)
    np.testing.assert_allclose(Y_sum, Ya + Yb, rtol=1e-8, atol=1e-9)

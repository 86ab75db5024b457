"""Unit tests for Hankel construction and persistent-excitation checks.

The expected values mirror the reference's docstring examples
(hankel_matrix.py:26-37) and Definition 1 / Remark 1 semantics.
"""

import numpy as np
import pytest

from direct_data_driven_mpc_jax.ops.hankel import (
    evaluate_persistent_excitation,
    hankel_matrix,
)


def reference_hankel(X: np.ndarray, L: int) -> np.ndarray:
    """Straightforward loop construction for cross-checking."""
    N, n = X.shape
    H = np.zeros((L * n, N - L + 1))
    for i in range(N - L + 1):
        H[:, i] = X[i : i + L, :].flatten()
    return H


def test_hankel_matches_reference_docstring_example():
    rng = np.random.default_rng(0)
    u_d = rng.uniform(-1, 1, (4, 2))
    H = np.asarray(hankel_matrix(u_d, 2))
    expected = np.array(
        [
            [0.27392337, -0.91805295, 0.62654048],
            [-0.46042657, -0.96694473, 0.82551115],
            [-0.91805295, 0.62654048, 0.21327155],
            [-0.96694473, 0.82551115, 0.45899312],
        ]
    )
    np.testing.assert_allclose(H, expected, atol=1e-8)


@pytest.mark.parametrize("N,n,L", [(10, 1, 3), (12, 3, 5), (400, 2, 34)])
def test_hankel_matches_loop_construction(N, n, L, rng):
    X = rng.normal(size=(N, n))
    H = np.asarray(hankel_matrix(X, L))
    assert H.shape == (L * n, N - L + 1)
    np.testing.assert_allclose(H, reference_hankel(X, L), rtol=1e-12)


def test_hankel_rejects_short_data():
    with pytest.raises(ValueError):
        hankel_matrix(np.zeros((3, 2)), 5)


def test_persistent_excitation_random_data_passes(rng):
    # Random continuous data is persistently exciting w.p. 1 when long
    # enough (N - L + 1 >= n * order columns).
    X = rng.uniform(-1, 1, (60, 2))
    order = 8
    rank, ok = evaluate_persistent_excitation(X, order)
    assert ok
    assert rank == 2 * order


def test_persistent_excitation_constant_data_fails():
    X = np.ones((60, 2))
    rank, ok = evaluate_persistent_excitation(X, 8)
    assert not ok
    assert rank == 1


def test_persistent_excitation_float32_input_not_misranked():
    """Regression: rank-deficient data arriving as float32 (or through
    a float32 JAX pipeline) must still fail the PE check -- casting
    noise must not inflate the rank past the float64 threshold."""
    rng = np.random.default_rng(0)
    # Rank-2 input data: two independent columns replicated.
    base = rng.uniform(-1, 1, (60, 1))
    X = np.hstack([base, 2.0 * base]).astype(np.float32)  # rank 1 rows
    rank, ok = evaluate_persistent_excitation(X, 8)
    assert not ok
    assert rank < 2 * 8

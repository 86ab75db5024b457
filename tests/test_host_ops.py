"""Pin every float64 host twin in ``ops/host.py`` against its JAX
counterpart on random shapes (the twin contract promised in
ops/host.py's module docstring).

The host twins are the single source of truth for init-time math
(controller construction, QP assembly); the JAX versions run on-device.
Any drift between the two would silently desynchronize the interactive
and batched paths, so each pair is asserted equal to float64 roundoff.
"""

from __future__ import annotations

import numpy as np
import pytest

from direct_data_driven_mpc_jax.ops import host
from direct_data_driven_mpc_jax.ops.estimation import (
    calculate_equilibrium_input_from_output,
    calculate_equilibrium_output_from_input,
    dc_gain,
    estimate_initial_state,
    observability_matrix,
    toeplitz_input_output_matrix,
)
from direct_data_driven_mpc_jax.ops.hankel import (
    evaluate_persistent_excitation,
    hankel_matrix,
)
from direct_data_driven_mpc_jax.ops.lti import LTIParams, lti_rollout


def _random_stable_system(rng, ns, m, p):
    A = rng.normal(size=(ns, ns))
    A *= 0.9 / max(np.abs(np.linalg.eigvals(A)).max(), 1e-9)
    B = rng.normal(size=(ns, m))
    C = rng.normal(size=(p, ns))
    D = rng.normal(size=(p, m))
    return A, B, C, D


@pytest.mark.parametrize("N,L,n", [(20, 5, 2), (37, 11, 3), (8, 8, 1)])
def test_hankel_twin(rng, N, L, n):
    X = rng.normal(size=(N, n))
    np.testing.assert_allclose(
        host.hankel_matrix_np(X, L),
        np.asarray(hankel_matrix(X, L)),
        rtol=0,
        atol=0,
    )


def test_hankel_twin_rejects_short_data(rng):
    X = rng.normal(size=(4, 2))
    with pytest.raises(ValueError):
        host.hankel_matrix_np(X, 5)
    with pytest.raises(ValueError):
        hankel_matrix(X, 5)


@pytest.mark.parametrize("order", [2, 4])
def test_persistent_excitation_twin(rng, order):
    # Rich data: persistently exciting; constant data: not.
    rich = rng.uniform(-1, 1, size=(40, 2))
    flat = np.ones((40, 2))
    for X in (rich, flat):
        rank_np, ok_np = host.evaluate_persistent_excitation_np(X, order)
        rank_j, ok_j = evaluate_persistent_excitation(X, order)
        assert rank_np == rank_j
        assert ok_np == ok_j
    assert host.evaluate_persistent_excitation_np(rich, order)[1]
    assert not host.evaluate_persistent_excitation_np(flat, order)[1]


@pytest.mark.parametrize("ns,m,p,T", [(4, 2, 2, 25), (7, 3, 5, 12), (1, 1, 1, 6)])
def test_lti_rollout_twin(rng, ns, m, p, T):
    A, B, C, D = _random_stable_system(rng, ns, m, p)
    x0 = rng.normal(size=ns)
    U = rng.normal(size=(T, m))
    W = rng.normal(size=(T, p))
    x_np, Y_np = host.lti_rollout_np(A, B, C, D, x0, U, W)
    x_j, Y_j = lti_rollout(LTIParams(A, B, C, D), x0, U, W)
    np.testing.assert_allclose(x_np, np.asarray(x_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Y_np, np.asarray(Y_j), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("ns,p", [(3, 2), (6, 4), (1, 1)])
def test_observability_twin(rng, ns, p):
    A = rng.normal(size=(ns, ns))
    C = rng.normal(size=(p, ns))
    np.testing.assert_allclose(
        host.observability_matrix_np(A, C),
        np.asarray(observability_matrix(A, C)),
        rtol=1e-13,
        atol=1e-13,
    )


@pytest.mark.parametrize("ns,m,p,t", [(4, 2, 2, 4), (5, 3, 2, 7), (2, 1, 1, 1)])
def test_toeplitz_twin(rng, ns, m, p, t):
    A, B, C, D = _random_stable_system(rng, ns, m, p)
    np.testing.assert_allclose(
        host.toeplitz_input_output_matrix_np(A, B, C, D, t),
        np.asarray(toeplitz_input_output_matrix(A, B, C, D, t)),
        rtol=1e-13,
        atol=1e-13,
    )


def test_toeplitz_twin_rejects_nonpositive_t(rng):
    A, B, C, D = _random_stable_system(rng, 3, 2, 2)
    with pytest.raises(ValueError):
        host.toeplitz_input_output_matrix_np(A, B, C, D, 0)
    with pytest.raises(ValueError):
        toeplitz_input_output_matrix(A, B, C, D, 0)


@pytest.mark.parametrize("ns,m,p,t", [(4, 2, 2, 4), (6, 3, 4, 6)])
def test_estimate_initial_state_twin(rng, ns, m, p, t):
    A, B, C, D = _random_stable_system(rng, ns, m, p)
    # Use the real t-window observability/Toeplitz pair so the LS
    # problem is the one the estimator actually solves.
    Ot = np.vstack(
        [C @ np.linalg.matrix_power(A, i) for i in range(t)]
    )
    Tt = host.toeplitz_input_output_matrix_np(A, B, C, D, t)
    U = rng.normal(size=t * m)
    Y = rng.normal(size=t * p)
    np.testing.assert_allclose(
        host.estimate_initial_state_np(Ot, Tt, U, Y),
        np.asarray(estimate_initial_state(Ot, Tt, U, Y)),
        rtol=1e-10,
        atol=1e-10,
    )


def test_estimate_initial_state_twin_shape_errors(rng):
    Ot = rng.normal(size=(6, 3))
    Tt = rng.normal(size=(6, 4))
    with pytest.raises(ValueError):
        host.estimate_initial_state_np(Ot, Tt, rng.normal(size=4), rng.normal(size=5))
    with pytest.raises(ValueError):
        estimate_initial_state(Ot, Tt, rng.normal(size=4), rng.normal(size=5))
    with pytest.raises(ValueError):
        host.estimate_initial_state_np(Ot, Tt, rng.normal(size=3), rng.normal(size=6))
    with pytest.raises(ValueError):
        estimate_initial_state(Ot, Tt, rng.normal(size=3), rng.normal(size=6))


@pytest.mark.parametrize("ns,m,p", [(4, 2, 2), (5, 3, 3), (2, 2, 1)])
def test_dc_gain_and_equilibrium_twins(rng, ns, m, p):
    A, B, C, D = _random_stable_system(rng, ns, m, p)
    np.testing.assert_allclose(
        host.dc_gain_np(A, B, C, D),
        np.asarray(dc_gain(A, B, C, D)),
        rtol=1e-11,
        atol=1e-11,
    )
    u_eq = rng.normal(size=m)
    y_eq = rng.normal(size=p)
    np.testing.assert_allclose(
        host.equilibrium_output_from_input_np(A, B, C, D, u_eq),
        np.asarray(
            calculate_equilibrium_output_from_input(A, B, C, D, u_eq)
        ),
        rtol=1e-11,
        atol=1e-11,
    )
    np.testing.assert_allclose(
        host.equilibrium_input_from_output_np(A, B, C, D, y_eq),
        np.asarray(
            calculate_equilibrium_input_from_output(A, B, C, D, y_eq)
        ),
        rtol=1e-9,
        atol=1e-9,
    )

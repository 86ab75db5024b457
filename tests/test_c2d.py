"""ZOH discretization tests against closed-form solutions."""

import numpy as np
import pytest

from direct_data_driven_mpc_jax.models.c2d import c2d_zoh, discretize_plant


def test_scalar_integrator_closed_form():
    # dx/dt = u  ->  Ad = 1, Bd = Ts.
    Ad, Bd = c2d_zoh(np.array([[0.0]]), np.array([[1.0]]), Ts=0.1)
    assert Ad[0, 0] == pytest.approx(1.0)
    assert Bd[0, 0] == pytest.approx(0.1)


def test_first_order_lag_closed_form():
    # dx/dt = -a x + u -> Ad = e^{-a Ts}, Bd = (1 - e^{-a Ts}) / a.
    a, Ts = 2.0, 0.25
    Ad, Bd = c2d_zoh(np.array([[-a]]), np.array([[1.0]]), Ts=Ts)
    assert Ad[0, 0] == pytest.approx(np.exp(-a * Ts), rel=1e-12)
    assert Bd[0, 0] == pytest.approx((1 - np.exp(-a * Ts)) / a, rel=1e-12)


def test_double_integrator_closed_form():
    # x = [pos; vel], dx/dt = [[0,1],[0,0]] x + [0;1] u.
    Ts = 0.5
    Ad, Bd = c2d_zoh(
        np.array([[0.0, 1.0], [0.0, 0.0]]), np.array([[0.0], [1.0]]), Ts
    )
    np.testing.assert_allclose(Ad, [[1.0, Ts], [0.0, 1.0]], rtol=1e-12)
    np.testing.assert_allclose(
        Bd, [[Ts**2 / 2], [Ts]], rtol=1e-12
    )


def test_discretized_plant_simulates():
    plant = discretize_plant(
        A_c=np.array([[0.0, 1.0], [-1.0, -0.5]]),
        B_c=np.array([[0.0], [1.0]]),
        C=np.array([[1.0, 0.0]]),
        Ts=0.1,
        eps_max=0.0,
    )
    Y = plant.simulate(np.ones((50, 1)), np.zeros((50, 1)), 50)
    assert np.isfinite(Y).all()
    # Damped oscillator driven by constant input settles near DC gain.
    dc = plant.get_equilibrium_output_from_input(np.array([1.0]))
    assert abs(Y[-1, 0] - dc[0]) < 0.2


def test_invalid_sample_time():
    with pytest.raises(ValueError, match="Ts"):
        c2d_zoh(np.zeros((1, 1)), np.ones((1, 1)), Ts=0.0)

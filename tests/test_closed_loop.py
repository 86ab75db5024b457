"""Closed-loop tests: host (Algorithm 1/2, stateful) vs fused scan
engine parity, and control-quality sanity on the four-tank benchmark.

The two implementations share only the precomputed solution operators;
the loop logic is written twice (Python loop vs lax.scan), so exact
trajectory agreement for identical injected noise is a strong check of
the fused engine's semantics (solve cadence, window shifting, trimming).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.controller import (
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_jax.control.loop import closed_loop_rollout
from direct_data_driven_mpc_jax.control.operation import (
    generate_initial_input_output_data,
    randomize_initial_system_state,
    simulate_data_driven_mpc_control_loop,
)
from direct_data_driven_mpc_jax.models.lti_model import LTIModel
from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

FOUR_TANK = dict(
    A=np.array(
        [
            [0.921, 0, 0.041, 0],
            [0, 0.918, 0, 0.033],
            [0, 0, 0.924, 0],
            [0, 0, 0, 0.937],
        ]
    ),
    B=np.array([[0.017, 0.001], [0.001, 0.023], [0, 0.061], [0.072, 0]]),
    C=np.array([[1.0, 0, 0, 0], [0, 1, 0, 0]]),
    D=np.zeros((2, 2)),
    eps_max=0.002,
)


def _make_setup(
    seed=0,
    N=400,
    L=30,
    controller_type=DataDrivenMPCType.ROBUST,
    slack=SlackVarConstraintTypes.NONE,
    n_mpc_step=1,
    use_terminal=True,
):
    """Four-tank paper configuration (data_driven_mpc_example_params.yaml)."""
    rng = np.random.default_rng(seed)
    plant = LTIModel(**FOUR_TANK)
    config = {
        "u_range": (-1.0, 1.0),
        "N": N,
        "n": 4,
        "eps_max": 0.002,
        "L": L,
        "Q": 3.0 * np.eye(2 * L),
        "R": 1e-4 * np.eye(2 * L),
        "lamb_alpha": 0.1 / 0.002,
        "lamb_sigma": 1000.0,
        "c": 1.0,
        "u_s": np.array([[1.0], [1.0]]),
        "y_s": np.array([[0.65], [0.77]]),
    }
    x0 = randomize_initial_system_state(plant, config, rng)
    plant.set_state(x0)
    u_d, y_d = generate_initial_input_output_data(plant, config, rng)
    ctrl = DirectDataDrivenMPCController(
        n=4,
        m=2,
        p=2,
        u_d=u_d,
        y_d=y_d,
        L=L,
        Q=config["Q"],
        R=config["R"],
        u_s=config["u_s"],
        y_s=config["y_s"],
        eps_max=0.002,
        lamb_alpha=config["lamb_alpha"],
        lamb_sigma=config["lamb_sigma"],
        c=1.0,
        slack_var_constraint_type=slack,
        controller_type=controller_type,
        n_mpc_step=n_mpc_step,
        use_terminal_constraint=use_terminal,
    )
    return plant, ctrl, rng


def _run_both(plant, ctrl, rng, n_steps, admm_iters=None):
    """Run host loop and fused engine with identical noise; return both
    trajectories."""
    w_sys = plant.get_eps_max() * rng.uniform(
        -1.0, 1.0, (n_steps, plant.get_number_outputs())
    )
    # Snapshot initial state/windows before the host loop mutates them.
    x0 = plant.get_state().copy()
    u_past = ctrl.u_past.reshape(ctrl.n, ctrl.m).copy()
    y_past = ctrl.y_past.reshape(ctrl.n, ctrl.p).copy()

    u_host, y_host = simulate_data_driven_mpc_control_loop(
        plant, ctrl, n_steps, np_random=rng, verbose=0, w_sys=w_sys
    )

    if ctrl.slack_var_constraint_type == SlackVarConstraintTypes.CONVEX:
        solver = ctrl.admm_solver(dtype=jnp.float64)
        kwargs = {"admm_iters": admm_iters or ctrl.admm_iters}
    else:
        solver = ctrl.solution_map(dtype=jnp.float64)
        kwargs = {}
    result = closed_loop_rollout(
        plant.as_params(),
        solver,
        jnp.asarray(x0),
        jnp.asarray(u_past),
        jnp.asarray(y_past),
        jnp.asarray(w_sys),
        n_steps=n_steps,
        n_mpc_step=ctrl.n_mpc_step,
        **kwargs,
    )
    return (u_host, y_host), result


def test_fused_engine_matches_host_loop_1step():
    plant, ctrl, rng = _make_setup(n_mpc_step=1)
    (u_host, y_host), result = _run_both(plant, ctrl, rng, n_steps=40)
    np.testing.assert_allclose(np.asarray(result.u_sys), u_host, atol=1e-9)
    np.testing.assert_allclose(np.asarray(result.y_sys), y_host, atol=1e-9)
    assert bool(np.all(np.asarray(result.converged)))


def test_fused_engine_matches_host_loop_nstep_with_trim():
    # n_mpc_step=4 with n_steps=42 exercises Algorithm 2 cadence AND the
    # trailing-partial-block trimming.
    plant, ctrl, rng = _make_setup(n_mpc_step=4)
    (u_host, y_host), result = _run_both(plant, ctrl, rng, n_steps=42)
    assert result.u_sys.shape == (42, 2)
    np.testing.assert_allclose(np.asarray(result.u_sys), u_host, atol=1e-9)
    np.testing.assert_allclose(np.asarray(result.y_sys), y_host, atol=1e-9)


def test_fused_engine_matches_host_loop_nominal():
    plant, ctrl, rng = _make_setup(
        controller_type=DataDrivenMPCType.NOMINAL, n_mpc_step=1
    )
    (u_host, y_host), result = _run_both(plant, ctrl, rng, n_steps=30)
    np.testing.assert_allclose(np.asarray(result.u_sys), u_host, atol=1e-8)


def test_fused_engine_matches_host_loop_convex_admm():
    plant, ctrl, rng = _make_setup(
        slack=SlackVarConstraintTypes.CONVEX, n_mpc_step=1
    )
    (u_host, y_host), result = _run_both(plant, ctrl, rng, n_steps=25)
    # Both paths run warm-started ADMM to tight tolerance; agreement is
    # bounded by the ADMM fixed-point accuracy, not bitwise.
    np.testing.assert_allclose(np.asarray(result.u_sys), u_host, atol=1e-6)
    np.testing.assert_allclose(np.asarray(result.y_sys), y_host, atol=1e-6)


def test_closed_loop_converges_to_setpoint():
    # Control-quality check: the robust TEC scheme must settle the
    # four-tank outputs at y_s = [0.65, 0.77] (paper Fig. 2 behavior).
    plant, ctrl, rng = _make_setup(n_mpc_step=1)
    (_, y_host), result = _run_both(plant, ctrl, rng, n_steps=300)
    y_tail = np.asarray(result.y_sys)[-20:]
    err = np.abs(y_tail - np.array([0.65, 0.77])).max()
    assert err < 0.01, f"closed loop did not settle; tail error {err}"
    # Costs from successive solves must be finite and eventually small.
    costs = np.asarray(result.costs)
    assert np.isfinite(costs).all()
    assert costs[-1] < costs[0]


def test_fused_engine_float32_close_to_float64():
    # The f32 device path (bench dtype) must stay within the <1e-4
    # control-input deviation budget vs the exact f64 path.
    plant, ctrl, rng = _make_setup(n_mpc_step=1)
    n_steps = 100
    w_sys = plant.get_eps_max() * rng.uniform(-1.0, 1.0, (n_steps, 2))
    x0 = plant.get_state().copy()
    u_past = ctrl.u_past.reshape(ctrl.n, ctrl.m).copy()
    y_past = ctrl.y_past.reshape(ctrl.n, ctrl.p).copy()

    results = {}
    for dtype in (jnp.float64, jnp.float32):
        sol = ctrl.solution_map(dtype=dtype)
        results[dtype] = closed_loop_rollout(
            plant.as_params(),
            sol,
            jnp.asarray(x0, dtype=dtype),
            jnp.asarray(u_past, dtype=dtype),
            jnp.asarray(y_past, dtype=dtype),
            jnp.asarray(w_sys, dtype=dtype),
            n_steps=n_steps,
            n_mpc_step=1,
        )
    du = np.abs(
        np.asarray(results[jnp.float32].u_sys, dtype=np.float64)
        - np.asarray(results[jnp.float64].u_sys)
    ).max()
    assert du < 1e-4, f"f32 drift exceeds the north-star budget: {du}"


def test_divergence_surfaces_in_status_lanes():
    """A diverging (UCON) rollout must flag non-finite lanes instead of
    raising -- exceptions cannot abort one lane of a vmapped batch."""
    plant, ctrl, rng = _make_setup(n_mpc_step=1, use_terminal=False)
    sol = ctrl.solution_map(dtype=jnp.float32)
    W = (0.002 * rng.uniform(-1, 1, (3000, 2))).astype(np.float32)
    result = closed_loop_rollout(
        plant.as_params(),
        sol,
        plant.get_state().astype(np.float32),
        ctrl.u_past.reshape(4, 2).astype(np.float32),
        ctrl.y_past.reshape(4, 2).astype(np.float32),
        W,
        n_steps=3000,
    )
    conv = np.asarray(result.converged)
    # The unstable loop eventually overflows float32: later solves are
    # flagged, earlier ones are fine, and nothing raised.
    assert conv[0]
    assert not conv[-1]

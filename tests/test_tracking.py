"""Setpoint-parametric tracking operator (qp/solution_map.TrackingMap).

The QP is affine in the setpoints r = [u_s; y_s] (g, terminal rows) as
well as in theta, so one extended operator covers every setpoint. These
tests certify the derivation against independently-built controllers
and exercise time-varying schedules in the fused engine.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.controller import (
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_jax.control.loop import closed_loop_rollout
from direct_data_driven_mpc_jax.models.lti_model import LTIModel
from direct_data_driven_mpc_jax.qp.solution_map import (
    compute_solution_map,
    compute_tracking_map,
    optimal_cost,
    solve_u,
    solve_u_tracking,
    tracking_cost,
)
from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)


def _plant():
    return LTIModel(
        A=np.array([[0.9, 0.2], [0.0, 0.8]]),
        B=np.array([[0.0, 0.1], [1.0, 0.0]]),
        C=np.array([[1.0, 0.3]]),
        D=np.array([[0.1, 0.0]]),
        eps_max=0.002,
    )


def _controller(plant, u_s, y_s, ctype=DataDrivenMPCType.ROBUST,
                use_terminal=True, n_mpc_step=1, seed=0):
    n, m, p, N, L = 2, 2, 1, 60, 8
    rng = np.random.default_rng(seed)
    u_d = rng.uniform(-1, 1, (N, m))
    w_d = 0.002 * rng.uniform(-1, 1, (N, p))
    y_d = plant.simulate(u_d, w_d, N)
    kwargs = {}
    if ctype == DataDrivenMPCType.ROBUST:
        kwargs = dict(
            eps_max=0.002, lamb_alpha=50.0, lamb_sigma=1000.0, c=1.0
        )
    return DirectDataDrivenMPCController(
        n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(p * L), R=1e-4 * np.eye(m * L),
        u_s=np.asarray(u_s, dtype=float).reshape(-1, 1),
        y_s=np.asarray(y_s, dtype=float).reshape(-1, 1),
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=ctype, n_mpc_step=n_mpc_step, **kwargs,
    )


@pytest.mark.parametrize("ctype", [DataDrivenMPCType.ROBUST,
                                   DataDrivenMPCType.NOMINAL])
@pytest.mark.parametrize("use_terminal", [True, False])
def test_tracking_map_matches_rebuilt_controller(ctype, use_terminal):
    """u*(theta, r2) from the ONE tracking operator must equal the
    solution of a controller REBUILT from scratch with setpoints r2 --
    for several setpoints, including the baked one."""
    plant = _plant()
    u_s0 = np.array([0.5, -0.2])
    y_s0 = plant.get_equilibrium_output_from_input(u_s0)
    base = _controller(plant, u_s0, y_s0, ctype=ctype)
    if not use_terminal:
        # rebuild the spec without terminal rows via the public ctor
        base = DirectDataDrivenMPCController(
            n=2, m=2, p=1, u_d=base.u_d, y_d=base.y_d, L=base.L,
            Q=base.Q, R=base.R, u_s=base.u_s, y_s=base.y_s,
            eps_max=0.002 if ctype == DataDrivenMPCType.ROBUST else None,
            lamb_alpha=50.0 if ctype == DataDrivenMPCType.ROBUST else None,
            lamb_sigma=(
                1000.0 if ctype == DataDrivenMPCType.ROBUST else None
            ),
            c=1.0 if ctype == DataDrivenMPCType.ROBUST else None,
            slack_var_constraint_type=SlackVarConstraintTypes.NONE,
            controller_type=ctype, n_mpc_step=1,
            use_terminal_constraint=False,
        )
    tm = compute_tracking_map(base.spec, dtype=jnp.float64)

    rng = np.random.default_rng(3)
    theta = rng.uniform(-0.5, 0.5, base.spec.dims.n_theta)

    for u_s2 in (u_s0, np.array([0.1, 0.4]), np.array([-0.3, 0.2])):
        y_s2 = plant.get_equilibrium_output_from_input(u_s2)
        rebuilt = DirectDataDrivenMPCController(
            n=2, m=2, p=1, u_d=base.u_d, y_d=base.y_d, L=base.L,
            Q=base.Q, R=base.R,
            u_s=u_s2.reshape(-1, 1), y_s=y_s2.reshape(-1, 1),
            eps_max=0.002 if ctype == DataDrivenMPCType.ROBUST else None,
            lamb_alpha=50.0 if ctype == DataDrivenMPCType.ROBUST else None,
            lamb_sigma=(
                1000.0 if ctype == DataDrivenMPCType.ROBUST else None
            ),
            c=1.0 if ctype == DataDrivenMPCType.ROBUST else None,
            slack_var_constraint_type=SlackVarConstraintTypes.NONE,
            controller_type=ctype, n_mpc_step=1,
            use_terminal_constraint=use_terminal,
        )
        sm2 = compute_solution_map(rebuilt.spec, dtype=jnp.float64)
        r2 = np.concatenate([u_s2, y_s2])
        u_track = np.asarray(
            solve_u_tracking(tm, jnp.asarray(theta), jnp.asarray(r2))
        )
        u_rebuilt = np.asarray(solve_u(sm2, jnp.asarray(theta)))
        np.testing.assert_allclose(u_track, u_rebuilt, atol=1e-8)
        c_track = float(
            tracking_cost(tm, jnp.asarray(theta), jnp.asarray(r2))
        )
        c_rebuilt = float(optimal_cost(sm2, jnp.asarray(theta)))
        assert c_track == pytest.approx(c_rebuilt, rel=1e-8, abs=1e-9)


def test_tracking_map_equals_solution_map_at_baked_setpoints():
    plant = _plant()
    u_s = np.array([0.5, -0.2])
    y_s = plant.get_equilibrium_output_from_input(u_s)
    ctrl = _controller(plant, u_s, y_s)
    tm = ctrl.tracking_map(dtype=jnp.float64)
    sm = ctrl.solution_map(dtype=jnp.float64)
    r = jnp.asarray(np.concatenate([u_s, y_s]))
    rng = np.random.default_rng(0)
    for _ in range(5):
        theta = jnp.asarray(rng.uniform(-1, 1, ctrl.spec.dims.n_theta))
        np.testing.assert_allclose(
            np.asarray(solve_u_tracking(tm, theta, r)),
            np.asarray(solve_u(sm, theta)),
            atol=1e-9,
        )


def test_closed_loop_setpoint_schedule_tracks_both_references():
    """Fused rollout with a mid-run setpoint step-change: the output
    must settle near the first reference, then near the second."""
    plant = _plant()
    u_s1 = np.array([0.5, -0.2])
    y_s1 = plant.get_equilibrium_output_from_input(u_s1)
    u_s2 = np.array([-0.1, 0.4])
    y_s2 = plant.get_equilibrium_output_from_input(u_s2)
    ctrl = _controller(plant, u_s1, y_s1)
    tm = ctrl.tracking_map(dtype=jnp.float64)

    T = 120
    r1 = np.concatenate([u_s1, y_s1])
    r2 = np.concatenate([u_s2, y_s2])
    schedule = np.where(
        np.arange(T)[:, None] < T // 2, r1[None], r2[None]
    )
    W = 0.002 * np.random.default_rng(5).uniform(-1, 1, (T, 1))
    res = closed_loop_rollout(
        plant.as_params(dtype=np.float64), tm,
        jnp.zeros(2, jnp.float64),
        jnp.asarray(ctrl.u_past.reshape(2, 2)),
        jnp.asarray(ctrl.y_past.reshape(2, 1)),
        jnp.asarray(W), n_steps=T, setpoints=jnp.asarray(schedule),
    )
    y = np.asarray(res.y_sys)
    assert bool(np.all(np.asarray(res.converged)))
    # settled windows before/after the reference change
    assert np.abs(y[T // 2 - 10 : T // 2] - y_s1).max() < 0.02
    assert np.abs(y[-10:] - y_s2).max() < 0.02


def test_closed_loop_constant_schedule_matches_plain_solution_map():
    """A TrackingMap with a constant schedule must reproduce the plain
    SolutionMap rollout exactly (same trajectory), including n-step
    cadence."""
    plant = _plant()
    u_s = np.array([0.5, -0.2])
    y_s = plant.get_equilibrium_output_from_input(u_s)
    ctrl = _controller(plant, u_s, y_s, n_mpc_step=2)
    tm = ctrl.tracking_map(dtype=jnp.float64)
    sm = ctrl.solution_map(dtype=jnp.float64)
    T = 31  # trailing partial block included
    W = 0.002 * np.random.default_rng(1).uniform(-1, 1, (T, 1))
    r = jnp.asarray(np.concatenate([u_s, y_s]))
    args = (
        jnp.zeros(2, jnp.float64),
        jnp.asarray(ctrl.u_past.reshape(2, 2)),
        jnp.asarray(ctrl.y_past.reshape(2, 1)),
        jnp.asarray(W),
    )
    params = plant.as_params(dtype=np.float64)
    res_t = closed_loop_rollout(
        params, tm, *args, n_steps=T, n_mpc_step=2, setpoints=r
    )
    res_s = closed_loop_rollout(params, sm, *args, n_steps=T, n_mpc_step=2)
    np.testing.assert_allclose(
        np.asarray(res_t.u_sys), np.asarray(res_s.u_sys), atol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(res_t.costs), np.asarray(res_s.costs), atol=1e-9
    )


def test_tracking_schedule_vmaps_over_scenarios():
    """Per-scenario schedules under vmap: each lane tracks its own
    reference."""
    plant = _plant()
    u_s = np.array([0.5, -0.2])
    y_s = plant.get_equilibrium_output_from_input(u_s)
    ctrl = _controller(plant, u_s, y_s)
    tm = ctrl.tracking_map(dtype=jnp.float64)
    T, B = 80, 3
    params = plant.as_params(dtype=np.float64)

    u_targets = np.array([[0.3, 0.0], [-0.2, 0.3], [0.6, -0.4]])
    scheds = []
    for b in range(B):
        y_t = plant.get_equilibrium_output_from_input(u_targets[b])
        scheds.append(
            np.tile(np.concatenate([u_targets[b], y_t]), (T, 1))
        )
    scheds = jnp.asarray(np.stack(scheds))
    W = 0.002 * np.random.default_rng(2).uniform(-1, 1, (B, T, 1))

    def one(W_b, sched_b):
        return closed_loop_rollout(
            params, tm, jnp.zeros(2, jnp.float64),
            jnp.asarray(ctrl.u_past.reshape(2, 2)),
            jnp.asarray(ctrl.y_past.reshape(2, 1)),
            W_b, n_steps=T, setpoints=sched_b,
        )

    res = jax.vmap(one)(jnp.asarray(W), scheds)
    y = np.asarray(res.y_sys)
    for b in range(B):
        y_t = plant.get_equilibrium_output_from_input(u_targets[b])
        assert np.abs(y[b, -5:] - y_t).max() < 0.02, b


def test_tracking_requires_schedule_and_rejects_mismatch():
    plant = _plant()
    u_s = np.array([0.5, -0.2])
    y_s = plant.get_equilibrium_output_from_input(u_s)
    ctrl = _controller(plant, u_s, y_s)
    tm = ctrl.tracking_map(dtype=jnp.float64)
    sm = ctrl.solution_map(dtype=jnp.float64)
    params = plant.as_params(dtype=np.float64)
    args = (
        jnp.zeros(2, jnp.float64),
        jnp.asarray(ctrl.u_past.reshape(2, 2)),
        jnp.asarray(ctrl.y_past.reshape(2, 1)),
        jnp.zeros((10, 1), jnp.float64),
    )
    with pytest.raises(ValueError, match="setpoints"):
        closed_loop_rollout(params, tm, *args, n_steps=10)
    with pytest.raises(ValueError, match="shape"):
        closed_loop_rollout(
            params, tm, *args, n_steps=10,
            setpoints=jnp.zeros((4, 3)),
        )
    with pytest.raises(ValueError, match="TrackingMap"):
        closed_loop_rollout(
            params, sm, *args, n_steps=10, setpoints=jnp.zeros(3)
        )


def test_tracking_map_rejects_convex_slack():
    plant = _plant()
    n, m, p, N, L = 2, 2, 1, 60, 8
    rng = np.random.default_rng(0)
    u_d = rng.uniform(-1, 1, (N, m))
    w_d = 0.002 * rng.uniform(-1, 1, (N, p))
    y_d = plant.simulate(u_d, w_d, N)
    u_s = np.array([0.5, -0.2])
    y_s = plant.get_equilibrium_output_from_input(u_s)
    ctrl = DirectDataDrivenMPCController(
        n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(p * L), R=1e-4 * np.eye(m * L),
        u_s=u_s.reshape(-1, 1), y_s=y_s.reshape(-1, 1),
        eps_max=0.002, lamb_alpha=50.0, lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes.CONVEX,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
    )
    with pytest.raises(ValueError, match="slack-NONE"):
        ctrl.tracking_map()

"""Input/output box constraints via the general-box ADMM (qp/box.py).

The reference's only inequality is the CONVEX slack box; actuator
saturation and output corridors are beyond its QP formulation
entirely. Optimality here is certified the same way as for the slack
box: an ADMM fixed point satisfies the box-QP KKT conditions with
multiplier mu = rho * w."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.loop import closed_loop_rollout
from direct_data_driven_mpc_jax.qp.box import (
    box_admm_solve,
    compute_box_admm_operator_np,
    compute_box_admm_solver,
)
from direct_data_driven_mpc_jax.qp.solution_map import (
    compute_solution_map,
    solve_u,
)

from tests.test_closed_loop import _make_setup


@pytest.fixture(scope="module")
def setup():
    plant, ctrl, rng = _make_setup(n_mpc_step=1)
    theta = np.concatenate(
        [ctrl.u_past.reshape(-1), ctrl.y_past.reshape(-1)]
    )
    return plant, ctrl, rng, theta


def test_loose_bounds_match_exact_map(setup):
    """With bounds far outside the unconstrained optimum, the box ADMM
    must reproduce the exact affine solution."""
    plant, ctrl, rng, theta = setup
    solver = compute_box_admm_solver(
        ctrl.spec, u_bounds=(-100.0, 100.0), dtype=jnp.float64
    )
    u_box, cost_box, state, stats = box_admm_solve(
        solver, jnp.asarray(theta), num_iters=500
    )
    assert bool(stats.converged)
    sol = compute_solution_map(ctrl.spec, dtype=jnp.float64)
    u_exact = solve_u(sol, jnp.asarray(theta))
    np.testing.assert_allclose(
        np.asarray(u_box), np.asarray(u_exact), atol=1e-8
    )
    # The penalty ladder adapted DOWN toward the curvature-matched rung
    # (the inactive-box optimum); a fixed mid-ladder rho needs ~6400
    # iterations on this case.
    assert int(state.rho_idx) < int(solver.rhos.shape[0]) // 2


def test_active_input_bound_satisfies_kkt(setup):
    """Tight (and asymmetric) input bounds: the converged solution
    saturates, stays feasible, and satisfies stationarity +
    complementary slackness with mu = rho * w."""
    plant, ctrl, rng, theta = setup
    spec = ctrl.spec
    sol = compute_solution_map(spec, dtype=jnp.float64)
    u_free = np.asarray(solve_u(sol, jnp.asarray(theta)))
    hi = 0.5 * float(np.abs(u_free).max())  # forces saturation
    lo = -0.25 * hi  # asymmetric on purpose
    op = compute_box_admm_operator_np(spec, u_bounds=(lo, hi))
    solver = compute_box_admm_solver(
        spec, u_bounds=(lo, hi), dtype=jnp.float64
    )
    u, cost, state, stats = box_admm_solve(
        solver, jnp.asarray(theta), num_iters=3000
    )
    assert bool(stats.converged)
    u = np.asarray(u)
    assert u.max() <= hi + 1e-7 and u.min() >= lo - 1e-7
    assert u.max() > hi - 1e-9  # the bound actually binds

    # Reconstruct full z from the z-step at the fixed point and verify
    # box-QP KKT (independent of the solver's internal extraction).
    rho = float(solver.rhos[int(state.rho_idx)])  # the adapted rung
    rows = op["box_rows"]
    nbox = rows.size
    E = np.zeros((nbox, spec.nz))
    E[np.arange(nbox), rows] = 1.0
    t = np.asarray(state.s - state.w)
    K = np.zeros((spec.nz + spec.nc, spec.nz + spec.nc))
    K[: spec.nz, : spec.nz] = spec.H + rho * E.T @ E
    K[: spec.nz, spec.nz :] = spec.A.T
    K[spec.nz :, : spec.nz] = spec.A
    rhs = np.concatenate(
        [-spec.g + rho * E.T @ t, spec.b_const + spec.S @ theta]
    )
    z = np.linalg.solve(
        K + 1e-12 * np.eye(K.shape[0]), rhs
    )[: spec.nz]

    v = E @ z
    # Primal feasibility.
    assert np.abs(spec.A @ z - (spec.b_const + spec.S @ theta)).max() < 1e-7
    assert v.max() <= hi + 1e-7 and v.min() >= lo - 1e-7
    # Stationarity with the ADMM multiplier.
    mu = rho * np.asarray(state.w)
    grad = spec.H @ z + spec.g + E.T @ mu
    nu, *_ = np.linalg.lstsq(spec.A.T, -grad, rcond=None)
    assert np.abs(grad + spec.A.T @ nu).max() < 1e-6
    # Complementary slackness with correct signs (mu >= 0 at the upper
    # bound, mu <= 0 at the lower bound, 0 strictly inside).
    at_hi = v > hi - 1e-8
    at_lo = v < lo + 1e-8
    inactive = ~(at_hi | at_lo)
    assert np.abs(mu[inactive]).max(initial=0.0) < 1e-6
    assert np.all(mu[at_hi] >= -1e-8)
    assert np.all(mu[at_lo] <= 1e-8)


def test_convex_slack_box_is_preserved(setup):
    """Adding input bounds to a CONVEX-slack controller keeps the slack
    box rows in the projection."""
    from direct_data_driven_mpc_jax.qp.spec import SlackVarConstraintTypes

    plant, ctrl, rng = _make_setup(
        n_mpc_step=1, slack=SlackVarConstraintTypes.CONVEX
    )
    op = compute_box_admm_operator_np(
        ctrl.spec, u_bounds=(-5.0, 5.0)
    )
    d = ctrl.spec.dims
    # free u rows ((L-n)*m; the terminal-pinned blocks are excluded)
    # plus the full sigma prediction segment (L*p).
    n_u_rows = (d.L - d.n) * d.m
    assert op["lo"].size == n_u_rows + d.L * d.p
    assert np.all(op["hi"][n_u_rows:] == float(ctrl.spec.sigma_bound))


def test_closed_loop_respects_input_bounds(setup):
    """A full fused closed-loop rollout under tight actuator limits:
    every applied input within bounds, all solves converged, and the
    loop still tracks the setpoint."""
    plant, ctrl, rng, theta = setup
    hi = 0.85  # below the ~1.0 steady-state input: permanently active
    solver = compute_box_admm_solver(
        ctrl.spec, u_bounds=(-hi, hi), dtype=jnp.float64
    )
    T = 60
    W = jnp.asarray(0.002 * rng.uniform(-1, 1, (T, 2)))
    res = closed_loop_rollout(
        plant.as_params(), solver,
        jnp.asarray(plant.get_state()),
        jnp.asarray(ctrl.u_past.reshape(4, 2)),
        jnp.asarray(ctrl.y_past.reshape(4, 2)),
        W, n_steps=T, admm_iters=60,
    )
    u = np.asarray(res.u_sys)
    assert bool(np.all(res.converged))
    assert u.max() <= hi + 1e-6 and u.min() >= -hi - 1e-6
    assert np.abs(u).max() > hi - 1e-4  # saturation actually engaged
    # Tracking error still shrinks vs the start (saturated but stable).
    y = np.asarray(res.y_sys)
    y_s = np.array([0.65, 0.77])
    early = np.linalg.norm(y[:5] - y_s, axis=1).mean()
    late = np.linalg.norm(y[-5:] - y_s, axis=1).mean()
    assert late < early


def test_rejects_empty_and_inverted_bounds(setup):
    plant, ctrl, rng, theta = setup
    with pytest.raises(ValueError, match="no box constraints"):
        compute_box_admm_operator_np(ctrl.spec)
    with pytest.raises(ValueError, match="lower bound exceeds"):
        compute_box_admm_operator_np(ctrl.spec, u_bounds=(1.0, -1.0))


def test_controller_method_and_vmap(setup):
    """controller.box_admm_solver() + vmapped batch rollout."""
    plant, ctrl, rng, theta = setup
    solver = ctrl.box_admm_solver(
        u_bounds=(-0.9, 0.9), dtype=jnp.float32
    )
    B, T = 4, 20
    x0s = jnp.tile(jnp.asarray(plant.get_state(), jnp.float32)[None], (B, 1))
    ups = jnp.tile(
        jnp.asarray(ctrl.u_past.reshape(4, 2), jnp.float32)[None],
        (B, 1, 1),
    )
    yps = jnp.tile(
        jnp.asarray(ctrl.y_past.reshape(4, 2), jnp.float32)[None],
        (B, 1, 1),
    )
    Ws = jnp.asarray(
        0.002 * rng.uniform(-1, 1, (B, T, 2)), jnp.float32
    )
    params = plant.as_params(dtype=np.float32)

    def one(x0, up, yp, W):
        return closed_loop_rollout(
            params, solver, x0, up, yp, W, n_steps=T, admm_iters=40
        )

    res = jax.vmap(one)(x0s, ups, yps, Ws)
    assert res.u_sys.shape == (B, T, 2)
    assert float(jnp.abs(res.u_sys).max()) <= 0.9 + 1e-5

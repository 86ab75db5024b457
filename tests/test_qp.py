"""Tests for QP assembly, the exact affine solution map, and ADMM.

Correctness strategy (no CVXPY in this environment, and none needed):
for a convex QP an exact KKT point IS the global optimum, so we certify
solutions by (a) KKT residuals in float64, (b) agreement with an
INDEPENDENT null-space reduction solver implemented here with scipy.
"""

import numpy as np
import pytest
import scipy.linalg

from direct_data_driven_mpc_jax.ops.hankel import hankel_matrix
from direct_data_driven_mpc_jax.ops.lti import LTIParams, lti_rollout
from direct_data_driven_mpc_jax.qp.admm import (
    admm_solve,
    compute_admm_solver,
)
from direct_data_driven_mpc_jax.qp.assembly import build_qp_spec
from direct_data_driven_mpc_jax.qp.solution_map import (
    compute_solution_operator_np,
    compute_solution_map,
    kkt_residuals,
    optimal_cost,
    solve_full,
    solve_u,
)
from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    QPDims,
    SlackVarConstraintTypes,
)

import jax.numpy as jnp


def _small_problem(
    controller_type=DataDrivenMPCType.ROBUST,
    slack=SlackVarConstraintTypes.NONE,
    use_terminal=True,
    seed=0,
    c=1.0,
    allow_nonconvex=False,
):
    """Small SISO-ish 2nd-order problem: n=2, m=1, p=1, L=6, N=30."""
    rng = np.random.default_rng(seed)
    n, m, p, L, N = 2, 1, 1, 6, 30
    A = np.array([[0.9, 0.2], [0.0, 0.8]])
    B = np.array([[0.0], [1.0]])
    C = np.array([[1.0, 0.3]])
    D = np.array([[0.1]])
    params = LTIParams(A=A, B=B, C=C, D=D)
    u_d = rng.uniform(-1, 1, (N, m))
    w_d = 0.002 * rng.uniform(-1, 1, (N, p))
    _, y_d = lti_rollout(params, np.zeros(n), u_d, w_d)
    y_d = np.asarray(y_d)

    dims = QPDims(n=n, m=m, p=p, L=L, N=N)
    Hu = np.asarray(hankel_matrix(u_d, L + n))
    Hy = np.asarray(hankel_matrix(y_d, L + n))
    Q = 3.0 * np.eye(p * L)
    R = 1e-4 * np.eye(m * L)
    u_s = np.array([0.5])
    y_s = np.asarray(
        C @ np.linalg.solve(np.eye(n) - A, B @ u_s) + D @ u_s
    ).flatten()
    spec = build_qp_spec(
        Hu,
        Hy,
        dims,
        Q,
        R,
        u_s,
        y_s,
        controller_type=controller_type,
        eps_max=0.002,
        lamb_alpha=0.1 / 0.002,
        lamb_sigma=1000.0,
        c=c,
        slack_var_constraint_type=slack,
        use_terminal_constraint=use_terminal,
        allow_nonconvex_slack=allow_nonconvex,
    )
    theta = np.concatenate(
        [u_d[-n:].flatten(), y_d[-n:].flatten()]
    )  # the reference seeds the past window this way (ref :184-185)
    return spec, theta


def _null_space_solve(spec, theta):
    """Independent equality-QP solver: null-space reduction.

    z = z_p + Nb xi with A z_p = b, Nb = null(A); minimize the reduced
    quadratic by (pseudo)inverse of the reduced Hessian.
    """
    b = spec.b_const + spec.S @ theta
    z_p, *_ = np.linalg.lstsq(spec.A, b, rcond=None)
    Nb = scipy.linalg.null_space(spec.A)
    Hr = Nb.T @ spec.H @ Nb
    gr = Nb.T @ (spec.H @ z_p + spec.g)
    xi = -np.linalg.pinv(Hr) @ gr
    z = z_p + Nb @ xi
    cost = 0.5 * z @ spec.H @ z + spec.g @ z + spec.r0
    return z, cost


@pytest.mark.parametrize(
    "ctype,use_terminal",
    [
        (DataDrivenMPCType.ROBUST, True),
        (DataDrivenMPCType.ROBUST, False),
        (DataDrivenMPCType.NOMINAL, True),
        (DataDrivenMPCType.NOMINAL, False),
    ],
)
def test_solution_map_is_exact_kkt_point(ctype, use_terminal):
    spec, theta = _small_problem(ctype, use_terminal=use_terminal)
    sol_map = compute_solution_map(spec, dtype=jnp.float64)
    z = np.asarray(solve_full(sol_map, jnp.asarray(theta)))
    res = kkt_residuals(spec, z, theta)
    assert res["primal_inf"] < 1e-9
    assert res["stationarity_inf"] < 1e-8


@pytest.mark.parametrize(
    "ctype",
    [DataDrivenMPCType.ROBUST, DataDrivenMPCType.NOMINAL],
)
def test_solution_map_matches_null_space_solver(ctype):
    spec, theta = _small_problem(ctype)
    sol_map = compute_solution_map(spec, dtype=jnp.float64)
    u = np.asarray(solve_u(sol_map, jnp.asarray(theta)))
    cost = float(optimal_cost(sol_map, jnp.asarray(theta)))
    z_ref, cost_ref = _null_space_solve(spec, theta)
    u_ref = z_ref[spec.u_pred_slice]
    # ubar_pred is unique (R > 0 on the prediction segment) even when
    # alpha is not, so the two different algorithms must agree on it
    # (tolerance reflects pinv thresholding on the singular NOMINAL
    # reduced Hessian, not solver error -- exactness is certified by
    # the KKT-residual test above).
    np.testing.assert_allclose(u, u_ref, atol=1e-6)
    assert cost == pytest.approx(cost_ref, abs=1e-6)


def test_solution_map_affine_in_theta(rng):
    spec, theta = _small_problem()
    sol_map = compute_solution_map(spec, dtype=jnp.float64)
    t1 = jnp.asarray(theta)
    t2 = jnp.asarray(rng.normal(size=theta.shape))
    u1 = solve_u(sol_map, t1)
    u2 = solve_u(sol_map, t2)
    u_mid = solve_u(sol_map, 0.5 * (t1 + t2))
    np.testing.assert_allclose(
        np.asarray(u_mid), 0.5 * np.asarray(u1 + u2), atol=1e-10
    )


def test_cost_quadratic_matches_direct_evaluation():
    spec, theta = _small_problem()
    sol_map = compute_solution_map(spec, dtype=jnp.float64)
    z = np.asarray(solve_full(sol_map, jnp.asarray(theta)))
    direct = 0.5 * z @ spec.H @ z + spec.g @ z + spec.r0
    quad = float(optimal_cost(sol_map, jnp.asarray(theta)))
    assert quad == pytest.approx(direct, rel=1e-9, abs=1e-9)


def test_admm_matches_exact_map_when_box_inactive():
    # A huge c makes the box constraint vacuous: ADMM must agree with
    # the unconstrained exact solution map.
    spec_c, theta = _small_problem(
        slack=SlackVarConstraintTypes.CONVEX, c=1e9
    )
    spec_none, _ = _small_problem(slack=SlackVarConstraintTypes.NONE)
    solver = compute_admm_solver(spec_c, dtype=jnp.float64)
    sol_map = compute_solution_map(spec_none, dtype=jnp.float64)
    u_admm, cost_admm, _, stats = admm_solve(
        solver, jnp.asarray(theta), num_iters=200
    )
    u_exact = solve_u(sol_map, jnp.asarray(theta))
    np.testing.assert_allclose(
        np.asarray(u_admm), np.asarray(u_exact), atol=1e-6
    )
    assert bool(stats.converged)
    assert cost_admm == pytest.approx(
        float(optimal_cost(sol_map, jnp.asarray(theta))), abs=1e-6
    )


def test_admm_active_box_satisfies_kkt():
    # Make the bound tight enough to bind by shrinking c drastically.
    spec, theta = _small_problem(
        slack=SlackVarConstraintTypes.CONVEX, c=1e-4
    )
    solver = compute_admm_solver(spec, dtype=jnp.float64)
    u, cost, state, stats = admm_solve(
        solver, jnp.asarray(theta), num_iters=2000
    )
    assert bool(stats.converged)

    # Reconstruct the full z and certify box-QP optimality via KKT.
    t = np.asarray(state.s - state.w)
    # z from the same affine maps the solver uses internally: rebuild
    # the full-space map here from the spec (independent code path).
    rho = float(solver.rho)
    box = spec.sigma_pred_slice
    nbox = box.stop - box.start
    E = np.zeros((nbox, spec.nz))
    E[np.arange(nbox), np.arange(box.start, box.stop)] = 1.0
    K = np.zeros((spec.nz + spec.nc, spec.nz + spec.nc))
    K[: spec.nz, : spec.nz] = spec.H + rho * E.T @ E
    K[: spec.nz, spec.nz :] = spec.A.T
    K[spec.nz :, : spec.nz] = spec.A
    rhs = np.concatenate(
        [-spec.g + rho * E.T @ t, spec.b_const + spec.S @ theta]
    )
    z = (np.linalg.pinv(K) @ rhs)[: spec.nz]

    bound = float(solver.bound)
    sigma_pred = z[box]
    # Primal feasibility.
    assert np.abs(spec.A @ z - (spec.b_const + spec.S @ theta)).max() < 1e-7
    assert np.abs(sigma_pred).max() <= bound + 1e-7
    # The box must actually bind in this configuration.
    assert np.abs(sigma_pred).max() > bound - 1e-9
    # Stationarity with the ADMM multiplier mu = rho * w.
    mu = rho * np.asarray(state.w)
    grad = spec.H @ z + spec.g + E.T @ mu
    nu, *_ = np.linalg.lstsq(spec.A.T, -grad, rcond=None)
    assert np.abs(grad + spec.A.T @ nu).max() < 1e-6
    # Complementary slackness: mu nonzero only at the active bound, with
    # the right sign.
    inactive = np.abs(sigma_pred) < bound - 1e-8
    assert np.abs(mu[inactive]).max(initial=0.0) < 1e-6
    active = ~inactive
    assert np.all(mu[active] * np.sign(sigma_pred[active]) >= -1e-8)


def test_admm_over_relaxation_same_fixed_point_fewer_iters():
    """alpha=1.6 (the default) must converge to the SAME solution as
    plain ADMM (alpha in (0,2) leaves fixed points unchanged) in
    strictly fewer iterations on this problem; every path (numpy,
    device, native C if built) agrees."""
    from direct_data_driven_mpc_jax.qp.admm import (
        admm_solve_np,
        compute_admm_operator_np,
    )

    spec, theta = _small_problem(
        slack=SlackVarConstraintTypes.CONVEX, c=1e-4
    )

    def iters_to_tol(alpha):
        op = compute_admm_operator_np(spec, alpha=alpha)
        nbox = op["v_c"].shape[0]
        s = np.zeros(nbox)
        w = np.zeros(nbox)
        for it in range(1, 5001):
            u, cost, (s, w), (rp, rd, conv) = admm_solve_np(
                op, theta, num_iters=1, state=(s, w)
            )
            if rp <= 1e-8 and rd <= 1e-8:
                return it, u, cost
        return 5000, u, cost

    it_plain, u_plain, cost_plain = iters_to_tol(1.0)
    it_relax, u_relax, cost_relax = iters_to_tol(1.6)
    assert it_relax < it_plain, (it_relax, it_plain)
    np.testing.assert_allclose(u_relax, u_plain, atol=1e-6)
    assert cost_relax == pytest.approx(cost_plain, abs=1e-7)

    # Device path (default alpha=1.6) reaches the same fixed point.
    solver = compute_admm_solver(spec, dtype=jnp.float64)
    assert float(solver.alpha) == pytest.approx(1.6)
    u_dev, cost_dev, _, stats = admm_solve(
        solver, jnp.asarray(theta), num_iters=it_relax + 5
    )
    assert bool(stats.converged)
    np.testing.assert_allclose(np.asarray(u_dev), u_plain, atol=1e-6)

    # Native C path (if the extension built) matches the numpy path to
    # float64 rounding on the same iteration (the C kernel fuses the
    # row updates, so summation order differs at the ulp level).
    from direct_data_driven_mpc_jax import native

    if native.get_lib() is not None:
        op = compute_admm_operator_np(spec)
        nat = native.NativeADMMSolver(op)
        nbox = op["v_c"].shape[0]
        s_c, w_c = np.zeros(nbox), np.zeros(nbox)
        u_c, cost_c, iters_c, rp_c, rd_c = nat.solve(
            theta, s_c, w_c, 2000, 1e-8
        )
        u_np, cost_np, (s_np, w_np), _ = admm_solve_np(
            op, theta, num_iters=int(iters_c)
        )
        np.testing.assert_allclose(s_c, s_np, rtol=0, atol=1e-15)
        np.testing.assert_allclose(w_c, w_np, rtol=0, atol=1e-15)
        np.testing.assert_allclose(u_c, u_np, rtol=0, atol=1e-14)


def test_admm_alpha_out_of_range_rejected():
    from direct_data_driven_mpc_jax.qp.admm import (
        compute_admm_operator_np,
    )

    spec, _ = _small_problem(slack=SlackVarConstraintTypes.CONVEX)
    for bad in (0.0, 2.0, -1.0, 2.5):
        with pytest.raises(ValueError, match="alpha"):
            compute_admm_operator_np(spec, alpha=bad)


def test_non_convex_slack_raises():
    with pytest.raises(NotImplementedError):
        _small_problem(slack=SlackVarConstraintTypes.NON_CONVEX)


def test_infeasible_constraints_detected():
    """Rank-deficient + inconsistent equality constraints must be
    reported, not silently least-squares'd by the pseudoinverse."""
    spec, theta = _small_problem()
    # Append a contradictory duplicate of the first constraint row:
    # same coefficients, different right-hand side.
    A_bad = np.vstack([spec.A, spec.A[0]])
    b_bad = np.concatenate([spec.b_const, [spec.b_const[0] + 1.0]])
    S_bad = np.vstack([spec.S, spec.S[0]])
    import dataclasses

    bad = dataclasses.replace(spec, A=A_bad, b_const=b_bad, S=S_bad)
    op = compute_solution_operator_np(bad)
    assert not op["feasible"]
    assert op["primal_residual_const"] > 1e-3

    # The healthy problem certifies feasible.
    op_ok = compute_solution_operator_np(spec)
    assert op_ok["feasible"]

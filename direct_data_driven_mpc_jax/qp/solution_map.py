"""Exact affine per-step solution operator for equality-constrained QPs.

The key insight (SURVEY.md section 7.1): for the slack-``NONE``
variants (the default configuration) the per-step problem

    min_z  z^T (H/2) z + g^T z      s.t.  A z = b_const + S theta

has a KKT system ``K [z; nu] = [-g; b]`` whose matrix ``K`` is constant
over the entire closed loop -- only ``theta = [u_past; y_past]``
(n*(m+p) numbers, 16 for the four-tank benchmark) changes per step. The
reference re-canonicalizes and re-solves a generic convex program with
CVXPY every step (direct_data_driven_mpc_controller.py:389-407); here we
compute the pseudoinverse of ``K`` ONCE at init (host, float64) and the
entire per-step QP solve collapses to one affine map

    z*(theta) = z_base + Z @ theta,

i.e. a ``(nz, n_theta)`` matvec, and the optimal control input to one
``(L*m, n_theta)`` matvec. This is exact (KKT residual ~ 1e-12), not an
iterative approximation, and it vmaps trivially over scenario batches.

Why the pseudoinverse: for NOMINAL controllers the KKT matrix is
singular (alpha is unregularized and underdetermined), but the system is
consistent and every KKT point is a global minimizer of the convex QP;
``pinv`` selects the minimum-norm multiplier/alpha representative while
``ubar``/``ybar`` (and hence the applied input) are unique because R, Q
are positive definite on the prediction segment.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from direct_data_driven_mpc_jax.qp.spec import QPSpec


class SolutionMap(NamedTuple):
    """Device-resident affine solution operator (a JAX pytree).

    ``z*(theta) = z_base + Z theta``;
    ``u*(theta) = u_base + U_gain theta`` (the ubar[0, L-1] segment);
    ``cost(theta) = theta^T P theta + q . theta + r`` (the reference's
    objective value, ref :769-778).
    """

    z_base: jax.Array  # (nz,)
    Z: jax.Array  # (nz, n_theta)
    u_base: jax.Array  # (L*m,)
    U_gain: jax.Array  # (L*m, n_theta)
    cost_P: jax.Array  # (n_theta, n_theta)
    cost_q: jax.Array  # (n_theta,)
    cost_r: jax.Array  # ()


def kkt_multi_solve(K: np.ndarray, RHS: np.ndarray) -> np.ndarray:
    """Solve ``K X = RHS`` for a (possibly singular) symmetric KKT
    matrix: fast LU first, verified by residual; fall back to the
    pseudoinverse (minimum-norm KKT point) when the matrix is singular
    (NOMINAL variants) or the LU solution is untrustworthy. Keeps
    large-configuration factorization O(n^3/3) instead of a full SVD."""
    scale = max(np.abs(RHS).max(initial=0.0), 1.0)
    try:
        X = np.linalg.solve(K, RHS)
        resid = np.abs(K @ X - RHS).max(initial=0.0) / scale
        if np.isfinite(resid) and resid < 1e-8:
            return X
    except np.linalg.LinAlgError:
        pass
    return np.linalg.pinv(K) @ RHS


def compute_solution_operator_np(spec: QPSpec) -> dict:
    """Host float64 computation of the affine operator (single source of
    truth for both the numpy and the device paths)."""
    H, g, A = spec.H, spec.g, spec.A
    nz, nc = spec.nz, spec.nc

    K = np.zeros((nz + nc, nz + nc))
    K[:nz, :nz] = H
    K[:nz, nz:] = A.T
    K[nz:, :nz] = A

    RHS = np.zeros((nz + nc, 1 + spec.S.shape[1]))
    RHS[:, 0] = np.concatenate([-g, spec.b_const])
    RHS[nz:, 1:] = spec.S
    X = kkt_multi_solve(K, RHS)
    z_base = X[:nz, 0]
    Z = X[:nz, 1:]

    # Feasibility certificate: with a rank-deficient constraint matrix
    # the pseudoinverse returns a least-squares point that may VIOLATE
    # A z = b -- the equality-QP analog of CVXPY reporting
    # "infeasible" (the reference surfaces this via its failing initial
    # solve, ref :386 + :804-808). Certify that the affine operator is
    # exactly primal-feasible for every theta: the residual
    # r(theta) = (A z_base - b_const) + (A Z - S) theta must vanish
    # identically.
    scale = max(1.0, np.abs(spec.b_const).max(initial=0.0))
    res_const = float(
        np.abs(A @ z_base - spec.b_const).max(initial=0.0)
    ) / scale
    res_gain = float(np.abs(A @ Z - spec.S).max(initial=0.0))
    feasible = res_const < 1e-7 and res_gain < 1e-7

    # Objective value as an explicit quadratic in theta (evaluating the
    # reference's cost at the optimum, ref :708-716):
    #   cost(theta) = 0.5 z^T H z + g^T z + r0,  z = z_base + Z theta.
    Hz = H @ Z
    cost_P = 0.5 * Z.T @ Hz
    cost_P = 0.5 * (cost_P + cost_P.T)
    cost_q = Z.T @ (H @ z_base + g)
    cost_r = 0.5 * z_base @ H @ z_base + g @ z_base + spec.r0

    u_sl = spec.u_pred_slice
    return {
        "z_base": z_base,
        "Z": Z,
        "u_base": z_base[u_sl],
        "U_gain": Z[u_sl],
        "cost_P": cost_P,
        "cost_q": cost_q,
        "cost_r": np.float64(cost_r),
        "feasible": feasible,
        "primal_residual_const": res_const,
        "primal_residual_gain": res_gain,
    }




class TrackingMap(NamedTuple):
    """Setpoint-parametric affine solution operator (a JAX pytree).

    The QP's g-vector and terminal-constraint rows are LINEAR in the
    setpoints ``r = [u_s (m); y_s (p)]`` (assembly.py:149-185), so the
    optimum is jointly affine in ``(theta, r)`` -- with NO constant
    term, because at ``r = 0`` both g and b_const vanish:

        u*(theta, r)  = U_theta @ theta + U_r @ r
        cost(theta,r) = xi^T cost_P xi,   xi = [theta; r].

    This makes time-varying reference tracking free in the fused
    engine: the reference can only retarget by re-running its entire
    init pipeline per setpoint change
    (direct_data_driven_mpc_controller.py:945-982 re-solves from
    scratch); here a setpoint schedule is just another scan input.
    """

    U_theta: jax.Array  # (L*m, n_theta)
    U_r: jax.Array  # (L*m, m+p)
    cost_P: jax.Array  # (n_theta+m+p, n_theta+m+p)


def setpoint_channels_np(spec: QPSpec):
    """Host float64 derivation of the QP's setpoint channels: ``g(r) =
    Gamma r``, ``b_const(r) = S_r r``, ``r0(r) = r' R0 r`` for ``r =
    [u_s; y_s]`` (assembly.py:149-185 -- both g and b_const vanish at
    r = 0). Each channel is VERIFIED against the baked ``spec.g`` /
    ``spec.b_const`` / ``spec.r0`` at the spec's own setpoints -- a
    wrong derivation cannot ship silently. Returns ``(Gamma, S_r, R0,
    r_bar)``."""
    d = spec.dims
    n, m, p, L = d.n, d.m, d.p, d.L
    nz, nc = spec.nz, spec.nc
    if spec.u_s is None or spec.y_s is None:
        raise ValueError(
            "spec does not carry its baked setpoints (built by an old "
            "assembly?); the tracking operator cannot self-verify."
        )
    r_bar = np.concatenate([spec.u_s, spec.y_s])

    up, yp = spec.u_pred_slice, spec.y_pred_slice
    T_u = np.tile(np.eye(m), (L, 1))  # u_sL = T_u @ u_s
    T_y = np.tile(np.eye(p), (L, 1))

    # g(r) = Gamma @ r  (assembly: g[up] = -H[up,up] @ T_u u_s, ...)
    Gamma = np.zeros((nz, m + p))
    Gamma[up, :m] = -spec.H[up, up.start : up.stop] @ T_u
    Gamma[yp, m:] = -spec.H[yp, yp.start : yp.stop] @ T_y
    if not np.allclose(Gamma @ r_bar, spec.g, atol=1e-12):
        raise AssertionError(
            "setpoint-linearity derivation of g does not reproduce the "
            "assembled spec.g"
        )

    # b(theta, r) = S theta + S_r r (terminal rows tile the setpoints).
    S_r = np.zeros((nc, m + p))
    if spec.use_terminal_constraint:
        t0 = nc - n * (m + p)
        S_r[t0 : t0 + n * m, :m] = np.tile(np.eye(m), (n, 1))
        S_r[t0 + n * m :, m:] = np.tile(np.eye(p), (n, 1))
    if not np.allclose(S_r @ r_bar, spec.b_const, atol=1e-12):
        raise AssertionError(
            "setpoint-linearity derivation of b_const does not "
            "reproduce the assembled spec.b_const"
        )

    # r0(r) = r^T R0 r.
    R0 = np.zeros((m + p, m + p))
    R0[:m, :m] = 0.5 * T_u.T @ spec.H[up, up.start : up.stop] @ T_u
    R0[m:, m:] = 0.5 * T_y.T @ spec.H[yp, yp.start : yp.stop] @ T_y
    if not np.isclose(r_bar @ R0 @ r_bar, spec.r0, atol=1e-10):
        raise AssertionError(
            "setpoint-quadratic derivation of r0 does not reproduce "
            "the assembled spec.r0"
        )
    return Gamma, S_r, R0, r_bar


def compute_tracking_operator_np(spec: QPSpec) -> dict:
    """Host float64 derivation of the setpoint-parametric operator
    (setpoint channels via :func:`setpoint_channels_np`)."""
    d = spec.dims
    m, p = d.m, d.p
    nz, nc, nt = spec.nz, spec.nc, d.n_theta
    Gamma, S_r, R0, r_bar = setpoint_channels_np(spec)

    # One KKT multi-solve over the joint parameter xi = [theta; r].
    K = np.zeros((nz + nc, nz + nc))
    K[:nz, :nz] = spec.H
    K[:nz, nz:] = spec.A.T
    K[nz:, :nz] = spec.A
    RHS = np.zeros((nz + nc, nt + m + p))
    RHS[:nz, nt:] = -Gamma
    RHS[nz:, :nt] = spec.S
    RHS[nz:, nt:] = S_r
    Z = kkt_multi_solve(K, RHS)[:nz]

    res_gain = float(
        np.abs(spec.A @ Z - np.concatenate([spec.S, S_r], axis=1)).max(
            initial=0.0
        )
    )
    feasible = res_gain < 1e-7

    # cost(xi) = 0.5 xi' Z'HZ xi + r' Gamma' Z xi + r' R0 r.
    cost_P = 0.5 * Z.T @ (spec.H @ Z)
    C = Gamma.T @ Z  # (m+p, nt+m+p)
    cost_P[nt:, :] += 0.5 * C
    cost_P[:, nt:] += 0.5 * C.T
    cost_P[nt:, nt:] += R0
    cost_P = 0.5 * (cost_P + cost_P.T)

    u_sl = spec.u_pred_slice
    return {
        "U_theta": Z[u_sl, :nt],
        "U_r": Z[u_sl, nt:],
        "cost_P": cost_P,
        "Z": Z,
        "feasible": feasible,
        "primal_residual_gain": res_gain,
        # The spec's baked setpoints: the reference point r_bar the
        # tracking-condensed engine centers its dr channel on.
        "u_s": np.asarray(spec.u_s, np.float64),
        "y_s": np.asarray(spec.y_s, np.float64),
    }


def compute_tracking_map(spec: QPSpec, dtype=jnp.float32) -> TrackingMap:
    """Derive the setpoint-parametric operator (host float64) and move
    it on-device in ``dtype``."""
    _check_dtype_supported(dtype)
    op = compute_tracking_operator_np(spec)
    return TrackingMap(
        **{
            k: jnp.asarray(op[k], dtype=dtype)
            for k in TrackingMap._fields
        }
    )


def solve_u_tracking(
    tm: TrackingMap, theta: jax.Array, r: jax.Array
) -> jax.Array:
    """Optimal input sequence ``ubar*[0, L-1]`` at past window ``theta``
    and setpoint vector ``r = [u_s; y_s]`` (flattened, ``(L*m,)``)."""
    with jax.default_matmul_precision("highest"):
        return tm.U_theta @ theta + tm.U_r @ r


def tracking_cost(
    tm: TrackingMap, theta: jax.Array, r: jax.Array
) -> jax.Array:
    """Optimal objective value at ``(theta, r)`` (scalar)."""
    xi = jnp.concatenate([theta, r])
    with jax.default_matmul_precision("highest"):
        return xi @ (tm.cost_P @ xi)


def _check_dtype_supported(dtype) -> None:
    """Fail fast when float64 is requested without jax_enable_x64 --
    JAX would otherwise silently truncate the operator to float32 and
    parity-critical paths would degrade without notice."""
    import jax

    if jnp.dtype(dtype) == jnp.dtype("float64") and not jax.config.jax_enable_x64:
        raise ValueError(
            "float64 requested but jax_enable_x64 is off; enable it "
            "(jax.config.update('jax_enable_x64', True)) or use float32."
        )


def compute_solution_map(spec: QPSpec, dtype=jnp.float32) -> SolutionMap:
    """Factorize the constant KKT system and derive the affine operator.

    Runs once at controller construction on the host in float64; the
    returned operator is cast to ``dtype`` for the on-device hot loop.
    """
    _check_dtype_supported(dtype)
    op = compute_solution_operator_np(spec)
    return SolutionMap(
        **{
            k: jnp.asarray(op[k], dtype=dtype)
            for k in SolutionMap._fields
        }
    )


def solve_full(sol_map: SolutionMap, theta: jax.Array) -> jax.Array:
    """Full optimal decision vector ``z*(theta)`` (one matvec)."""
    with jax.default_matmul_precision("highest"):
        return sol_map.z_base + sol_map.Z @ theta


def solve_u(sol_map: SolutionMap, theta: jax.Array) -> jax.Array:
    """Optimal input sequence ``ubar*[0, L-1]`` flattened, ``(L*m,)``.

    Matmul precision is pinned: reduced-precision defaults (e.g. TF32)
    visibly drift closed-loop trajectories over hundreds of steps.
    """
    with jax.default_matmul_precision("highest"):
        return sol_map.u_base + sol_map.U_gain @ theta


def optimal_cost(sol_map: SolutionMap, theta: jax.Array) -> jax.Array:
    """Optimal objective value at ``theta`` (scalar)."""
    with jax.default_matmul_precision("highest"):
        return (
            theta @ (sol_map.cost_P @ theta)
            + sol_map.cost_q @ theta
            + sol_map.cost_r
        )


def kkt_residuals(spec: QPSpec, z: np.ndarray, theta: np.ndarray) -> dict:
    """Host-side diagnostic: stationarity/primal residuals of a solution.

    Used by the test suite to certify exactness (no CVXPY needed: an
    exact KKT point of a convex QP IS the optimum).
    """
    H, g, A = spec.H, spec.g, spec.A
    b = spec.b_const + spec.S @ theta
    primal = A @ z - b
    # Stationarity: H z + g + A^T nu = 0 for some nu -> residual is the
    # projection of (H z + g) onto null(A^T)'s complement mismatch; use
    # least-squares nu.
    grad = H @ z + g
    nu, *_ = np.linalg.lstsq(A.T, -grad, rcond=None)
    stationarity = grad + A.T @ nu
    return {
        "primal_inf": float(np.abs(primal).max(initial=0.0)),
        "stationarity_inf": float(np.abs(stationarity).max(initial=0.0)),
    }

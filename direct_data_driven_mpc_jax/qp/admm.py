"""Fixed-iteration ADMM solver for the CONVEX slack-constrained variant.

The Robust scheme with ``SlackVarConstraintTypes.CONVEX`` adds one
inequality to the otherwise equality-constrained QP (reference
direct_data_driven_mpc_controller.py:658-675, paper Remark 3):

    || sigma[0, L-1] ||_inf <= c * eps_max

i.e. a per-coordinate box on the prediction segment of sigma. We solve
it with ADMM on the splitting ``s = E z`` (E selects sigma_pred rows),
``s in Box``:

    z-step: min_z z^T(H/2)z + g^T z + (rho/2)||Ez - s + w||^2  s.t. Az=b
    relax:  v_hat = alpha * Ez + (1 - alpha) * s
    s-step: s = clip(v_hat + w, -bound, +bound)
    w-step: w += v_hat - s

``alpha`` is the standard over-relaxation parameter (convergent for any
alpha in (0, 2); fixed points are unchanged). Measured on this problem
family, alpha = 1.6 roughly HALVES iterations-to-1e-8 vs plain ADMM
(four-tank: cold 29 -> 14, warm-start max along a trajectory 29 -> 14)
and was never worse than alpha = 1 on random instances, so it is the
default. The primal residual is reported on the un-relaxed iterate
(``||Ez - s||_inf``), so convergence flags keep their exact meaning.

The z-step's KKT matrix ``[[H + rho E^T E, A^T], [A, 0]]`` is CONSTANT
(rho fixed), so it is pseudo-inverted once at init and each iteration
reduces to a ``(nbox, nbox)`` matvec in the projected space ``v = Ez``
(nbox = L*p = 60 for the four-tank benchmark) plus a clip -- exactly the
matmul+elementwise shape XLA fuses well, with no data-dependent control
flow, so the whole solve vmaps over scenario batches and scans over
time. Convergence is reported as a residual-based flag carried through
the batch (no exceptions inside vmapped code; SURVEY.md section 5).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from direct_data_driven_mpc_jax.qp.spec import QPSpec


class ADMMSolver(NamedTuple):
    """Device-resident ADMM operator (a JAX pytree).

    Reduced-space iteration maps (v = E z):
        v = v_c + V_theta theta + V_s (s - w)
    Final extraction maps:
        u    = u_c + U_theta theta + U_s (s - w)
        cost = [theta; t]^T P [theta; t] + q . [theta; t] + r,  t = s - w
    """

    v_c: jax.Array  # (nbox,)
    V_theta: jax.Array  # (nbox, n_theta)
    V_s: jax.Array  # (nbox, nbox)
    u_c: jax.Array  # (L*m,)
    U_theta: jax.Array  # (L*m, n_theta)
    U_s: jax.Array  # (L*m, nbox)
    cost_P: jax.Array  # (n_theta + nbox, n_theta + nbox)
    cost_q: jax.Array  # (n_theta + nbox,)
    cost_r: jax.Array  # ()
    bound: jax.Array  # () box half-width: c * eps_max
    rho: jax.Array  # () penalty parameter
    alpha: jax.Array  # () over-relaxation parameter, in (0, 2)


class ADMMState(NamedTuple):
    s: jax.Array  # (nbox,) box-projected copy of sigma_pred
    w: jax.Array  # (nbox,) scaled dual


class ADMMStats(NamedTuple):
    primal_residual: jax.Array  # () ||Ez - s||_inf at exit
    dual_residual: jax.Array  # () rho * ||s - s_prev||_inf at exit
    converged: jax.Array  # () bool at tolerance 1e-8


def compute_admm_operator_np(
    spec: QPSpec,
    rho: float | None = None,
    alpha: float = 1.6,
    return_alpha_maps: bool = False,
    return_setpoint_maps: bool = False,
) -> dict:
    """Host float64 pre-factorization of the ADMM z-step (single source
    of truth for both the numpy and the device paths).

    With ``return_alpha_maps=True`` the dict additionally carries the
    affine maps extracting the alpha block of the z-step solution
    (``a_c, A_theta, A_s``) -- used by the NON_CONVEX slack solver
    (qp/nonconvex.py) whose bound update needs ``||alpha||_1``.

    With ``return_setpoint_maps=True`` the dict additionally carries
    the setpoint-delta channels for kernel-speed retargeting (the
    reference re-runs its whole init pipeline per setpoint change,
    direct_data_driven_mpc_controller.py:945-982): the z-step solution
    and the objective are jointly affine/quadratic in ``(theta, t,
    dr)`` with ``dr = r - r_bar`` (both g and b_const are LINEAR in
    ``r = [u_s; y_s]``, solution_map.setpoint_channels_np), so

    - ``V_r`` / ``U_r``: dr channels of the box rows / input rows,
    - ``cost_P_ext`` / ``cost_q_ext``: the cost quadratic/linear over
      the EXTENDED feature vector ``[theta; t; dr]``. ``cost_P_ext``
      is PSD by construction: the stage cost is jointly convex in
      ``(z, r)`` (a sum of squared differences), so it factors like
      the base quadratic,
    - ``r_bar``: the spec's baked setpoints the dr channel centers on.
    """
    if spec.sigma_bound is None:
        raise ValueError(
            "ADMM solver requires a CONVEX slack constraint (sigma_bound)."
        )
    if not 0.0 < alpha < 2.0:
        raise ValueError(
            f"over-relaxation alpha must be in (0, 2), got {alpha}"
        )
    H, g, A = spec.H, spec.g, spec.A
    nz, nc = spec.nz, spec.nc
    box = spec.sigma_pred_slice
    nbox = box.stop - box.start

    if rho is None:
        # Match the curvature of the sigma block (Hessian 2*lamb_sigma)
        # so the ADMM spectral ratio is well-scaled for this family.
        rho = float(np.median(np.diag(H)[box.start : box.stop]))
        rho = max(rho, 1.0)

    E = np.zeros((nbox, nz))
    E[np.arange(nbox), np.arange(box.start, box.stop)] = 1.0

    from direct_data_driven_mpc_jax.qp.solution_map import kkt_multi_solve

    H_rho = H + rho * E.T @ E
    K = np.zeros((nz + nc, nz + nc))
    K[:nz, :nz] = H_rho
    K[:nz, nz:] = A.T
    K[nz:, :nz] = A

    n_theta = spec.S.shape[1]
    RHS = np.zeros((nz + nc, 1 + n_theta + nbox))
    RHS[:, 0] = np.concatenate([-g, spec.b_const])
    RHS[nz:, 1 : 1 + n_theta] = spec.S
    RHS[:nz, 1 + n_theta :] = rho * E.T
    X = kkt_multi_solve(K, RHS)
    z_c = X[:nz, 0]
    Z_theta = X[:nz, 1 : 1 + n_theta]
    Z_s = X[:nz, 1 + n_theta :]

    u_sl = spec.u_pred_slice

    # Cost as a quadratic in [theta; t] with t = s - w.
    Z_full = np.concatenate([Z_theta, Z_s], axis=1)
    HZ = H @ Z_full
    cost_P = 0.5 * Z_full.T @ HZ
    cost_P = 0.5 * (cost_P + cost_P.T)
    cost_q = Z_full.T @ (H @ z_c + g)
    cost_r = 0.5 * z_c @ H @ z_c + g @ z_c + spec.r0

    out_alpha = {}
    if return_alpha_maps:
        a_sl = spec.alpha_slice
        out_alpha = {
            "a_c": z_c[a_sl],
            "A_theta": Z_theta[a_sl],
            "A_s": Z_s[a_sl],
        }

    out_setpoint = {}
    if return_setpoint_maps:
        from direct_data_driven_mpc_jax.qp.solution_map import (
            setpoint_channels_np,
        )

        Gamma, S_r, R0, r_bar = setpoint_channels_np(spec)
        mp = Gamma.shape[1]
        RHS_r = np.zeros((nz + nc, mp))
        RHS_r[:nz] = -Gamma
        RHS_r[nz:] = S_r
        Z_r = kkt_multi_solve(K, RHS_r)[:nz]
        # Joint cost over zhat = [z; dr]: 0.5 zhat' Hhat zhat +
        # ghat' zhat + cost_r, with Hhat PSD (stage cost jointly convex
        # in (z, r)); compose with the affine zhat(xi_ext),
        # xi_ext = [theta; t; dr].
        Hhat = np.zeros((nz + mp, nz + mp))
        Hhat[:nz, :nz] = H
        Hhat[:nz, nz:] = Gamma
        Hhat[nz:, :nz] = Gamma.T
        Hhat[nz:, nz:] = 2.0 * R0
        ghat = np.concatenate([g, 2.0 * R0 @ r_bar])
        Zhat = np.zeros((nz + mp, n_theta + nbox + mp))
        Zhat[:nz, : n_theta + nbox] = Z_full
        Zhat[:nz, n_theta + nbox :] = Z_r
        Zhat[nz:, n_theta + nbox :] = np.eye(mp)
        zhat_c = np.concatenate([z_c, np.zeros(mp)])
        cost_P_ext = 0.5 * Zhat.T @ (Hhat @ Zhat)
        cost_P_ext = 0.5 * (cost_P_ext + cost_P_ext.T)
        cost_q_ext = Zhat.T @ (Hhat @ zhat_c + ghat)
        # Self-check: the extended quadratic restricted to dr = 0 must
        # reproduce the base maps exactly.
        nb_ = n_theta + nbox
        assert np.allclose(cost_P_ext[:nb_, :nb_], cost_P, atol=1e-10)
        assert np.allclose(cost_q_ext[:nb_], cost_q, atol=1e-10)
        out_setpoint = {
            "V_r": E @ Z_r,
            "U_r": Z_r[u_sl],
            "cost_P_ext": cost_P_ext,
            "cost_q_ext": cost_q_ext,
            "r_bar": r_bar,
        }

    return {
        **out_alpha,
        **out_setpoint,
        "v_c": E @ z_c,
        "V_theta": E @ Z_theta,
        "V_s": E @ Z_s,
        "u_c": z_c[u_sl],
        "U_theta": Z_theta[u_sl],
        "U_s": Z_s[u_sl],
        "cost_P": cost_P,
        "cost_q": cost_q,
        "cost_r": np.float64(cost_r),
        "bound": np.float64(spec.sigma_bound),
        "rho": np.float64(rho),
        "alpha": np.float64(alpha),
    }


def compute_admm_solver(
    spec: QPSpec,
    rho: float | None = None,
    alpha: float = 1.6,
    dtype=jnp.float32,
) -> ADMMSolver:
    """Pre-factorize the ADMM z-step for one problem spec and move the
    operator on-device in ``dtype``."""
    from direct_data_driven_mpc_jax.qp.solution_map import (
        _check_dtype_supported,
    )

    _check_dtype_supported(dtype)
    op = compute_admm_operator_np(spec, rho=rho, alpha=alpha)
    return ADMMSolver(
        **{k: jnp.asarray(v, dtype=dtype) for k, v in op.items()}
    )


def admm_solve_np(
    op: dict,
    theta: np.ndarray,
    num_iters: int = 100,
    state: tuple | None = None,
    tol: float = 1e-8,
) -> tuple:
    """Host float64 ADMM (same iteration as :func:`admm_solve`): the
    exact-parity path used by the interactive controller class.

    Returns ``(u, cost, (s, w), (r_prim, r_dual, converged))``.
    """
    nbox = op["v_c"].shape[0]
    s, w = state if state is not None else (np.zeros(nbox), np.zeros(nbox))
    v_theta = op["V_theta"] @ theta
    bound = float(op["bound"])
    rho = float(op["rho"])
    alpha = float(op.get("alpha", 1.0))
    r_prim = r_dual = np.inf
    for _ in range(num_iters):
        v = op["v_c"] + v_theta + op["V_s"] @ (s - w)
        v_hat = alpha * v + (1.0 - alpha) * s
        s_new = np.clip(v_hat + w, -bound, bound)
        w = w + v_hat - s_new
        r_prim = float(np.abs(v - s_new).max(initial=0.0))
        r_dual = rho * float(np.abs(s_new - s).max(initial=0.0))
        s = s_new
        if r_prim <= tol and r_dual <= tol:
            break
    t = s - w
    u = op["u_c"] + op["U_theta"] @ theta + op["U_s"] @ t
    tt = np.concatenate([theta, t])
    cost = float(tt @ op["cost_P"] @ tt + op["cost_q"] @ tt + op["cost_r"])
    converged = bool(r_prim <= tol and r_dual <= tol)
    return u, cost, (s, w), (r_prim, r_dual, converged)


def admm_solve(
    solver: ADMMSolver,
    theta: jax.Array,
    num_iters: int = 100,
    state: ADMMState | None = None,
    tol: float = 1e-8,
) -> Tuple[jax.Array, jax.Array, ADMMState, ADMMStats]:
    """Run ``num_iters`` ADMM iterations for the past window ``theta``.

    Returns ``(u_opt, cost, state, stats)`` where ``u_opt`` is the
    flattened optimal input sequence ``ubar*[0, L-1]`` and ``state`` can
    be fed back in as a warm start at the next closed-loop step (the
    optimal active set changes slowly along a trajectory).
    """
    nbox = solver.v_c.shape[0]
    dtype = solver.v_c.dtype
    if state is None:
        state = ADMMState(
            s=jnp.zeros(nbox, dtype=dtype), w=jnp.zeros(nbox, dtype=dtype)
        )

    with jax.default_matmul_precision("highest"):
        v_theta = solver.V_theta @ theta  # hoisted out of the iteration

    def body(_, carry):
        s, w, _, _ = carry
        with jax.default_matmul_precision("highest"):
            v = solver.v_c + v_theta + solver.V_s @ (s - w)
        v_hat = solver.alpha * v + (1.0 - solver.alpha) * s
        s_new = jnp.clip(v_hat + w, -solver.bound, solver.bound)
        w_new = w + v_hat - s_new
        r_prim = jnp.max(jnp.abs(v - s_new))
        r_dual = solver.rho * jnp.max(jnp.abs(s_new - s))
        return (s_new, w_new, r_prim, r_dual)

    zero = jnp.asarray(0.0, dtype=dtype)
    s, w, r_prim, r_dual = jax.lax.fori_loop(
        0, num_iters, body, (state.s, state.w, zero, zero)
    )

    t = s - w
    with jax.default_matmul_precision("highest"):
        u = solver.u_c + solver.U_theta @ theta + solver.U_s @ t
        tt = jnp.concatenate([theta, t])
        cost = (
            tt @ (solver.cost_P @ tt) + solver.cost_q @ tt + solver.cost_r
        )
    stats = ADMMStats(
        primal_residual=r_prim,
        dual_residual=r_dual,
        converged=(r_prim <= tol) & (r_dual <= tol),
    )
    return u, cost, ADMMState(s=s, w=w), stats

"""Assemble the static data-driven MPC QP from Hankel data.

Mirrors the mathematical content of the reference's constraint/cost
builders (direct_data_driven_mpc_controller.py:409-737) but emits one
static numeric spec instead of CVXPY expression graphs:

- dynamics constraint  (Eq. 3b nominal / Eq. 6a robust,  ref :506-547)
- internal-state rows  (Eq. 3c / 6b,                     ref :549-583)
- terminal rows        (Eq. 3d / 6c, optional,           ref :585-629)
- CONVEX slack box     (Remark 3,                        ref :658-675)
- stage + ridge cost   (Eq. 3 / Eq. 6,                   ref :679-722)

Assembly happens once, on the host, in float64 -- it is init-time work,
like weight initialization in a training framework. The hot loop only
ever sees the derived solution operators.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    QPDims,
    QPSpec,
    SlackVarConstraintTypes,
)


def build_qp_spec(
    HLn_ud: np.ndarray,
    HLn_yd: np.ndarray,
    dims: QPDims,
    Q: np.ndarray,
    R: np.ndarray,
    u_s: np.ndarray,
    y_s: np.ndarray,
    controller_type: DataDrivenMPCType,
    eps_max: Optional[float] = None,
    lamb_alpha: Optional[float] = None,
    lamb_sigma: Optional[float] = None,
    c: Optional[float] = None,
    slack_var_constraint_type: SlackVarConstraintTypes = (
        SlackVarConstraintTypes.NONE
    ),
    use_terminal_constraint: bool = True,
    allow_nonconvex_slack: bool = False,
) -> QPSpec:
    """Build the static QP spec for one controller configuration.

    Args:
        HLn_ud: ``((L+n)m, n_alpha)`` Hankel matrix of the input data.
        HLn_yd: ``((L+n)p, n_alpha)`` Hankel matrix of the output data.
        dims: problem dimensions.
        Q: ``(pL, pL)`` output weighting (full stacked-horizon matrix).
        R: ``(mL, mL)`` input weighting.
        u_s, y_s: setpoints, shapes ``(m,)`` / ``(p,)`` (or column
            vectors; flattened internally).
        controller_type: NOMINAL or ROBUST.
        eps_max, lamb_alpha, lamb_sigma, c: robust-scheme parameters
            (required iff ROBUST).
        slack_var_constraint_type: slack constraint kind (ROBUST only).
        use_terminal_constraint: include Eq. 3d/6c terminal rows.

    Returns:
        A fully-populated :class:`QPSpec` in float64.
    """
    n, m, p, L = dims.n, dims.m, dims.p, dims.L
    n_alpha, n_u, n_y = dims.n_alpha, dims.n_u, dims.n_y
    robust = controller_type == DataDrivenMPCType.ROBUST

    if robust and None in (eps_max, lamb_alpha, lamb_sigma, c):
        raise ValueError(
            "All robust MPC parameters (eps_max, lamb_alpha, lamb_sigma, c) "
            "must be provided for a 'ROBUST' controller."
        )
    if (
        robust
        and slack_var_constraint_type == SlackVarConstraintTypes.NON_CONVEX
        and not allow_nonconvex_slack
    ):
        # Reference parity by default (ref :666-670 raises the same).
        # This framework CAN solve the variant -- opt in with
        # allow_nonconvex_slack=True and solve via qp/nonconvex.py
        # (convex-concave fixed point over the pre-factorized ADMM).
        raise NotImplementedError(
            "Robust Data-Driven MPC with a Non-Convex slack variable "
            "constraint is not currently implemented, since it cannot "
            "be efficiently solved."
        )

    Hu = np.asarray(HLn_ud, dtype=np.float64)
    Hy = np.asarray(HLn_yd, dtype=np.float64)
    if Hu.shape != (n_u, n_alpha):
        raise ValueError(
            f"HLn_ud must have shape {(n_u, n_alpha)}; got {Hu.shape}."
        )
    if Hy.shape != (n_y, n_alpha):
        raise ValueError(
            f"HLn_yd must have shape {(n_y, n_alpha)}; got {Hy.shape}."
        )
    Q = np.asarray(Q, dtype=np.float64)
    R = np.asarray(R, dtype=np.float64)
    u_s = np.asarray(u_s, dtype=np.float64).reshape(-1)
    y_s = np.asarray(y_s, dtype=np.float64).reshape(-1)

    # --- Variable layout ------------------------------------------------
    alpha_slice = slice(0, n_alpha)
    ubar_slice = slice(n_alpha, n_alpha + n_u)
    ybar_slice = slice(n_alpha + n_u, n_alpha + n_u + n_y)
    if robust:
        sigma_slice: Optional[slice] = slice(
            n_alpha + n_u + n_y, n_alpha + n_u + n_y + n_y
        )
        nz = n_alpha + n_u + 2 * n_y
    else:
        sigma_slice = None
        nz = n_alpha + n_u + n_y

    # --- Constraint rows ------------------------------------------------
    n_dyn = n_u + n_y
    n_int = n * (m + p)
    n_term = n * (m + p) if use_terminal_constraint else 0
    nc = n_dyn + n_int + n_term

    A = np.zeros((nc, nz))
    b_const = np.zeros(nc)
    S = np.zeros((nc, dims.n_theta))

    # Dynamics (Eq. 3b / 6a): ubar = Hu alpha ; ybar (+ sigma) = Hy alpha.
    A[0:n_u, alpha_slice] = -Hu
    A[0:n_u, ubar_slice] = np.eye(n_u)
    A[n_u:n_dyn, alpha_slice] = -Hy
    A[n_u:n_dyn, ybar_slice] = np.eye(n_y)
    if robust:
        A[n_u:n_dyn, sigma_slice] = np.eye(n_y)

    # Internal state (Eq. 3c / 6b): first n blocks equal the stored past
    # window theta = [u_past (n*m); y_past (n*p)]. These are the ONLY
    # rows of b that change during closed-loop operation.
    r = n_dyn
    A[r : r + n * m, ubar_slice.start : ubar_slice.start + n * m] = np.eye(
        n * m
    )
    S[r : r + n * m, 0 : n * m] = np.eye(n * m)
    r += n * m
    A[r : r + n * p, ybar_slice.start : ybar_slice.start + n * p] = np.eye(
        n * p
    )
    S[r : r + n * p, n * m : n * m + n * p] = np.eye(n * p)
    r += n * p

    # Terminal (Eq. 3d / 6c): last n blocks equal tiled setpoints.
    if use_terminal_constraint:
        A[
            r : r + n * m,
            ubar_slice.start + L * m : ubar_slice.start + (L + n) * m,
        ] = np.eye(n * m)
        b_const[r : r + n * m] = np.tile(u_s, n)
        r += n * m
        A[
            r : r + n * p,
            ybar_slice.start + L * p : ybar_slice.start + (L + n) * p,
        ] = np.eye(n * p)
        b_const[r : r + n * p] = np.tile(y_s, n)
        r += n * p
    assert r == nc

    # --- Cost -----------------------------------------------------------
    # Reference objective (ref :708-716), NOT halved:
    #   (ubar_pred - u_sL)^T R (ubar_pred - u_sL)
    # + (ybar_pred - y_sL)^T Q (ybar_pred - y_sL)
    # + lamb_alpha * eps_max * ||alpha||^2 + lamb_sigma * ||sigma||^2
    # Stored as z^T (H/2) z + g^T z + r0 with H the full Hessian (2x the
    # weight matrices).
    H = np.zeros((nz, nz))
    g = np.zeros(nz)
    u_sL = np.tile(u_s, L)
    y_sL = np.tile(y_s, L)

    up = slice(ubar_slice.start + n * m, ubar_slice.start + (L + n) * m)
    yp = slice(ybar_slice.start + n * p, ybar_slice.start + (L + n) * p)
    Rsym = 0.5 * (R + R.T)
    Qsym = 0.5 * (Q + Q.T)
    H[up, up] = 2.0 * Rsym
    H[yp, yp] = 2.0 * Qsym
    g[up] = -2.0 * (Rsym @ u_sL)
    g[yp] = -2.0 * (Qsym @ y_sL)
    r0 = float(u_sL @ Rsym @ u_sL + y_sL @ Qsym @ y_sL)

    if robust:
        H[alpha_slice, alpha_slice] += (
            2.0 * float(lamb_alpha) * float(eps_max) * np.eye(n_alpha)
        )
        H[sigma_slice, sigma_slice] += 2.0 * float(lamb_sigma) * np.eye(n_y)

    sigma_bound: Optional[float] = None
    if robust and slack_var_constraint_type in (
        SlackVarConstraintTypes.CONVEX,
        SlackVarConstraintTypes.NON_CONVEX,
    ):
        # CONVEX (Remark 3): the box half-width itself. NON_CONVEX
        # (Eq. 6d): the base coefficient c*eps_max of the state-
        # dependent bound c*eps_max*(1 + ||alpha||_1); the solver in
        # qp/nonconvex.py scales it by (1 + ||alpha||_1) per outer
        # fixed-point iteration.
        sigma_bound = float(c) * float(eps_max)

    return QPSpec(
        dims=dims,
        controller_type=controller_type,
        slack_var_constraint_type=(
            slack_var_constraint_type
            if robust
            else SlackVarConstraintTypes.NONE
        ),
        use_terminal_constraint=use_terminal_constraint,
        H=H,
        g=g,
        r0=r0,
        A=A,
        b_const=b_const,
        S=S,
        alpha_slice=alpha_slice,
        ubar_slice=ubar_slice,
        ybar_slice=ybar_slice,
        sigma_slice=sigma_slice,
        sigma_bound=sigma_bound,
        u_s=u_s,
        y_s=y_s,
    )

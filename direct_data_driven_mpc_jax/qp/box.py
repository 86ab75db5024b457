"""General box-constrained variant: input/output/slack bounds via ADMM
with a pre-factorized adaptive penalty ladder.

Beyond reference parity: the reference supports exactly ONE inequality
(the CONVEX slack box, direct_data_driven_mpc_controller.py:658-675)
and no input or output constraints at all -- yet actuator saturation
(``u_min <= u <= u_max``) and output corridors are the bread-and-butter
constraints of practical MPC. The ADMM splitting used for the slack box
(qp/admm.py) generalizes verbatim to ANY coordinate box over rows of
z: E selects the bounded rows, the z-step's KKT matrix
``[[H + rho E^T E, A^T], [A, 0]]`` is constant per ``rho`` and
pre-factorized once, and each iteration is one ``(nbox, nbox)`` matvec
plus an asymmetric clip.

Adaptive penalty, accelerator-style: the optimal ADMM penalty depends
on the ACTIVE SET (measured on the four-tank problem: a loose box
wants rho ~ 2e-4 -- the input rows' curvature 2R -- while a saturated
box wants rho ~ 1; each is >100x slower at the other's value). A CPU
solver would refactorize when adapting rho (OSQP-style); on the
accelerator, refactorization inside a jitted scan is impossible, so the z-step is
pre-factorized for a GEOMETRIC LADDER of penalties at construction
(host float64, one KKT solve per rung) and the device solver
residual-balances BETWEEN rungs every ``chunk`` iterations: if the
primal residual dominates, step the ladder up (and rescale the scaled
dual ``w`` by rho_old/rho_new -- the unscaled multiplier is invariant);
if the dual residual dominates, step down. The ladder index is part of
the warm-start state, so a closed-loop trajectory settles onto the
right rung and stays there.

Optimality is certified exactly as for the slack box: an ADMM fixed
point satisfies the box-QP KKT conditions with multiplier
``mu = rho * w`` (stationarity + complementary slackness asserted in
tests/test_box_constraints.py) -- and the fixed point is the same on
every rung.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from direct_data_driven_mpc_jax.qp.admm import ADMMStats
from direct_data_driven_mpc_jax.qp.spec import QPSpec


class BoxADMMSolver(NamedTuple):
    """Device-resident general-box ADMM operator (a JAX pytree).

    All operator fields are stacked over the ``R`` rungs of the penalty
    ladder (leading axis R; R=1 when a fixed ``rho`` was requested).
    Reduced-space iteration maps at rung ``i``:
        v    = v_c[i] + V_theta[i] theta + V_s[i] (s - w)
        u    = u_c[i] + U_theta[i] theta + U_s[i] (s - w)
        cost = [theta; t]^T P [theta; t] + q . [theta; t] + r.
    (The cost maps are evaluated at the rung's own z-step extraction;
    at a fixed point every rung agrees.)
    """

    v_c: jax.Array  # (R, nbox)
    V_theta: jax.Array  # (R, nbox, n_theta)
    V_s: jax.Array  # (R, nbox, nbox)
    u_c: jax.Array  # (R, L*m)
    U_theta: jax.Array  # (R, L*m, n_theta)
    U_s: jax.Array  # (R, L*m, nbox)
    cost_P: jax.Array  # (R, n_theta + nbox, n_theta + nbox)
    cost_q: jax.Array  # (R, n_theta + nbox)
    cost_r: jax.Array  # (R,)
    lo: jax.Array  # (nbox,) lower bounds
    hi: jax.Array  # (nbox,) upper bounds
    u_lo: jax.Array  # (L*m,) input-row bounds in u coordinates
    u_hi: jax.Array  # (L*m,) (+-inf where the input is unboxed):
    # extraction clips u to these, so the APPLIED input respects the
    # hard actuator box even when a capped solve exits unconverged
    rhos: jax.Array  # (R,) the penalty ladder (geometric)
    alpha: jax.Array  # () over-relaxation parameter, in (0, 2)


class BoxADMMState(NamedTuple):
    s: jax.Array  # (nbox,) box-projected copy of the bounded rows
    w: jax.Array  # (nbox,) scaled dual
    rho_idx: jax.Array  # () int32 current ladder rung (warm-started)


def _channel_bounds(bounds, width: int, L: int, name: str):
    """Tile per-channel ``(lo, hi)`` over an ``L``-step segment.
    Accepts scalars or length-``width`` arrays; None means unbounded on
    that side (+-inf)."""
    lo, hi = bounds
    lo = -np.inf if lo is None else np.asarray(lo, dtype=np.float64)
    hi = np.inf if hi is None else np.asarray(hi, dtype=np.float64)
    lo = np.broadcast_to(np.atleast_1d(lo), (width,))
    hi = np.broadcast_to(np.atleast_1d(hi), (width,))
    if np.any(lo > hi):
        raise ValueError(f"{name}: lower bound exceeds upper bound.")
    return np.tile(lo, L), np.tile(hi, L)


def _box_rows_and_bounds(
    spec: QPSpec, u_bounds, y_bounds, include_slack_box: bool
):
    d = spec.dims
    rows = []
    lo_parts, hi_parts = [], []
    # With the terminal constraint active the LAST n prediction blocks
    # are equality-pinned to the tiled setpoint (assembly.py:155-168);
    # boxing them too would make any bound tighter than the setpoint
    # INFEASIBLE (box vs equality conflict). The box therefore covers
    # the free prediction steps k = 0 .. L-n-1 in that case -- the
    # applied inputs (the first n_mpc_step of each solve) always lie in
    # the boxed segment.
    n_pin = d.n if spec.use_terminal_constraint else 0
    if u_bounds is not None:
        sl = spec.u_pred_slice
        rows.append(np.arange(sl.start, sl.stop - n_pin * d.m))
        lo, hi = _channel_bounds(u_bounds, d.m, d.L - n_pin, "u_bounds")
        lo_parts.append(lo)
        hi_parts.append(hi)
    if y_bounds is not None:
        sl = spec.y_pred_slice
        rows.append(np.arange(sl.start, sl.stop - n_pin * d.p))
        lo, hi = _channel_bounds(y_bounds, d.p, d.L - n_pin, "y_bounds")
        lo_parts.append(lo)
        hi_parts.append(hi)
    if include_slack_box and spec.sigma_bound is not None:
        sl = spec.sigma_pred_slice
        rows.append(np.arange(sl.start, sl.stop))
        b = float(spec.sigma_bound)
        lo_parts.append(np.full(sl.stop - sl.start, -b))
        hi_parts.append(np.full(sl.stop - sl.start, b))
    if not rows:
        raise ValueError(
            "no box constraints given: pass u_bounds and/or y_bounds "
            "(or use a CONVEX-slack spec)."
        )
    # Input bounds in u-output coordinates (ubar[0, L-1]): +-inf where
    # unboxed. Used to clip the extracted u so the applied input
    # respects the hard box even from a capped, unconverged solve.
    u_lo = np.full(d.L * d.m, -np.inf)
    u_hi = np.full(d.L * d.m, np.inf)
    if u_bounds is not None:
        k = (d.L - n_pin) * d.m
        u_lo[:k], u_hi[:k] = lo_parts[0], hi_parts[0]
    return (
        np.concatenate(rows),
        np.concatenate(lo_parts),
        np.concatenate(hi_parts),
        u_lo,
        u_hi,
    )


def compute_box_admm_operator_np(
    spec: QPSpec,
    u_bounds: Optional[Tuple] = None,
    y_bounds: Optional[Tuple] = None,
    include_slack_box: bool = True,
    rho: Optional[float] = None,
    n_ladder: int = 7,
    ladder_step: float = 10.0,
    alpha: float = 1.6,
) -> dict:
    """Host float64 pre-factorization of the general-box z-step over
    the penalty ladder.

    Args:
        spec: assembled QP spec (any controller/slack variant).
        u_bounds: optional ``(u_min, u_max)`` -- scalars or per-channel
            ``(m,)`` arrays -- applied to the free predicted inputs.
        y_bounds: optional ``(y_min, y_max)`` for the free predicted
            outputs.
        include_slack_box: keep the spec's CONVEX slack box (if any)
            as additional rows of the same projection.
        rho: fix the penalty to this value (single-rung ladder, no
            adaptation). Default None builds the geometric ladder
            ``median_curvature * ladder_step**i, i = 0..n_ladder-1``.
        n_ladder, ladder_step: ladder geometry (ignored when ``rho``
            given).
        alpha: over-relaxation (defaults to the measured 1.6 of
            qp/admm.py).
    """
    if not 0.0 < alpha < 2.0:
        raise ValueError(
            f"over-relaxation alpha must be in (0, 2), got {alpha}"
        )
    from direct_data_driven_mpc_jax.qp.spec import SlackVarConstraintTypes

    if (
        spec.slack_var_constraint_type
        == SlackVarConstraintTypes.NON_CONVEX
    ):
        # The NON_CONVEX spec's sigma_bound is only the BASE coefficient
        # of the state-dependent Eq. 6d bound c*eps_max*(1+||alpha||_1);
        # boxing sigma at that constant would silently over-constrain.
        raise ValueError(
            "box constraints with the NON_CONVEX slack variant are not "
            "supported (its slack bound is state-dependent; see "
            "qp/nonconvex.py)."
        )
    rows, lo, hi, u_lo, u_hi = _box_rows_and_bounds(
        spec, u_bounds, y_bounds, include_slack_box
    )
    nbox = rows.size
    H, g, A = spec.H, spec.g, spec.A
    nz, nc = spec.nz, spec.nc

    if rho is not None:
        rhos = np.array([float(rho)])
    else:
        # Ladder base: the bounded rows' own curvature (the measured
        # optimum when the box is INACTIVE); higher rungs serve active
        # sets (measured optimum ~1 for the saturated four-tank input
        # box vs base 2e-4 -- a single scalar cannot serve both, see
        # module docstring).
        diag = np.diag(H)[rows]
        pos = diag[diag > 0]
        base = float(np.median(pos)) if pos.size else 1.0
        rhos = base * ladder_step ** np.arange(n_ladder)

    E = np.zeros((nbox, nz))
    E[np.arange(nbox), rows] = 1.0

    from direct_data_driven_mpc_jax.qp.solution_map import kkt_multi_solve

    n_theta = spec.S.shape[1]
    u_sl = spec.u_pred_slice
    stacked = {
        k: []
        for k in (
            "v_c", "V_theta", "V_s", "u_c", "U_theta", "U_s",
            "cost_P", "cost_q", "cost_r",
        )
    }
    for rho_i in rhos:
        K = np.zeros((nz + nc, nz + nc))
        K[:nz, :nz] = H + rho_i * E.T @ E
        K[:nz, nz:] = A.T
        K[nz:, :nz] = A
        RHS = np.zeros((nz + nc, 1 + n_theta + nbox))
        RHS[:, 0] = np.concatenate([-g, spec.b_const])
        RHS[nz:, 1 : 1 + n_theta] = spec.S
        RHS[:nz, 1 + n_theta :] = rho_i * E.T
        X = kkt_multi_solve(K, RHS)
        z_c = X[:nz, 0]
        Z_theta = X[:nz, 1 : 1 + n_theta]
        Z_s = X[:nz, 1 + n_theta :]
        Z_full = np.concatenate([Z_theta, Z_s], axis=1)
        HZ = H @ Z_full
        cost_P = 0.5 * Z_full.T @ HZ
        cost_P = 0.5 * (cost_P + cost_P.T)
        stacked["v_c"].append(E @ z_c)
        stacked["V_theta"].append(E @ Z_theta)
        stacked["V_s"].append(E @ Z_s)
        stacked["u_c"].append(z_c[u_sl])
        stacked["U_theta"].append(Z_theta[u_sl])
        stacked["U_s"].append(Z_s[u_sl])
        stacked["cost_P"].append(cost_P)
        stacked["cost_q"].append(Z_full.T @ (H @ z_c + g))
        stacked["cost_r"].append(
            0.5 * z_c @ H @ z_c + g @ z_c + spec.r0
        )

    return {
        **{k: np.stack(v) for k, v in stacked.items()},
        "lo": lo,
        "hi": hi,
        "u_lo": u_lo,
        "u_hi": u_hi,
        "rhos": rhos,
        "alpha": np.float64(alpha),
        "box_rows": rows,  # host-side diagnostic (not a solver field)
    }


def compute_box_admm_solver(
    spec: QPSpec,
    u_bounds: Optional[Tuple] = None,
    y_bounds: Optional[Tuple] = None,
    include_slack_box: bool = True,
    rho: Optional[float] = None,
    n_ladder: int = 7,
    ladder_step: float = 10.0,
    alpha: float = 1.6,
    dtype=jnp.float32,
) -> BoxADMMSolver:
    """Pre-factorize the general-box z-step ladder and move the
    operator on-device in ``dtype``."""
    from direct_data_driven_mpc_jax.qp.solution_map import (
        _check_dtype_supported,
    )

    _check_dtype_supported(dtype)
    op = compute_box_admm_operator_np(
        spec, u_bounds=u_bounds, y_bounds=y_bounds,
        include_slack_box=include_slack_box, rho=rho,
        n_ladder=n_ladder, ladder_step=ladder_step, alpha=alpha,
    )
    return BoxADMMSolver(
        **{
            k: jnp.asarray(op[k], dtype=dtype)
            for k in BoxADMMSolver._fields
        }
    )


def box_initial_state(solver: BoxADMMSolver) -> BoxADMMState:
    """Cold-start state: zeros, ladder started at the middle rung (the
    residual balancer reaches any rung within ~R/2 chunks)."""
    nbox = solver.v_c.shape[1]
    dtype = solver.v_c.dtype
    R = solver.rhos.shape[0]
    return BoxADMMState(
        s=jnp.zeros(nbox, dtype=dtype),
        w=jnp.zeros(nbox, dtype=dtype),
        rho_idx=jnp.asarray(R // 2, jnp.int32),
    )


def box_admm_solve(
    solver: BoxADMMSolver,
    theta: jax.Array,
    num_iters: int = 100,
    state: Optional[BoxADMMState] = None,
    tol: float = 1e-8,
    chunk: int = 10,
    balance_ratio: float = 10.0,
) -> Tuple[jax.Array, jax.Array, BoxADMMState, ADMMStats]:
    """Run up to ``num_iters`` over-relaxed ADMM iterations (early exit
    on convergence) for the past window ``theta``, residual-balancing
    the penalty rung every ``chunk`` iterations.

    Same result contract as
    :func:`~direct_data_driven_mpc_jax.qp.admm.admm_solve`; the
    returned :class:`BoxADMMState` (including the adapted rung) warm-
    starts the next closed-loop solve.
    """
    dtype = solver.v_c.dtype
    R = solver.rhos.shape[0]
    if state is None:
        state = box_initial_state(solver)
    # Single-rung fast path (fixed rho): static operator indexing keeps
    # the iteration a SHARED-weight matvec under vmap. With R > 1 the
    # per-lane rung index turns the matvec into a per-lane batched
    # matmul in vmapped Monte-Carlo use -- measurably slower at large
    # B; prefer a fixed rho there (the saturated closed loop lives on
    # one rung anyway) and keep the ladder for interactive/generic use.
    static_rung = R == 1

    inf = jnp.asarray(jnp.inf, dtype=dtype)

    def chunk_body(carry):
        s, w, idx, it, _, _ = carry
        op_i = 0 if static_rung else idx
        with jax.default_matmul_precision("highest"):
            # Only the active rung's theta map (the full-ladder matvec
            # would do R x the work per solve in the closed-loop scan).
            vc = solver.v_c[op_i] + solver.V_theta[op_i] @ theta
        Vs = solver.V_s[op_i]
        rho = solver.rhos[op_i]

        def body(_, c):
            s, w, _, _ = c
            with jax.default_matmul_precision("highest"):
                v = vc + Vs @ (s - w)
            v_hat = solver.alpha * v + (1.0 - solver.alpha) * s
            s_new = jnp.clip(v_hat + w, solver.lo, solver.hi)
            w_new = w + v_hat - s_new
            r_prim = jnp.max(jnp.abs(v - s_new))
            r_dual = rho * jnp.max(jnp.abs(s_new - s))
            return (s_new, w_new, r_prim, r_dual)

        zero = jnp.asarray(0.0, dtype=dtype)
        s, w, r_prim, r_dual = jax.lax.fori_loop(
            0, chunk, body, (s, w, zero, zero)
        )
        # OSQP-style RELATIVE residual balancing between pre-factorized
        # rungs (raw residual ratios are scale-blind: with an inactive
        # box the dual variable is exactly zero and the raw dual
        # residual says nothing). Primal scales by the iterate
        # magnitude, dual by the unscaled multiplier |y| = rho*|w|. The
        # scaled dual rescales by rho_old/rho_new on a rung change (y
        # is rho-invariant).
        if static_rung:
            return (s, w, idx, it + chunk, r_prim, r_dual)
        tiny = jnp.asarray(1e-12, dtype=dtype)
        r_p_rel = r_prim / jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(s)), jnp.max(jnp.abs(w))), tiny
        )
        r_d_rel = r_dual / jnp.maximum(
            rho * jnp.max(jnp.abs(w)), tiny
        )
        up = (r_p_rel > balance_ratio * r_d_rel) & (idx < R - 1)
        down = (r_d_rel > balance_ratio * r_p_rel) & (idx > 0)
        new_idx = idx + up.astype(jnp.int32) - down.astype(jnp.int32)
        w = w * (solver.rhos[idx] / solver.rhos[new_idx]).astype(dtype)
        return (s, w, new_idx, it + chunk, r_prim, r_dual)

    def cond(carry):
        _, _, _, it, r_prim, r_dual = carry
        return (it < num_iters) & ((r_prim > tol) | (r_dual > tol))

    s, w, idx, _, r_prim, r_dual = jax.lax.while_loop(
        cond, chunk_body, (state.s, state.w, state.rho_idx, 0, inf, inf)
    )

    t = s - w
    with jax.default_matmul_precision("highest"):
        u = solver.u_c[idx] + solver.U_theta[idx] @ theta + (
            solver.U_s[idx] @ t
        )
        # Hard-feasibility projection: if a capped solve exits before
        # convergence, the raw z-step iterate's bounded input rows can
        # overshoot by up to the primal residual -- never command an
        # input outside the actuator box.
        u = jnp.clip(u, solver.u_lo, solver.u_hi)
        tt = jnp.concatenate([theta, t])
        cost = (
            tt @ (solver.cost_P[idx] @ tt)
            + solver.cost_q[idx] @ tt
            + solver.cost_r[idx]
        )
    stats = ADMMStats(
        primal_residual=r_prim,
        dual_residual=r_dual,
        converged=(r_prim <= tol) & (r_dual <= tol),
    )
    return u, cost, BoxADMMState(s=s, w=w, rho_idx=idx), stats

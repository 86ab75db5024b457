"""Solver for the NON_CONVEX slack-constrained Robust variant (Eq. 6d).

The paper's robust scheme admits three slack-variable constraints with
the same theoretical guarantees (reference
direct_data_driven_mpc_controller.py:640-670). The NON_CONVEX one is
the paper's Equation (6d): the slack bound scales with the size of the
Hankel combination coefficients,

    || sigma[0, L-1] ||_inf  <=  c * eps_max * (1 + ||alpha||_1),

which couples two decision variables and makes the feasible set
non-convex. The reference raises ``NotImplementedError`` for it
("cannot be efficiently solved", ref :666-670). This framework solves
it -- a capability the reference lacks -- with a convex-concave
fixed-point (sequential convexification) that stays batched and
branch-free on the accelerator:

    bound_0 = c * eps_max                     (the CONVEX box, Remark 3)
    repeat:  solve the box QP  ||sigma_pred||_inf <= bound_k  by the
             pre-factorized over-relaxed ADMM (qp/admm.py),
             bound_{k+1} = c * eps_max * (1 + ||alpha_k||_1)

Every outer iteration reuses the SAME pre-factorized z-step operator --
the bound enters only the ADMM clip, so no refactorization, no
data-dependent shapes, and the whole solve is a fixed-trip-count
``fori_loop`` of matmul+clip iterations: jittable, vmappable over
scenario batches, scannable over closed-loop time. Because every
bound_k >= c*eps_max, each outer iterate's feasible box CONTAINS the
CONVEX variant's box, so the returned objective never exceeds the
CONVEX solution's (asserted in tests/test_nonconvex.py).

Convergence is reported as status lanes (no exceptions in vmapped
code): ``converged`` requires the inner ADMM residuals at tolerance,
the bound fixed point stationary, and the final iterate feasible for
the original non-convex constraint. The fixed point is a local
(KKT/stationary) solution of the non-convex program -- the standard
guarantee for convex-concave procedures.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from direct_data_driven_mpc_jax.qp.admm import (
    ADMMSolver,
    ADMMState,
    admm_solve,
    admm_solve_np,
    compute_admm_operator_np,
)
from direct_data_driven_mpc_jax.qp.spec import (
    QPSpec,
    SlackVarConstraintTypes,
)


class NonConvexADMMSolver(NamedTuple):
    """Device-resident operator for the Eq. 6d variant (a JAX pytree).

    ``base`` is the pre-factorized box-QP ADMM operator (its ``bound``
    leaf holds the base coefficient ``c*eps_max`` and is replaced by
    the current outer bound each iteration). ``a_c/A_theta/A_s`` extract
    the alpha block of the z-step solution: alpha = a_c + A_theta theta
    + A_s (s - w).
    """

    base: ADMMSolver
    a_c: jax.Array  # (n_alpha,)
    A_theta: jax.Array  # (n_alpha, n_theta)
    A_s: jax.Array  # (n_alpha, nbox)
    c_eps: jax.Array  # () base coefficient c * eps_max


class NonConvexState(NamedTuple):
    """Warm-start state carried across closed-loop steps."""

    s: jax.Array  # (nbox,)
    w: jax.Array  # (nbox,)
    bound: jax.Array  # () current outer bound


class NonConvexStats(NamedTuple):
    primal_residual: jax.Array  # () inner ADMM ||Ez - s||_inf at exit
    dual_residual: jax.Array  # () inner ADMM dual residual at exit
    bound_delta: jax.Array  # () relative bound change at exit
    constraint_violation: jax.Array  # () max(0, ||sigma_pred||_inf -
    # c*eps_max*(1 + ||alpha||_1))
    bound: jax.Array  # () final bound c*eps_max*(1 + ||alpha||_1)
    converged: jax.Array  # () bool


def _check_spec(spec: QPSpec) -> None:
    if spec.slack_var_constraint_type != SlackVarConstraintTypes.NON_CONVEX:
        raise ValueError(
            "nonconvex solver requires a spec built with "
            "slack_var_constraint_type=NON_CONVEX "
            "(and allow_nonconvex_slack=True)."
        )
    if spec.sigma_bound is None:
        raise ValueError("spec is missing the base bound c * eps_max.")


def compute_nonconvex_operator_np(
    spec: QPSpec, rho: float | None = None, alpha: float = 1.6
) -> dict:
    """Host float64 operator: the box-QP ADMM operator plus the alpha
    extraction maps and the base coefficient ``c_eps``."""
    _check_spec(spec)
    op = compute_admm_operator_np(
        spec, rho=rho, alpha=alpha, return_alpha_maps=True
    )
    op["c_eps"] = np.float64(spec.sigma_bound)
    return op


def compute_nonconvex_admm_solver(
    spec: QPSpec,
    rho: float | None = None,
    alpha: float = 1.6,
    dtype=jnp.float32,
) -> NonConvexADMMSolver:
    """Pre-factorize once (host f64) and move on-device in ``dtype``."""
    from direct_data_driven_mpc_jax.qp.solution_map import (
        _check_dtype_supported,
    )

    _check_dtype_supported(dtype)
    op = compute_nonconvex_operator_np(spec, rho=rho, alpha=alpha)
    cvt = lambda k: jnp.asarray(op[k], dtype=dtype)  # noqa: E731
    base = ADMMSolver(
        **{
            k: cvt(k)
            for k in ADMMSolver._fields
        }
    )
    return NonConvexADMMSolver(
        base=base,
        a_c=cvt("a_c"),
        A_theta=cvt("A_theta"),
        A_s=cvt("A_s"),
        c_eps=cvt("c_eps"),
    )


def nonconvex_initial_state(
    solver: NonConvexADMMSolver,
) -> NonConvexState:
    """Cold start: zeroed ADMM state, bound at the CONVEX box (the
    tightest bound any iterate can have, since ||alpha||_1 >= 0)."""
    nbox = solver.base.v_c.shape[0]
    dtype = solver.base.v_c.dtype
    return NonConvexState(
        s=jnp.zeros(nbox, dtype=dtype),
        w=jnp.zeros(nbox, dtype=dtype),
        bound=jnp.asarray(solver.c_eps, dtype=dtype),
    )


def nonconvex_admm_solve(
    solver: NonConvexADMMSolver,
    theta: jax.Array,
    outer_iters: int = 8,
    inner_iters: int = 30,
    state: Optional[NonConvexState] = None,
    tol: float = 1e-8,
    outer_tol: float = 1e-6,
) -> Tuple[jax.Array, jax.Array, NonConvexState, NonConvexStats]:
    """Solve the Eq. 6d program at past window ``theta``.

    Fixed trip counts (``outer_iters`` x ``inner_iters``) so the solve
    vmaps/scans; ``state`` warm-starts both the ADMM multipliers and the
    outer bound from the previous closed-loop step (the fixed point
    moves slowly along a trajectory, so warm outer loops converge in
    1-2 iterations).

    Returns ``(u_opt, cost, state, stats)`` with ``u_opt`` the
    flattened optimal input sequence ``ubar*[0, L-1]``.
    """
    base = solver.base
    dtype = base.v_c.dtype
    if state is None:
        state = nonconvex_initial_state(solver)

    with jax.default_matmul_precision("highest"):
        a_theta = solver.A_theta @ theta  # hoisted out of the outer loop
    one = jnp.asarray(1.0, dtype=dtype)
    zero = jnp.asarray(0.0, dtype=dtype)

    def body(_, carry):
        s, w, bound, _, _, _, _ = carry
        _, _, st, stats = admm_solve(
            base._replace(bound=bound),
            theta,
            num_iters=inner_iters,
            state=ADMMState(s=s, w=w),
            tol=tol,
        )
        t = st.s - st.w
        with jax.default_matmul_precision("highest"):
            alpha_vec = solver.a_c + a_theta + solver.A_s @ t
        bound_new = solver.c_eps * (one + jnp.sum(jnp.abs(alpha_vec)))
        delta = jnp.abs(bound_new - bound) / (solver.c_eps + bound_new)
        return (
            st.s,
            st.w,
            bound_new,
            delta,
            stats.primal_residual,
            stats.dual_residual,
            stats.converged,
        )

    s, w, bound, delta, r_prim, r_dual, inner_conv = jax.lax.fori_loop(
        0,
        outer_iters,
        body,
        (
            state.s,
            state.w,
            state.bound,
            jnp.asarray(jnp.inf, dtype=dtype),
            zero,
            zero,
            jnp.bool_(False),
        ),
    )

    t = s - w
    with jax.default_matmul_precision("highest"):
        u = base.u_c + base.U_theta @ theta + base.U_s @ t
        v = base.v_c + base.V_theta @ theta + base.V_s @ t
        tt = jnp.concatenate([theta, t])
        cost = (
            tt @ (base.cost_P @ tt) + base.cost_q @ tt + base.cost_r
        )
    # Final-iterate feasibility for the ORIGINAL non-convex constraint
    # (sigma_pred = v at the solved z; bound already reflects the final
    # alpha). Scaled slack so an f32 solve is judged at f32 resolution.
    viol = jnp.maximum(jnp.max(jnp.abs(v)) - bound, zero)
    feas_tol = jnp.asarray(
        10.0 * float(jnp.finfo(dtype).eps), dtype=dtype
    ) * (one + bound)
    converged = (
        inner_conv
        & (delta <= jnp.asarray(outer_tol, dtype=dtype))
        & (viol <= jnp.maximum(jnp.asarray(tol, dtype=dtype), feas_tol))
    )
    stats = NonConvexStats(
        primal_residual=r_prim,
        dual_residual=r_dual,
        bound_delta=delta,
        constraint_violation=viol,
        bound=bound,
        converged=converged,
    )
    return u, cost, NonConvexState(s=s, w=w, bound=bound), stats


def nonconvex_admm_solve_np(
    op: dict,
    theta: np.ndarray,
    outer_iters: int = 20,
    inner_iters: int = 100,
    state: tuple | None = None,
    tol: float = 1e-10,
    outer_tol: float = 1e-9,
) -> tuple:
    """Host float64 twin of :func:`nonconvex_admm_solve` (early exit on
    a stationary bound): the exact-parity path used by the interactive
    controller class.

    Returns ``(u, cost, (s, w, bound), (r_prim, r_dual, delta, viol,
    bound, converged))``.
    """
    nbox = op["v_c"].shape[0]
    c_eps = float(op["c_eps"])
    if state is not None:
        s, w, bound = state
    else:
        s, w, bound = np.zeros(nbox), np.zeros(nbox), c_eps
    a_theta = op["A_theta"] @ theta
    r_prim = r_dual = delta = np.inf
    op_k = dict(op)
    for _ in range(outer_iters):
        op_k["bound"] = bound
        _, _, (s, w), (r_prim, r_dual, _) = admm_solve_np(
            op_k, theta, num_iters=inner_iters, state=(s, w), tol=tol
        )
        t = s - w
        alpha_vec = op["a_c"] + a_theta + op["A_s"] @ t
        bound_new = c_eps * (1.0 + float(np.abs(alpha_vec).sum()))
        delta = abs(bound_new - bound) / (c_eps + bound_new)
        bound = bound_new
        if delta <= outer_tol and r_prim <= tol and r_dual <= tol:
            break
    t = s - w
    u = op["u_c"] + op["U_theta"] @ theta + op["U_s"] @ t
    v = op["v_c"] + op["V_theta"] @ theta + op["V_s"] @ t
    tt = np.concatenate([theta, t])
    cost = float(tt @ op["cost_P"] @ tt + op["cost_q"] @ tt + op["cost_r"])
    viol = max(float(np.abs(v).max(initial=0.0)) - bound, 0.0)
    converged = bool(
        r_prim <= tol and r_dual <= tol and delta <= outer_tol
        and viol <= max(tol, 1e-12 * (1.0 + bound))
    )
    return (
        u,
        cost,
        (s, w, bound),
        (r_prim, r_dual, delta, viol, bound, converged),
    )

"""Fused closed-loop MPC engine: one ``lax.scan`` per rollout.

Implements the paper's Algorithm 1 (1-step) and Algorithm 2 (n-step)
closed-loop schemes with the same semantics as the reference's Python
hot loop (``utilities/controller/controller_operation.py:201-331``):

    every n_mpc_step steps:
        solve the QP from the past window theta = [u_past; y_past]
        for k in 0..n_mpc_step-1:
            apply ubar*[k]; step the plant; shift the window

but fully fused on-device: the outer loop over solve blocks and the
inner loop over applied inputs are nested ``lax.scan``s, the QP solve
is the precomputed affine map (slack NONE) or fixed-iteration ADMM
(CONVEX), and the whole rollout is jittable, differentiable, and
``vmap``-able over a scenario axis. Per-step Python/CVXPY overhead --
the reference's dominant cost (SURVEY.md section 3.3) -- is zero.

Trailing partial blocks (n_steps not divisible by n_mpc_step) follow
the reference: the loop runs ``ceil`` blocks and outputs are trimmed to
``n_steps`` (the reference's inner loop stops at ``min(t+n_mpc_step,
n_steps)``; trimmed steps here never influence returned data because
the window updates they produce are discarded with them).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp

from direct_data_driven_mpc_jax.ops.lti import LTIParams, lti_step
from direct_data_driven_mpc_jax.qp.admm import (
    ADMMSolver,
    ADMMState,
    admm_solve,
)
from direct_data_driven_mpc_jax.qp.solution_map import (
    SolutionMap,
    TrackingMap,
    optimal_cost,
    solve_u,
    solve_u_tracking,
    tracking_cost,
)


class ClosedLoopResult(NamedTuple):
    """Outputs of one closed-loop rollout (arrays lead with time)."""

    u_sys: jax.Array  # (n_steps, m) applied inputs
    y_sys: jax.Array  # (n_steps, p) measured outputs
    costs: jax.Array  # (n_blocks,) optimal QP cost per solve
    converged: jax.Array  # (n_blocks,) solver convergence lane (bool)
    x_final: jax.Array  # (ns,) final plant state (pre-trim semantics)
    u_past: jax.Array  # (n, m) final past-input window
    y_past: jax.Array  # (n, p) final past-output window
    solver_state: Optional[ADMMState] = None  # final iterative-solver
    # warm-start state (ADMM (s, w); None for exact affine solvers) --
    # feed back via solver_state0 so a segmented run is trajectory-
    # identical to an uninterrupted one


SolveFn = Callable[[jax.Array, Optional[ADMMState]],
                   Tuple[jax.Array, jax.Array, Optional[ADMMState],
                         jax.Array]]


def make_solve_fn(
    solver: Union[SolutionMap, ADMMSolver],
    m: int,
    admm_iters: int = 100,
    admm_tol: float = 1e-6,
) -> Tuple[SolveFn, Optional[ADMMState]]:
    """Wrap a solver into ``(u_seq(L, m), cost, state, converged)``.

    Returns the solve function plus the initial solver state (None for
    the exact affine map; a zeroed ADMM state, warm-started across
    closed-loop steps, for the CONVEX variant).
    """
    if isinstance(solver, SolutionMap):

        def solve(theta, state):
            u_seq = solve_u(solver, theta).reshape(-1, m)
            cost = optimal_cost(solver, theta)
            # The affine map is an exact KKT solution: "optimal" unless
            # numerics blew up (tracked as a finiteness lane).
            ok = jnp.all(jnp.isfinite(u_seq)) & jnp.isfinite(cost)
            return u_seq, cost, state, ok

        return solve, None

    if isinstance(solver, ADMMSolver):
        nbox = solver.v_c.shape[0]
        dtype = solver.v_c.dtype
        init_state = ADMMState(
            s=jnp.zeros(nbox, dtype=dtype), w=jnp.zeros(nbox, dtype=dtype)
        )

        def solve(theta, state):
            u, cost, new_state, stats = admm_solve(
                solver, theta, num_iters=admm_iters, state=state,
                tol=admm_tol,
            )
            return u.reshape(-1, m), cost, new_state, stats.converged

        return solve, init_state

    from direct_data_driven_mpc_jax.qp.box import (
        BoxADMMSolver,
        box_admm_solve,
        box_initial_state,
    )

    if isinstance(solver, BoxADMMSolver):
        # General input/output/slack boxes (qp/box.py): warm-started
        # splitting like the CONVEX-slack ADMM, plus the adapted
        # penalty-ladder rung carried across closed-loop steps.
        init_state = box_initial_state(solver)

        def solve(theta, state):
            u, cost, new_state, stats = box_admm_solve(
                solver, theta, num_iters=admm_iters, state=state,
                tol=admm_tol,
            )
            return u.reshape(-1, m), cost, new_state, stats.converged

        return solve, init_state

    from direct_data_driven_mpc_jax.qp.nonconvex import (
        NonConvexADMMSolver,
        nonconvex_admm_solve,
        nonconvex_initial_state,
    )

    if isinstance(solver, NonConvexADMMSolver):
        # Paper Eq. 6d variant: warm-started convex-concave fixed point
        # (outer bound + inner ADMM state both carried across steps).
        init_nc = nonconvex_initial_state(solver)

        def solve(theta, state):
            # 4 outer iterations: warm-started along a trajectory the
            # bound fixed point is stationary after 1-2 (cold start is
            # only the first solve; tests/test_nonconvex.py measures
            # the margin).
            u, cost, new_state, stats = nonconvex_admm_solve(
                solver, theta,
                outer_iters=4,
                inner_iters=admm_iters,
                state=state, tol=admm_tol,
            )
            return u.reshape(-1, m), cost, new_state, stats.converged

        return solve, init_nc

    if isinstance(solver, tuple) and len(solver) == 2 and callable(solver[0]):
        # Escape hatch for custom solve functions (e.g. mesh-sharded
        # gain application in parallel/mesh.py): (solve_fn, init_state).
        return solver

    raise TypeError(f"Unsupported solver type: {type(solver)!r}")


def closed_loop_rollout(
    plant: LTIParams,
    solver: Union[SolutionMap, ADMMSolver, TrackingMap],
    x0: jax.Array,
    u_past: jax.Array,
    y_past: jax.Array,
    W: jax.Array,
    n_steps: int,
    n_mpc_step: int = 1,
    admm_iters: int = 100,
    solver_state0: Optional[ADMMState] = None,
    setpoints: Optional[jax.Array] = None,
) -> ClosedLoopResult:
    """Run the closed loop for ``n_steps`` with noise sequence ``W``.

    Args:
        plant: LTI plant matrices (the simulated "real" system).
        solver: per-step QP solver operator. A
           :class:`~direct_data_driven_mpc_jax.qp.solution_map.TrackingMap`
           additionally takes a per-solve setpoint schedule (below),
           enabling time-varying reference tracking with zero re-init.
        x0: ``(ns,)`` initial plant state.
        u_past: ``(n, m)`` past-input window seeding theta.
        y_past: ``(n, p)`` past-output window.
        W: ``(n_steps, p)`` measurement noise (injectable for parity
           tests, reference pre-draws it at controller_operation.py:263).
        n_steps: closed-loop length (static).
        n_mpc_step: inputs applied per solve (Algorithm 2), static.
        admm_iters: ADMM iterations per solve (CONVEX variant only).
        solver_state0: initial iterative-solver warm-start state; pass
           a previous segment's ``result.solver_state`` to make
           segmented ADMM runs trajectory-identical to uninterrupted
           ones (defaults to the solver's cold start).
        setpoints: TrackingMap only -- ``r = [u_s; y_s]`` per solve:
           either a constant ``(m+p,)`` vector or a ``(n_blocks, m+p)``
           schedule where row ``i`` applies to solve block ``i``
           (``n_blocks = ceil(n_steps / n_mpc_step)``).

    Returns:
        :class:`ClosedLoopResult`.
    """
    m = u_past.shape[1]
    p = y_past.shape[1]
    dtype = jnp.asarray(u_past).dtype
    # Keep every carried array in one dtype (mixed f64 constants would
    # otherwise promote the f32 hot path).
    plant = LTIParams(
        *(jnp.asarray(a, dtype=dtype) for a in plant)
    )

    n_blocks = math.ceil(n_steps / n_mpc_step)

    tracking = isinstance(solver, TrackingMap)
    if tracking:
        if setpoints is None:
            raise ValueError(
                "a TrackingMap solver requires a `setpoints` schedule "
                "(constant (m+p,) or per-solve (n_blocks, m+p))"
            )
        R = jnp.asarray(setpoints, dtype=dtype)
        if R.ndim == 1:
            R = jnp.tile(R[None], (n_blocks, 1))
        if R.shape != (n_blocks, m + p):
            raise ValueError(
                f"setpoints must have shape ({m + p},) or "
                f"({n_blocks}, {m + p}); got {R.shape}"
            )

        def solve_fn_tracking(theta, r):
            u_seq = solve_u_tracking(solver, theta, r).reshape(-1, m)
            cost = tracking_cost(solver, theta, r)
            ok = jnp.all(jnp.isfinite(u_seq)) & jnp.isfinite(cost)
            return u_seq, cost, ok

        solver_state0 = None
    else:
        if setpoints is not None:
            raise ValueError(
                "`setpoints` schedules require a TrackingMap solver "
                "(controller.tracking_map())"
            )
        R = jnp.zeros((n_blocks, 0), dtype=dtype)  # inert scan input
        solve_fn, default_state0 = make_solve_fn(
            solver, m, admm_iters=admm_iters
        )
        if solver_state0 is None:
            solver_state0 = default_state0

    pad = n_blocks * n_mpc_step - n_steps
    W_pad = jnp.concatenate(
        [jnp.asarray(W, dtype=dtype),
         jnp.zeros((pad, p), dtype=dtype)],
        axis=0,
    ).reshape(n_blocks, n_mpc_step, p)

    def block_step(carry, xs):
        w_block, r_block = xs
        x, up, yp, sstate = carry
        theta = jnp.concatenate([up.reshape(-1), yp.reshape(-1)])
        if tracking:
            u_seq, cost, ok = solve_fn_tracking(theta, r_block)
        else:
            u_seq, cost, sstate, ok = solve_fn(theta, sstate)

        def inner(carry2, kw):
            x, up, yp = carry2
            k, w = kw
            u_k = u_seq[k]
            x, y = lti_step(plant, x, u_k, w)
            up = jnp.concatenate([up[1:], u_k[None]], axis=0)
            yp = jnp.concatenate([yp[1:], y[None]], axis=0)
            return (x, up, yp), (u_k, y)

        ks = jnp.arange(n_mpc_step)
        (x, up, yp), (u_blk, y_blk) = jax.lax.scan(
            inner, (x, up, yp), (ks, w_block)
        )
        return (x, up, yp, sstate), (u_blk, y_blk, cost, ok)

    carry0 = (
        jnp.asarray(x0, dtype=dtype),
        jnp.asarray(u_past, dtype=dtype),
        jnp.asarray(y_past, dtype=dtype),
        solver_state0,
    )
    (x, up, yp, sstate_fin), (u_blocks, y_blocks, costs, oks) = (
        jax.lax.scan(block_step, carry0, (W_pad, R))
    )

    u_sys = u_blocks.reshape(n_blocks * n_mpc_step, m)[:n_steps]
    y_sys = y_blocks.reshape(n_blocks * n_mpc_step, p)[:n_steps]
    return ClosedLoopResult(
        u_sys=u_sys,
        y_sys=y_sys,
        costs=costs,
        converged=oks,
        x_final=x,
        u_past=up,
        y_past=yp,
        solver_state=sstate_fin,
    )


def build_closed_loop(
    plant: LTIParams,
    solver: Union[SolutionMap, ADMMSolver, TrackingMap],
    n_steps: int,
    n_mpc_step: int = 1,
    admm_iters: int = 100,
    setpoints: Optional[jax.Array] = None,
) -> Callable[[jax.Array, jax.Array, jax.Array, jax.Array],
              ClosedLoopResult]:
    """Return a jitted rollout ``(x0, u_past, y_past, W) -> result``.

    The returned function is the single-scenario building block; wrap
    it in ``jax.vmap`` for Monte-Carlo scenario batches and in
    ``shard_map`` over a mesh for multi-chip scaling (see
    ``parallel/``). ``setpoints`` (TrackingMap solvers) is closed over
    as a static schedule; for per-scenario schedules call
    ``closed_loop_rollout`` under ``vmap`` directly.
    """

    def run(x0, u_past, y_past, W):
        return closed_loop_rollout(
            plant, solver, x0, u_past, y_past, W,
            n_steps=n_steps, n_mpc_step=n_mpc_step, admm_iters=admm_iters,
            setpoints=setpoints,
        )

    return jax.jit(run)

"""Monte-Carlo scenario batching of the closed loop via ``vmap``.

The reference simulates exactly one scenario per run with a shared
NumPy RNG (controller_operation.py:263). Here the scenario axis (noise
seeds, initial states, past windows) is a leading batch dimension: the
entire closed loop vmaps because it is pure (SURVEY.md section 7,
BASELINE.json config 4: 4096 scenarios on one host). Per-scenario
determinism comes from threefry key splitting -- scenario i's noise
depends only on (key, i), independent of batch size or device layout.
"""

from __future__ import annotations

from typing import Callable, Union

import jax
import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.loop import (
    ClosedLoopResult,
    closed_loop_rollout,
)
from direct_data_driven_mpc_jax.ops.lti import LTIParams
from direct_data_driven_mpc_jax.qp.admm import ADMMSolver
from direct_data_driven_mpc_jax.qp.solution_map import SolutionMap


def draw_noise_batch(
    key: jax.Array,
    batch: int,
    n_steps: int,
    p: int,
    eps_max: float,
    dtype=jnp.float32,
) -> jax.Array:
    """Bounded uniform measurement noise ``(batch, n_steps, p)`` in
    ``eps_max * [-1, 1]`` with one threefry fold per scenario.

    Scenario ``i``'s noise depends only on ``(key, i)``: growing or
    repartitioning the batch never changes an existing scenario's draw
    (the host-count-invariance contract of
    ``parallel/multihost.py::global_scenario_keys``).
    """

    def one(i):
        return jax.random.uniform(
            jax.random.fold_in(key, i),
            (n_steps, p),
            minval=-1.0,
            maxval=1.0,
            dtype=dtype,
        )

    return eps_max * jax.vmap(one)(jnp.arange(batch))


def batched_closed_loop(
    plant: LTIParams,
    solver: Union[SolutionMap, ADMMSolver, tuple],
    x0s: jax.Array,  # (B, ns)
    u_pasts: jax.Array,  # (B, n, m)
    y_pasts: jax.Array,  # (B, n, p)
    Ws: jax.Array,  # (B, n_steps, p)
    n_steps: int,
    n_mpc_step: int = 1,
    admm_iters: int = 100,
    solver_state0=None,
) -> ClosedLoopResult:
    """All scenarios share one solver operator (same Hankel data); the
    per-scenario state (x0, windows, noise) is batched.

    ``solver_state0``: optional batched iterative-solver warm start
    (leading scenario axis), e.g. a previous segment's
    ``result.solver_state``.
    """

    if solver_state0 is None:

        def one(x0, up, yp, W):
            return closed_loop_rollout(
                plant, solver, x0, up, yp, W,
                n_steps=n_steps, n_mpc_step=n_mpc_step,
                admm_iters=admm_iters,
            )

        return jax.vmap(one)(x0s, u_pasts, y_pasts, Ws)

    def one(x0, up, yp, W, ss):
        return closed_loop_rollout(
            plant, solver, x0, up, yp, W,
            n_steps=n_steps, n_mpc_step=n_mpc_step,
            admm_iters=admm_iters, solver_state0=ss,
        )

    return jax.vmap(one)(x0s, u_pasts, y_pasts, Ws, solver_state0)


def make_batched_rollout(
    plant: LTIParams,
    solver: Union[SolutionMap, ADMMSolver, tuple],
    n_steps: int,
    n_mpc_step: int = 1,
    admm_iters: int = 100,
) -> Callable[..., ClosedLoopResult]:
    """Jitted ``(x0s, u_pasts, y_pasts, Ws) -> ClosedLoopResult``."""

    def run(x0s, u_pasts, y_pasts, Ws):
        return batched_closed_loop(
            plant, solver, x0s, u_pasts, y_pasts, Ws,
            n_steps=n_steps, n_mpc_step=n_mpc_step, admm_iters=admm_iters,
        )

    return jax.jit(run)


def stack_solution_maps(sol_maps) -> SolutionMap:
    """Stack per-realization solution operators into one batched pytree
    (leading scenario axis) for :func:`heterogeneous_closed_loop`."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *sol_maps)


def stack_plants(plants) -> LTIParams:
    """Stack per-scenario plant matrices (leading scenario axis)."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *plants)


def heterogeneous_closed_loop(
    plants: LTIParams,
    solvers: Union[SolutionMap, ADMMSolver],
    x0s: jax.Array,
    u_pasts: jax.Array,
    y_pasts: jax.Array,
    Ws: jax.Array,
    n_steps: int,
    n_mpc_step: int = 1,
    admm_iters: int = 100,
) -> ClosedLoopResult:
    """Scenario batch where EVERY axis varies per scenario.

    The reference's single-scenario design fixes the plant and the data
    realization per run; BASELINE config 4's Monte-Carlo axis spans
    noise seeds, DATA REALIZATIONS (different Hankel data -> different
    solution operators) and PLANT PERTURBATIONS. Here all three vmap:
    ``plants`` and ``solvers`` carry a leading scenario axis. Build the
    stacked operators with
    ``qp.batch_build.build_batched_solution_operators`` +
    ``stacked_solution_map`` (one batched Schur factorization, ~5 ms
    per realization at paper scale) rather than a serial host loop.
    """

    def one(plant_i, solver_i, x0, up, yp, W):
        return closed_loop_rollout(
            plant_i, solver_i, x0, up, yp, W,
            n_steps=n_steps, n_mpc_step=n_mpc_step,
            admm_iters=admm_iters,
        )

    return jax.vmap(one)(plants, solvers, x0s, u_pasts, y_pasts, Ws)

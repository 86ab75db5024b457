"""Device-mesh sharding of the scenario batch via ``shard_map``.

Scaling design (SURVEY.md section 5, BASELINE.json config 5): the
scenario axis is embarrassingly parallel, so it shards over the
``data`` mesh axis with zero communication in the hot loop; only
aggregate metrics are reduced with ``psum``. An optional ``model`` axis
row-shards the solution operator's gain matrix -- each device computes
its slice of the optimal input sequence and an ``all_gather``
reassembles it. For the
four-tank problem that matrix is tiny (60 x 16) and model parallelism
is pure overhead, but the same spec scales the L=60/N=800 and
10-in/10-out configurations where the gain matmul grows quadratically.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from direct_data_driven_mpc_jax.control.loop import ClosedLoopResult
from direct_data_driven_mpc_jax.ops.lti import LTIParams
from direct_data_driven_mpc_jax.parallel.batch import batched_closed_loop
from direct_data_driven_mpc_jax.qp.admm import ADMMSolver, ADMMState
from direct_data_driven_mpc_jax.qp.box import BoxADMMSolver, BoxADMMState
from direct_data_driven_mpc_jax.qp.solution_map import SolutionMap


def make_scenario_mesh(
    n_data: Optional[int] = None, n_model: int = 1
) -> Mesh:
    """Build a ``(data, model)`` mesh over the available devices."""
    devices = jax.devices()
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data * n_model > len(devices):
        raise ValueError(
            f"Mesh {n_data}x{n_model} exceeds {len(devices)} devices."
        )
    dev_array = np.array(devices[: n_data * n_model]).reshape(
        n_data, n_model
    )
    return Mesh(dev_array, axis_names=("data", "model"))


def _row_shard_solution_map(
    sol_map: SolutionMap, n_model: int
) -> SolutionMap:
    """Pad the u-gain rows to a multiple of ``n_model`` so they split
    evenly over the model axis (padding rows produce zeros that are
    dropped after the gather)."""
    rows = sol_map.u_base.shape[0]
    pad = (-rows) % n_model
    if pad == 0:
        return sol_map
    return sol_map._replace(
        u_base=jnp.pad(sol_map.u_base, (0, pad)),
        U_gain=jnp.pad(sol_map.U_gain, ((0, pad), (0, 0))),
    )


def make_mesh_rollout(
    mesh: Mesh,
    plant: LTIParams,
    solver: Union[SolutionMap, ADMMSolver],
    n_steps: int,
    n_mpc_step: int = 1,
    admm_iters: int = 100,
    model_parallel: bool = False,
):
    """Jitted mesh-sharded batched rollout.

    Returns ``run(x0s, u_pasts, y_pasts, Ws) -> (ClosedLoopResult,
    metrics)`` where the scenario arrays are sharded over the ``data``
    axis, the result's per-scenario arrays come back sharded the same
    way, and ``metrics`` holds psum-reduced aggregates:
    ``mean_final_cost``, ``frac_converged`` (global scalars, replicated).

    With ``model_parallel=True`` (requires a SolutionMap solver), the
    affine gain application is row-sharded over the ``model`` axis and
    reassembled per solve with an ``all_gather``.
    """
    n_data = mesh.shape["data"]
    n_model = mesh.shape["model"]
    m = plant.B.shape[1]
    use_mp = model_parallel and n_model > 1
    if model_parallel and not isinstance(solver, SolutionMap):
        raise ValueError(
            "model_parallel gain sharding requires a SolutionMap solver."
        )

    if use_mp:
        u_rows = solver.u_base.shape[0]  # BEFORE padding: the gather
        # must drop the zero padding rows, not keep them
        solver = _row_shard_solution_map(solver, n_model)
        solver_specs = SolutionMap(
            z_base=P(),
            Z=P(),
            u_base=P("model"),
            U_gain=P("model", None),
            cost_P=P(),
            cost_q=P(),
            cost_r=P(),
        )
    else:
        solver_specs = jax.tree.map(lambda _: P(), solver)

    in_specs = (
        solver_specs,
        P("data"),  # x0s
        P("data"),  # u_pasts
        P("data"),  # y_pasts
        P("data"),  # Ws
    )
    result_specs = ClosedLoopResult(
        u_sys=P("data"),
        y_sys=P("data"),
        costs=P("data"),
        converged=P("data"),
        x_final=P("data"),
        u_past=P("data"),
        y_past=P("data"),
        # Iterative solvers return a per-scenario warm-start state; the
        # exact affine paths return None (an empty subtree).
        solver_state=(
            ADMMState(s=P("data"), w=P("data"))
            if isinstance(solver, ADMMSolver)
            else BoxADMMState(
                s=P("data"), w=P("data"), rho_idx=P("data")
            )
            if isinstance(solver, BoxADMMSolver)
            else None
        ),
    )
    out_specs = (result_specs, {"mean_final_cost": P(),
                                "frac_converged": P()})

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    def sharded(solver_local, x0s, u_pasts, y_pasts, Ws):
        if use_mp:
            # Each model-shard computes its rows of u; all_gather
            # reassembles the full (L*m,) sequence, then the plant
            # stepping runs replicated across the model axis.
            def solve(theta, state):
                with jax.default_matmul_precision("highest"):
                    u_part = (
                        solver_local.u_base + solver_local.U_gain @ theta
                    )
                    cost = (
                        theta @ (solver_local.cost_P @ theta)
                        + solver_local.cost_q @ theta
                        + solver_local.cost_r
                    )
                u_full = jax.lax.all_gather(
                    u_part, "model", tiled=True
                )[:u_rows]
                ok = jnp.all(jnp.isfinite(u_full)) & jnp.isfinite(cost)
                return u_full.reshape(-1, m), cost, state, ok

            local_solver = (solve, None)
        else:
            local_solver = solver_local

        result = batched_closed_loop(
            plant,
            local_solver,
            x0s,
            u_pasts,
            y_pasts,
            Ws,
            n_steps=n_steps,
            n_mpc_step=n_mpc_step,
            admm_iters=admm_iters,
        )
        # Aggregate metrics: reduce over local batch, then psum over
        # the data axis (the only collective in the data-parallel path).
        local_b = result.costs.shape[0]
        sum_cost = jnp.sum(result.costs[:, -1])
        sum_conv = jnp.sum(result.converged.astype(jnp.float32))
        n_solves = jnp.asarray(
            result.converged.size, dtype=jnp.float32
        )
        tot_b = jax.lax.psum(jnp.float32(local_b), "data")
        tot_cost = jax.lax.psum(sum_cost, "data")
        tot_conv = jax.lax.psum(sum_conv, "data")
        tot_solves = jax.lax.psum(n_solves, "data")
        metrics = {
            "mean_final_cost": tot_cost / tot_b,
            "frac_converged": tot_conv / tot_solves,
        }
        return result, metrics

    def run(x0s, u_pasts, y_pasts, Ws):
        return sharded(solver, x0s, u_pasts, y_pasts, Ws)

    return jax.jit(run)


def make_sharded_fused_rollout(
    mesh: Mesh,
    block_map,
    n_steps: int,
    n_mpc_step: int = 1,
    cost_precision: str = "high",
):
    """Fused-operator rollout (ops/fused_rollout.py) data-parallel over
    the mesh via ``shard_map``: each device runs the fused scan on its
    local scenario shard, zero collectives in the hot loop, one
    ``psum`` pair for the aggregate metrics. Returns
    ``run(x0s, u_pasts, y_pasts, Ws) -> (ClosedLoopResult, metrics)``
    with the same metric contract as :func:`make_mesh_rollout`.

    Tracking maps (``block_map.n_r > 0``): call the returned function
    as ``run(x0s, u_pasts, y_pasts, Ws, setpoints)`` with a
    PER-SCENARIO schedule ``(B, n_outer, n_r)`` -- it shards over
    ``data`` like the other scenario arrays (broadcast a shared
    schedule to the batch axis yourself first; scenarios stay
    host-local per SURVEY.md section 5, so no collective is added).
    """
    from direct_data_driven_mpc_jax.ops.fused_rollout import (
        make_fused_batched_rollout,
    )

    tracking = bool(getattr(block_map, "n_r", 0))
    # Host-side operator assembly happens outside the traced region.
    local_rollout = make_fused_batched_rollout(
        block_map, n_steps, n_mpc_step=n_mpc_step,
        cost_precision=cost_precision,
    )

    result_specs = ClosedLoopResult(
        u_sys=P("data"),
        y_sys=P("data"),
        costs=P("data"),
        converged=P("data"),
        x_final=P("data"),
        u_past=P("data"),
        y_past=P("data"),
        solver_state=None,
    )
    out_specs = (result_specs, {"mean_final_cost": P(),
                                "frac_converged": P()})
    in_specs = (P("data"),) * (5 if tracking else 4)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    def sharded(x0s, u_pasts, y_pasts, Ws, *setpoints):
        result = local_rollout(
            x0s, u_pasts, y_pasts, Ws,
            setpoints=setpoints[0] if setpoints else None,
        )
        local_b = result.costs.shape[0]
        tot_b = jax.lax.psum(jnp.float32(local_b), "data")
        tot_cost = jax.lax.psum(jnp.sum(result.costs[:, -1]), "data")
        tot_conv = jax.lax.psum(
            jnp.sum(result.converged.astype(jnp.float32)), "data"
        )
        tot_solves = jax.lax.psum(
            jnp.asarray(result.converged.size, jnp.float32), "data"
        )
        metrics = {
            "mean_final_cost": tot_cost / tot_b,
            "frac_converged": tot_conv / tot_solves,
        }
        return result, metrics

    if tracking:
        def run(x0s, u_pasts, y_pasts, Ws, setpoints):
            R = jnp.asarray(setpoints)
            if R.ndim != 3:
                raise ValueError(
                    "sharded tracking rollouts need a per-scenario "
                    f"(B, n_outer, n_r) schedule; got shape {R.shape}"
                )
            return sharded(x0s, u_pasts, y_pasts, Ws, R)

        return jax.jit(run)
    return jax.jit(sharded)


def make_sharded_linear_rollout(
    mesh: Mesh,
    block_map,
    n_steps: int,
    n_mpc_step: int = 1,
    use_rng_noise: bool = False,
    eps_max: float = 0.0,
    emit_trajectories: bool = True,
):
    """Condensed-engine rollout sharded over the ``data`` mesh axis.

    The scenario axis is embarrassingly parallel and the condensed
    engine has no cross-scenario dependence, so no ``shard_map`` is
    needed: the batch arrays carry ``NamedSharding(mesh, P('data'))``
    and XLA partitions every matmul along the batch rows with zero
    collectives. The block-map operator is replicated (it is tiny).
    """
    from jax.sharding import NamedSharding

    from direct_data_driven_mpc_jax.control.linear_engine import (
        make_linear_batched_rollout,
    )

    data_sharding = NamedSharding(mesh, P("data"))
    run = make_linear_batched_rollout(
        block_map,
        n_steps=n_steps,
        n_mpc_step=n_mpc_step,
        use_rng_noise=use_rng_noise,
        eps_max=eps_max,
        emit_trajectories=emit_trajectories,
    )

    def sharded_run(x0s, u_pasts, y_pasts, noise):
        args = jax.tree.map(
            lambda a: jax.device_put(a, data_sharding),
            (x0s, u_pasts, y_pasts, noise),
        )
        return run(*args)

    return sharded_run


def make_sharded_fused_admm_rollout(
    mesh: Mesh,
    plant: LTIParams,
    admm_op: dict,
    n: int,
    m: int,
    p: int,
    n_steps: int,
    n_mpc_step: int = 1,
    iters=(4, 5, 2),
    cold_iters: int = 24,
    tol: float = 1e-5,
    q=None,
):
    """The fused ADMM engine (ops/fused_admm.py) data-parallel over the
    mesh via ``shard_map``: each device runs the fused scan on its
    local scenario shard -- zero collectives in the hot loop, one ``psum`` pair for aggregate metrics (scenarios
    stay host-local per SURVEY.md section 5). Same result/metric
    contract as :func:`make_sharded_fused_rollout`; the ADMM
    warm-start state shards over ``data`` with the scenarios.
    """
    from direct_data_driven_mpc_jax.ops.fused_admm import (
        make_fused_admm_rollout,
    )

    local_rollout = make_fused_admm_rollout(
        plant, admm_op, n, m, p, n_steps, n_mpc_step=n_mpc_step,
        iters=iters, cold_iters=cold_iters, tol=tol, q=q,
    )

    result_specs = ClosedLoopResult(
        u_sys=P("data"),
        y_sys=P("data"),
        costs=P("data"),
        converged=P("data"),
        x_final=P("data"),
        u_past=P("data"),
        y_past=P("data"),
        solver_state=ADMMState(s=P("data"), w=P("data")),
    )
    out_specs = (result_specs, {"mean_final_cost": P(),
                                "frac_converged": P()})

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("data"),) * 4,
        out_specs=out_specs,
        check_vma=False,
    )
    def sharded(x0s, u_pasts, y_pasts, Ws):
        result = local_rollout(x0s, u_pasts, y_pasts, Ws)
        local_b = result.costs.shape[0]
        tot_b = jax.lax.psum(jnp.float32(local_b), "data")
        tot_cost = jax.lax.psum(jnp.sum(result.costs[:, -1]), "data")
        tot_conv = jax.lax.psum(
            jnp.sum(result.converged.astype(jnp.float32)), "data"
        )
        tot_solves = jax.lax.psum(
            jnp.asarray(result.converged.size, jnp.float32), "data"
        )
        metrics = {
            "mean_final_cost": tot_cost / tot_b,
            "frac_converged": tot_conv / tot_solves,
        }
        return result, metrics

    return jax.jit(sharded)

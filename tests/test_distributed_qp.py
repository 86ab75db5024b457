"""Distributed (alpha-sharded) preconditioned-MINRES KKT solver vs the
exact direct operator, on the virtual CPU mesh -- single solves, the
preconditioner's iteration win, tolerance-based early exit, and the
mesh closed-loop engine end to end."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.loop import closed_loop_rollout
from direct_data_driven_mpc_jax.ops.lti import LTIParams
from direct_data_driven_mpc_jax.parallel.mesh import make_scenario_mesh
from direct_data_driven_mpc_jax.qp.distributed import (
    make_distributed_closed_loop,
    make_distributed_kkt_solver,
)
from direct_data_driven_mpc_jax.qp.solution_map import (
    compute_solution_map,
    solve_u,
)
from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

from tests.test_qp import _small_problem


@pytest.mark.parametrize(
    "ctype,use_terminal,tol,atol",
    [
        (DataDrivenMPCType.ROBUST, True, 1e-8, 1e-6),
        (DataDrivenMPCType.ROBUST, False, 1e-8, 1e-6),
        # NOMINAL: singular (but consistent) KKT; near-null-space modes
        # make the u error ~1e3x the residual, so the tolerance must be
        # driven correspondingly deeper.
        (DataDrivenMPCType.NOMINAL, True, 1e-11, 1e-5),
    ],
)
def test_distributed_minres_matches_direct(ctype, use_terminal, tol, atol):
    spec, theta = _small_problem(ctype, use_terminal=use_terminal)
    mesh = make_scenario_mesh(n_data=2, n_model=4)
    solve = make_distributed_kkt_solver(
        spec, mesh, axis="model", dtype=jnp.float64, tol=tol
    )
    u_dist, res, iters = solve(theta)
    assert float(res) < 1e-7, f"MINRES residual {float(res)}"
    assert int(iters) < 1000  # early exit actually fired

    sol_map = compute_solution_map(spec, dtype=jnp.float64)
    u_exact = solve_u(sol_map, jnp.asarray(theta))
    np.testing.assert_allclose(
        np.asarray(u_dist), np.asarray(u_exact), atol=atol
    )


def test_refinement_restart_beats_f32_floor():
    """One iterative-refinement restart (refine=1) must cut BOTH the
    true residual and the solution error vs the plain f32 solve on the
    same problem -- f32 MINRES stagnates with the solution error still
    ~kappa x the residual, and a restart re-solves for the correction
    from a fresh Krylov space."""
    spec, theta = _small_problem(DataDrivenMPCType.ROBUST)
    mesh = make_scenario_mesh(n_data=2, n_model=4)
    sol_map = compute_solution_map(spec, dtype=jnp.float64)
    u_exact = np.asarray(solve_u(sol_map, jnp.asarray(theta)))
    out = {}
    for refine in (0, 1):
        solve = make_distributed_kkt_solver(
            spec, mesh, axis="model", dtype=jnp.float32, refine=refine
        )
        u, res, iters = solve(theta)
        du = float(np.abs(np.asarray(u) - u_exact).max())
        out[refine] = (float(res), du, int(iters))
    res0, du0, it0 = out[0]
    res1, du1, it1 = out[1]
    assert res1 < res0 and du1 < du0, out
    assert du1 < 1e-4, out
    assert it1 > it0  # the restart pass's iterations are reported


def test_preconditioner_cuts_iterations():
    """The Jacobi preconditioner must reduce iterations-to-tolerance on
    this badly block-scaled family (R ~ 1e-4 vs lamb_sigma ~ 1e3)."""
    spec, theta = _small_problem(DataDrivenMPCType.ROBUST)
    mesh = make_scenario_mesh(n_data=2, n_model=4)
    it = {}
    for pc in (True, False):
        solve = make_distributed_kkt_solver(
            spec, mesh, axis="model", dtype=jnp.float64,
            max_iters=20000, precondition=pc,
        )
        u, res, iters = solve(theta)
        assert float(res) < 1e-7
        it[pc] = int(iters)
    assert it[True] < it[False], f"preconditioned {it}"


def test_tolerance_controls_early_exit():
    """Looser tolerance must exit in fewer iterations; both residuals
    must respect their own tolerance."""
    spec, theta = _small_problem(DataDrivenMPCType.ROBUST)
    mesh = make_scenario_mesh(n_data=2, n_model=4)
    iters_at = {}
    for tol in (1e-4, 1e-10):
        solve = make_distributed_kkt_solver(
            spec, mesh, axis="model", tol=tol, dtype=jnp.float64
        )
        _, res, iters = solve(theta)
        iters_at[tol] = int(iters)
    assert iters_at[1e-4] < iters_at[1e-10]


def test_device_side_b_assembly_jits():
    """solve(theta) must be traceable: b(theta) is assembled on device,
    so the solver composes under jit with a traced theta."""
    spec, theta = _small_problem(DataDrivenMPCType.ROBUST)
    mesh = make_scenario_mesh(n_data=2, n_model=4)
    solve = make_distributed_kkt_solver(
        spec, mesh, axis="model", dtype=jnp.float64
    )
    jitted = jax.jit(lambda t: solve(t)[0])
    u1 = jitted(jnp.asarray(theta))
    u2 = solve(theta)[0]
    np.testing.assert_allclose(np.asarray(u1), np.asarray(u2), atol=1e-12)


def test_distributed_closed_loop_matches_direct_engine():
    """The mesh closed-loop engine (data-sharded scenarios, alpha-
    sharded PMINRES per solve) must track the exact-operator fused
    engine within the solver tolerance over a full rollout."""
    spec, theta = _small_problem(DataDrivenMPCType.ROBUST)
    mesh = make_scenario_mesh(n_data=2, n_model=4)
    A = np.array([[0.9, 0.2], [0.0, 0.8]])
    B = np.array([[0.0], [1.0]])
    C = np.array([[1.0, 0.3]])
    D = np.array([[0.1]])
    plant = LTIParams(A=A, B=B, C=C, D=D)

    Bsz, n_steps, n = 4, 12, 2
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(rng.normal(size=(Bsz, n)) * 0.1)
    up = jnp.asarray(theta[: n * 1].reshape(n, 1))
    yp = jnp.asarray(theta[n * 1 :].reshape(n, 1))
    ups = jnp.tile(up[None], (Bsz, 1, 1))
    yps = jnp.tile(yp[None], (Bsz, 1, 1))
    Ws = jnp.asarray(0.002 * rng.uniform(-1, 1, (Bsz, n_steps, 1)))

    run = make_distributed_closed_loop(
        mesh, plant, spec, n_steps=n_steps, dtype=jnp.float64,
        tol=1e-9,
    )
    result = run(x0s, ups, yps, Ws)
    assert bool(np.all(np.asarray(result.converged)))

    sol_map = compute_solution_map(spec, dtype=jnp.float64)
    for b in range(Bsz):
        ref = closed_loop_rollout(
            plant, sol_map, x0s[b], ups[b], yps[b], Ws[b],
            n_steps=n_steps,
        )
        np.testing.assert_allclose(
            np.asarray(result.u_sys[b]), np.asarray(ref.u_sys),
            atol=1e-7,
        )
        np.testing.assert_allclose(
            np.asarray(result.costs[b]), np.asarray(ref.costs),
            atol=1e-7, rtol=1e-7,
        )


def test_distributed_rejects_convex_slack():
    spec, _ = _small_problem(slack=SlackVarConstraintTypes.CONVEX)
    mesh = make_scenario_mesh(n_data=2, n_model=4)
    with pytest.raises(ValueError, match="slack-NONE"):
        make_distributed_kkt_solver(spec, mesh)

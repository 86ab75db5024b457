"""Batch (vmap) and mesh (shard_map) tests on the virtual 8-device
CPU platform."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.loop import closed_loop_rollout
from direct_data_driven_mpc_jax.parallel.batch import (
    batched_closed_loop,
    draw_noise_batch,
    make_batched_rollout,
)
from direct_data_driven_mpc_jax.parallel.mesh import (
    make_mesh_rollout,
    make_scenario_mesh,
)

from tests.test_closed_loop import _make_setup


@pytest.fixture(scope="module")
def setup():
    plant, ctrl, rng = _make_setup(n_mpc_step=1)
    sol = ctrl.solution_map(dtype=jnp.float64)
    params = plant.as_params()
    x0 = plant.get_state().copy()
    up = ctrl.u_past.reshape(4, 2).copy()
    yp = ctrl.y_past.reshape(4, 2).copy()
    return params, sol, x0, up, yp


def _batch_inputs(x0, up, yp, B, n_steps, key):
    x0s = jnp.tile(jnp.asarray(x0)[None], (B, 1))
    ups = jnp.tile(jnp.asarray(up)[None], (B, 1, 1))
    yps = jnp.tile(jnp.asarray(yp)[None], (B, 1, 1))
    Ws = draw_noise_batch(key, B, n_steps, 2, 0.002, dtype=jnp.float64)
    return x0s, ups, yps, Ws


def test_vmap_batch_matches_single_scenarios(setup):
    params, sol, x0, up, yp = setup
    B, n_steps = 4, 20
    key = jax.random.key(0)
    x0s, ups, yps, Ws = _batch_inputs(x0, up, yp, B, n_steps, key)
    batch = batched_closed_loop(
        params, sol, x0s, ups, yps, Ws, n_steps=n_steps
    )
    # Each batch lane must equal the single-scenario rollout.
    for b in range(B):
        single = closed_loop_rollout(
            params, sol, x0s[b], ups[b], yps[b], Ws[b], n_steps=n_steps
        )
        np.testing.assert_allclose(
            np.asarray(batch.u_sys[b]), np.asarray(single.u_sys), atol=1e-12
        )


def test_noise_batch_deterministic_per_scenario():
    key = jax.random.key(7)
    W8 = draw_noise_batch(key, 8, 10, 2, 0.002)
    W8_again = draw_noise_batch(key, 8, 10, 2, 0.002)
    np.testing.assert_array_equal(np.asarray(W8), np.asarray(W8_again))
    assert np.abs(np.asarray(W8)).max() <= 0.002


def test_noise_batch_invariant_to_batch_size():
    # Scenario i's draw depends only on (key, i): growing the batch or
    # partitioning it across hosts must not change existing scenarios.
    key = jax.random.key(11)
    W4 = np.asarray(draw_noise_batch(key, 4, 10, 2, 0.002))
    W16 = np.asarray(draw_noise_batch(key, 16, 10, 2, 0.002))
    np.testing.assert_array_equal(W4, W16[:4])
    # Per-scenario draw equals the scalar fold_in recipe.
    w2 = 0.002 * jax.random.uniform(
        jax.random.fold_in(key, 2), (10, 2), minval=-1.0, maxval=1.0,
        dtype=W4.dtype,
    )
    np.testing.assert_array_equal(W16[2], np.asarray(w2))


def test_mesh_data_parallel_matches_vmap(setup):
    params, sol, x0, up, yp = setup
    mesh = make_scenario_mesh(n_data=4, n_model=2)
    B, n_steps = 8, 15
    key = jax.random.key(1)
    x0s, ups, yps, Ws = _batch_inputs(x0, up, yp, B, n_steps, key)

    run = make_mesh_rollout(mesh, params, sol, n_steps=n_steps)
    result, metrics = run(x0s, ups, yps, Ws)
    ref = batched_closed_loop(
        params, sol, x0s, ups, yps, Ws, n_steps=n_steps
    )
    np.testing.assert_allclose(
        np.asarray(result.u_sys), np.asarray(ref.u_sys), atol=1e-12
    )
    assert float(metrics["frac_converged"]) == 1.0
    assert float(metrics["mean_final_cost"]) == pytest.approx(
        float(jnp.mean(ref.costs[:, -1])), rel=1e-9
    )


def test_mesh_model_parallel_gain_sharding_matches(setup):
    params, sol, x0, up, yp = setup
    mesh = make_scenario_mesh(n_data=4, n_model=2)
    B, n_steps = 8, 15
    key = jax.random.key(2)
    x0s, ups, yps, Ws = _batch_inputs(x0, up, yp, B, n_steps, key)

    run_mp = make_mesh_rollout(
        mesh, params, sol, n_steps=n_steps, model_parallel=True
    )
    result_mp, _ = run_mp(x0s, ups, yps, Ws)
    ref = batched_closed_loop(
        params, sol, x0s, ups, yps, Ws, n_steps=n_steps
    )
    np.testing.assert_allclose(
        np.asarray(result_mp.u_sys), np.asarray(ref.u_sys), atol=1e-10
    )


def test_jitted_batched_rollout_compiles_once(setup):
    params, sol, x0, up, yp = setup
    run = make_batched_rollout(params, sol, n_steps=10)
    B = 3
    key = jax.random.key(3)
    x0s, ups, yps, Ws = _batch_inputs(x0, up, yp, B, 10, key)
    r1 = run(x0s, ups, yps, Ws)
    r2 = run(x0s, ups, yps, Ws)
    np.testing.assert_array_equal(np.asarray(r1.u_sys), np.asarray(r2.u_sys))


def test_mesh_admm_solver_matches_vmap(setup):
    from direct_data_driven_mpc_jax.qp.spec import SlackVarConstraintTypes

    plant, ctrl, rng = _make_setup(
        slack=SlackVarConstraintTypes.CONVEX, n_mpc_step=1
    )
    params = plant.as_params()
    admm = ctrl.admm_solver(dtype=jnp.float64)
    mesh = make_scenario_mesh(n_data=4, n_model=2)
    B, n_steps = 8, 10
    x0 = plant.get_state().copy()
    up = ctrl.u_past.reshape(4, 2)
    yp = ctrl.y_past.reshape(4, 2)
    x0s = jnp.tile(jnp.asarray(x0)[None], (B, 1))
    ups = jnp.tile(jnp.asarray(up)[None], (B, 1, 1))
    yps = jnp.tile(jnp.asarray(yp)[None], (B, 1, 1))
    Ws = draw_noise_batch(
        jax.random.key(9), B, n_steps, 2, 0.002, dtype=jnp.float64
    )
    run = make_mesh_rollout(
        mesh, params, admm, n_steps=n_steps, admm_iters=150
    )
    result, metrics = run(x0s, ups, yps, Ws)
    ref = batched_closed_loop(
        params, admm, x0s, ups, yps, Ws, n_steps=n_steps, admm_iters=150
    )
    np.testing.assert_allclose(
        np.asarray(result.u_sys), np.asarray(ref.u_sys), atol=1e-10
    )
    assert float(metrics["frac_converged"]) == 1.0


def test_sharded_linear_rollout_matches_unsharded(setup):
    from direct_data_driven_mpc_jax.control.linear_engine import (
        build_affine_block_map,
        make_linear_batched_rollout,
    )
    from direct_data_driven_mpc_jax.parallel.mesh import (
        make_sharded_linear_rollout,
    )

    plant, ctrl, rng = _make_setup(n_mpc_step=1)
    bm = build_affine_block_map(
        plant.as_params(), ctrl._op, n=4, m=2, p=2,
        solves_per_block=5, dtype=jnp.float64,
    )
    mesh = make_scenario_mesh(n_data=8, n_model=1)
    B, n_steps = 16, 20
    x0 = plant.get_state().copy()
    x0s = jnp.tile(jnp.asarray(x0)[None], (B, 1))
    ups = jnp.tile(jnp.asarray(ctrl.u_past.reshape(4, 2))[None], (B, 1, 1))
    yps = jnp.tile(jnp.asarray(ctrl.y_past.reshape(4, 2))[None], (B, 1, 1))
    Ws = draw_noise_batch(
        jax.random.key(2), B, n_steps, 2, 0.002, dtype=jnp.float64
    )
    sharded = make_sharded_linear_rollout(mesh, bm, n_steps=n_steps)
    res = sharded(x0s, ups, yps, Ws)
    ref = make_linear_batched_rollout(bm, n_steps=n_steps)(
        x0s, ups, yps, Ws
    )
    np.testing.assert_allclose(
        np.asarray(res.u_sys), np.asarray(ref.u_sys), atol=1e-12
    )
    # The result must actually be sharded over the data axis.
    assert len(res.u_sys.sharding.device_set) == 8


def test_sharded_fused_rollout_matches_unsharded(setup):
    """The fused-operator engine (Pallas kernel's XLA scan twin) under
    shard_map over 8 virtual devices: same trajectories as the
    unsharded condensed engine, result sharded, psum metrics correct."""
    from direct_data_driven_mpc_jax.control.linear_engine import (
        build_affine_block_map,
        make_linear_batched_rollout,
    )
    from direct_data_driven_mpc_jax.parallel.mesh import (
        make_sharded_fused_rollout,
    )

    plant, ctrl, rng = _make_setup(n_mpc_step=1)
    bm = build_affine_block_map(
        plant.as_params(), ctrl._op, n=4, m=2, p=2,
        solves_per_block=5, dtype=jnp.float32,
    )
    mesh = make_scenario_mesh(n_data=8, n_model=1)
    B, n_steps = 16, 20
    x0 = plant.get_state().copy()
    x0s = jnp.tile(jnp.asarray(x0, jnp.float32)[None], (B, 1))
    ups = jnp.tile(
        jnp.asarray(ctrl.u_past.reshape(4, 2), jnp.float32)[None],
        (B, 1, 1),
    )
    yps = jnp.tile(
        jnp.asarray(ctrl.y_past.reshape(4, 2), jnp.float32)[None],
        (B, 1, 1),
    )
    Ws = draw_noise_batch(
        jax.random.key(2), B, n_steps, 2, 0.002, dtype=jnp.float32
    )
    sharded = make_sharded_fused_rollout(
        mesh, bm, n_steps=n_steps
    )
    res, metrics = sharded(x0s, ups, yps, Ws)
    ref = make_linear_batched_rollout(bm, n_steps=n_steps)(
        x0s, ups, yps, Ws
    )
    np.testing.assert_allclose(
        np.asarray(res.u_sys), np.asarray(ref.u_sys), atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(res.y_sys), np.asarray(ref.y_sys), atol=2e-5
    )
    assert len(res.u_sys.sharding.device_set) == 8
    np.testing.assert_allclose(
        float(metrics["mean_final_cost"]),
        float(jnp.mean(ref.costs[:, -1])),
        rtol=1e-4,
    )
    assert float(metrics["frac_converged"]) == 1.0


def test_heterogeneous_scenarios_all_axes_vary():
    """Noise seeds, data realizations (distinct solution operators),
    and plant perturbations all vmapped in one batch."""
    from direct_data_driven_mpc_jax.models.random_lti import (
        random_stable_lti,
    )
    from direct_data_driven_mpc_jax.parallel.batch import (
        heterogeneous_closed_loop,
        stack_plants,
        stack_solution_maps,
    )
    from direct_data_driven_mpc_jax.control.controller import (
        DirectDataDrivenMPCController,
    )
    from direct_data_driven_mpc_jax.qp.spec import (
        DataDrivenMPCType,
        SlackVarConstraintTypes,
    )

    B, n, m, p, L, n_steps = 3, 2, 1, 1, 6, 12
    N = m * (L + 2 * n) + L + 2 * n + 5
    plants, sols, x0s, ups, yps, Ws, singles = [], [], [], [], [], [], []
    for b in range(B):
        rng = np.random.default_rng(100 + b)
        plant = random_stable_lti(
            seed=200 + b, ns=n, m=m, p=p, spectral_radius=0.8
        )
        u_d = rng.uniform(-1, 1, (N, m))
        w_d = 0.002 * rng.uniform(-1, 1, (N, p))
        y_d = plant.simulate(u_d, w_d, N)
        u_s = 0.3 * np.ones((m, 1))
        y_s = plant.get_equilibrium_output_from_input(
            u_s.flatten()
        ).reshape(-1, 1)
        ctrl = DirectDataDrivenMPCController(
            n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L,
            Q=3.0 * np.eye(p * L), R=1e-4 * np.eye(m * L),
            u_s=u_s, y_s=y_s,
            eps_max=0.002, lamb_alpha=50.0, lamb_sigma=1000.0, c=1.0,
            slack_var_constraint_type=SlackVarConstraintTypes.NONE,
            controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
        )
        plants.append(plant.as_params())
        sols.append(ctrl.solution_map(dtype=jnp.float64))
        x0s.append(plant.get_state().copy())
        ups.append(ctrl.u_past.reshape(n, m).copy())
        yps.append(ctrl.y_past.reshape(n, p).copy())
        Ws.append(0.002 * rng.uniform(-1, 1, (n_steps, p)))
        singles.append((plants[-1], sols[-1]))

    batch = heterogeneous_closed_loop(
        stack_plants(plants),
        stack_solution_maps(sols),
        jnp.asarray(np.stack(x0s)),
        jnp.asarray(np.stack(ups)),
        jnp.asarray(np.stack(yps)),
        jnp.asarray(np.stack(Ws)),
        n_steps=n_steps,
    )
    # Every lane must equal its own single-scenario rollout.
    for b in range(B):
        single = closed_loop_rollout(
            singles[b][0], singles[b][1],
            x0s[b], ups[b], yps[b], Ws[b], n_steps=n_steps,
        )
        np.testing.assert_allclose(
            np.asarray(batch.u_sys[b]), np.asarray(single.u_sys),
            atol=1e-12,
        )
    # Distinct plants/data -> distinct trajectories.
    assert not np.allclose(
        np.asarray(batch.y_sys[0]), np.asarray(batch.y_sys[1])
    )


def test_mesh_model_parallel_with_row_padding(setup):
    """Regression: gain rows (L*m = 60) padded to the model axis (8 ->
    64) must be dropped after the gather, not fed to the plant."""
    params, sol, x0, up, yp = setup
    mesh = make_scenario_mesh(n_data=1, n_model=8)  # 60 % 8 != 0 -> pad
    B, n_steps = 4, 10
    key = jax.random.key(4)
    x0s, ups, yps, Ws = _batch_inputs(x0, up, yp, B, n_steps, key)
    run_mp = make_mesh_rollout(
        mesh, params, sol, n_steps=n_steps, model_parallel=True
    )
    result, _ = run_mp(x0s, ups, yps, Ws)
    ref = batched_closed_loop(
        params, sol, x0s, ups, yps, Ws, n_steps=n_steps
    )
    np.testing.assert_allclose(
        np.asarray(result.u_sys), np.asarray(ref.u_sys), atol=1e-10
    )

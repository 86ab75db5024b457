"""BASELINE configs 3 and 5: long-horizon and large-plant scaling.

Exercised at reduced batch/steps on CPU; the bench runs them at full
scale on the GPU (bench.py <config>).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.controller import (
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_jax.control.linear_engine import (
    build_affine_block_map,
    linear_closed_loop_rollout,
    make_linear_batched_rollout,
)
from direct_data_driven_mpc_jax.control.loop import closed_loop_rollout
from direct_data_driven_mpc_jax.models.lti_model import LTIModel
from direct_data_driven_mpc_jax.models.random_lti import random_stable_lti
from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

from tests.test_closed_loop import FOUR_TANK


@pytest.mark.slow
def test_long_horizon_config3():
    """Four-tank robust with L=60, N=800 (paper-size QP stressed:
    alpha ~ 737, nz ~ 1121)."""
    rng = np.random.default_rng(0)
    plant = LTIModel(**FOUR_TANK)
    N, L = 800, 60
    u_d = rng.uniform(-1, 1, (N, 2))
    w_d = 0.002 * rng.uniform(-1, 1, (N, 2))
    y_d = plant.simulate(u_d, w_d, N)
    ctrl = DirectDataDrivenMPCController(
        n=4, m=2, p=2, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(2 * L), R=1e-4 * np.eye(2 * L),
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
        eps_max=0.002, lamb_alpha=50.0, lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
    )
    # nz = n_alpha + n_u + 2*n_y = 737 + 128 + 256
    assert ctrl.spec.nz == 737 + 128 + 256
    assert ctrl.get_problem_solve_status() == "optimal"

    # Short closed loop must settle toward the setpoint direction.
    sol = ctrl.solution_map(dtype=jnp.float64)
    W = 0.002 * rng.uniform(-1, 1, (60, 2))
    res = closed_loop_rollout(
        plant.as_params(), sol, plant.get_state(),
        ctrl.u_past.reshape(4, 2), ctrl.y_past.reshape(4, 2), W,
        n_steps=60,
    )
    assert bool(jnp.isfinite(res.u_sys).all())
    assert np.asarray(res.costs)[-1] < np.asarray(res.costs)[0]


@pytest.mark.slow
def test_large_plant_config5_linear_engine_rng_noise():
    """10-input/10-output random plant; condensed engine with in-scan
    RNG noise and metrics-only emission (the 64k-scenario mode)."""
    plant = random_stable_lti(seed=0, ns=10, m=10, p=10)
    rng = np.random.default_rng(1)
    n, L = 10, 30
    N = 600  # >= N_min = 10*(30+20) + 49 = 549
    u_d = rng.uniform(-1, 1, (N, 10))
    w_d = 0.002 * rng.uniform(-1, 1, (N, 10))
    y_d = plant.simulate(u_d, w_d, N)
    u_s = 0.5 * np.ones((10, 1))
    y_s = plant.get_equilibrium_output_from_input(u_s.flatten()).reshape(
        -1, 1
    )
    ctrl = DirectDataDrivenMPCController(
        n=n, m=10, p=10, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(10 * L), R=1e-4 * np.eye(10 * L),
        u_s=u_s, y_s=y_s,
        eps_max=0.002, lamb_alpha=50.0, lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
    )
    assert ctrl.get_problem_solve_status() == "optimal"

    bm = build_affine_block_map(
        plant.as_params(), ctrl._op, n=n, m=10, p=10,
        solves_per_block=5, dtype=jnp.float64,
    )

    B, T = 8, 20
    x0s = jnp.tile(jnp.asarray(plant.get_state())[None], (B, 1))
    ups = jnp.tile(
        jnp.asarray(ctrl.u_past.reshape(n, 10))[None], (B, 1, 1)
    )
    yps = jnp.tile(
        jnp.asarray(ctrl.y_past.reshape(n, 10))[None], (B, 1, 1)
    )
    keys = jax.random.split(jax.random.key(0), B)

    run = make_linear_batched_rollout(
        bm, n_steps=T, use_rng_noise=True, eps_max=0.002,
        emit_trajectories=False,
    )
    res = run(x0s, ups, yps, keys)
    assert res.costs.shape == (B, T)
    assert bool(jnp.isfinite(res.costs).all())
    assert res.u_sys.shape == (B, 0, 10)  # metrics-only mode
    # Distinct keys -> distinct noise -> distinct cost paths.
    assert not np.allclose(
        np.asarray(res.costs[0]), np.asarray(res.costs[1])
    )
    # Closed loop is settling: terminal cost below initial.
    assert float(res.costs[:, -1].mean()) < float(res.costs[:, 0].mean())


def test_rng_noise_matches_explicit_noise_path():
    """The in-scan RNG path must equal the explicit-W path when fed the
    same realized noise."""
    plant = random_stable_lti(seed=3, ns=4, m=2, p=2)
    rng = np.random.default_rng(2)
    n, L, N = 4, 10, 80
    u_d = rng.uniform(-1, 1, (N, 2))
    w_d = 0.002 * rng.uniform(-1, 1, (N, 2))
    y_d = plant.simulate(u_d, w_d, N)
    u_s = 0.3 * np.ones((2, 1))
    y_s = plant.get_equilibrium_output_from_input(u_s.flatten()).reshape(
        -1, 1
    )
    ctrl = DirectDataDrivenMPCController(
        n=n, m=2, p=2, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(2 * L), R=1e-4 * np.eye(2 * L),
        u_s=u_s, y_s=y_s,
        eps_max=0.002, lamb_alpha=50.0, lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
    )
    bm = build_affine_block_map(
        plant.as_params(), ctrl._op, n=n, m=2, p=2,
        solves_per_block=4, dtype=jnp.float64,
    )
    T = 16
    key = jax.random.key(5)
    x0 = plant.get_state()
    up = ctrl.u_past.reshape(n, 2)
    yp = ctrl.y_past.reshape(n, 2)

    r_rng = linear_closed_loop_rollout(
        bm, x0, up, yp, n_steps=T, noise_key=key, eps_max=0.002
    )
    # Reconstruct the same noise on the host: per outer block i the
    # engine draws uniform(fold_in(key, i), (steps_per_outer * p,)).
    blocks = []
    for i in range(T // 4):
        blocks.append(
            0.002
            * jax.random.uniform(
                jax.random.fold_in(key, i), (4 * 2,),
                minval=-1.0, maxval=1.0, dtype=jnp.float64,
            )
        )
    W = jnp.concatenate(blocks).reshape(T, 2)
    r_w = linear_closed_loop_rollout(bm, x0, up, yp, W=W, n_steps=T)
    np.testing.assert_allclose(
        np.asarray(r_rng.u_sys), np.asarray(r_w.u_sys), atol=1e-12
    )


def test_random_plant_properties():
    plant = random_stable_lti(seed=7, ns=10, m=10, p=10)
    eigs = np.abs(np.linalg.eigvals(plant.A))
    assert eigs.max() <= 0.9 + 1e-9
    M = plant.C @ np.linalg.solve(np.eye(10) - plant.A, plant.B)
    assert np.linalg.svd(M, compute_uv=False).min() >= 0.1 - 1e-9
    # Seeded: same seed reproduces the same plant.
    plant2 = random_stable_lti(seed=7, ns=10, m=10, p=10)
    np.testing.assert_array_equal(plant.A, plant2.A)

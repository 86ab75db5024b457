"""Fused batched ADMM engine (ops/fused_admm.py): parity with the
generic scan engine and the independent active-set golden fixtures."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.controller import (
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_jax.control.loop import closed_loop_rollout
from direct_data_driven_mpc_jax.ops.lti import LTIParams
from direct_data_driven_mpc_jax.ops.fused_admm import (
    build_fused_admm_operator,
    make_fused_admm_rollout,
    make_fused_ladder_rollout,
    pick_pack_factor,
)
from direct_data_driven_mpc_jax.qp.admm import compute_admm_operator_np
from direct_data_driven_mpc_jax.qp.box import compute_box_admm_operator_np
from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

from tests.test_closed_loop import FOUR_TANK, _make_setup

GOLDEN = pytest.importorskip("os").path.join(
    pytest.importorskip("os").path.dirname(__file__),
    "golden", "four_tank_box_golden.npz",
)

#: Default per-solve iteration schedules (bf16_1x, bf16_3x, HIGHEST),
#: measured against the active-set golden (round-4 sweep): CONVEX
#: (4,4,2) is the 100%-converged minimum, (4,5,2) adds one margin
#: iteration; BOX needs all-3x iterations (1-pass bf16 noise ~3e-3 at
#: |v|~0.85 stalls the fixed point; (0,12,2) is the golden-workload
#: minimum) plus 4 f32-grade polish iterations -- at B=65536,
#: (0,14,2) left 0.13% of lanes above tol while (0,14,4) converges
#: 100%.
CONVEX_ITERS = (4, 5, 2)
BOX_ITERS = (0, 14, 4)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _plant32():
    return LTIParams(
        *(jnp.asarray(a, jnp.float32)
          for a in (FOUR_TANK["A"], FOUR_TANK["B"], FOUR_TANK["C"],
                    FOUR_TANK["D"]))
    )


def _golden_controller(golden, scheme):
    kw = dict(
        n=4, m=2, p=2, u_d=golden["u_d"], y_d=golden["y_d"], L=30,
        Q=3.0 * np.eye(60), R=1e-4 * np.eye(60),
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
        eps_max=0.002, lamb_alpha=0.1 / 0.002, lamb_sigma=1000.0,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
    )
    if scheme == "CONVEX":
        kw.update(
            c=float(golden["convex_c"]),
            slack_var_constraint_type=SlackVarConstraintTypes.CONVEX,
        )
    else:
        kw.update(
            c=1.0,
            slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        )
    return DirectDataDrivenMPCController(**kw)


def _golden_run(golden, scheme, B=2, **kw):
    ctrl = _golden_controller(golden, scheme)
    if scheme == "CONVEX":
        op = compute_admm_operator_np(ctrl.spec)
        iters, cold, tol = CONVEX_ITERS, 24, 1e-5
    else:
        op = compute_box_admm_operator_np(
            ctrl.spec, u_bounds=(-float(golden["u_box"]),
                                 float(golden["u_box"])), rho=1.0
        )
        iters, cold, tol = BOX_ITERS, 60, 2e-5
    T = golden[f"{scheme}_u"].shape[0]
    run = make_fused_admm_rollout(
        _plant32(), op, n=4, m=2, p=2, n_steps=T, iters=iters,
        cold_iters=cold, tol=tol, **kw,
    )
    tile = lambda a: jnp.tile(  # noqa: E731
        jnp.asarray(a, jnp.float32)[None],
        (B,) + (1,) * np.asarray(a).ndim,
    )
    return run(
        tile(golden["x0"]),
        tile(golden[f"{scheme}_u_past0"]),
        tile(golden[f"{scheme}_y_past0"]),
        tile(golden["w_sys"][:T]),
    )


@pytest.mark.parametrize("scheme", ["CONVEX", "BOX"])
def test_fused_admm_twin_matches_golden(golden, scheme):
    """The fused engine vs the independent active-set golden: <1e-4 on applied inputs, 100% converged lanes, costs
    consistent, box respected."""
    res = _golden_run(golden, scheme)
    du = np.abs(
        np.asarray(res.u_sys[0], np.float64) - golden[f"{scheme}_u"]
    ).max()
    assert du < 1e-4, du
    assert float(np.asarray(res.converged).mean()) == 1.0
    np.testing.assert_allclose(
        np.asarray(res.costs[0], np.float64),
        golden[f"{scheme}_costs"], rtol=5e-3, atol=1e-3,
    )
    if scheme == "BOX":
        assert np.abs(np.asarray(res.u_sys)).max() <= float(
            golden["u_box"]
        ) + 1e-6


def test_fused_admm_matches_generic_engine():
    """Fused engine vs the generic scan engine (qp/admm.py through
    control/loop.py) on the example CONVEX config: same trajectories
    within the f32 budget."""
    plant, ctrl, rng = _make_setup(
        n_mpc_step=1, slack=SlackVarConstraintTypes.CONVEX
    )
    params32 = plant.as_params(dtype=np.float32)
    T, B = 40, 4
    x0s = jnp.tile(
        jnp.asarray(plant.get_state(), jnp.float32)[None], (B, 1)
    )
    ups = jnp.tile(
        jnp.asarray(ctrl.u_past.reshape(4, 2), jnp.float32)[None],
        (B, 1, 1),
    )
    yps = jnp.tile(
        jnp.asarray(ctrl.y_past.reshape(4, 2), jnp.float32)[None],
        (B, 1, 1),
    )
    W = jnp.asarray(0.002 * rng.uniform(-1, 1, (B, T, 2)), jnp.float32)
    sol = ctrl.admm_solver(dtype=jnp.float32)
    ref = jax.vmap(
        lambda a, b, c, w: closed_loop_rollout(
            params32, sol, a, b, c, w, n_steps=T, admm_iters=60
        )
    )(x0s, ups, yps, W)
    run = make_fused_admm_rollout(
        params32, compute_admm_operator_np(ctrl.spec),
        n=4, m=2, p=2, n_steps=T, iters=CONVEX_ITERS, cold_iters=24,
    )
    res = run(x0s, ups, yps, W)
    assert np.abs(
        np.asarray(res.u_sys) - np.asarray(ref.u_sys)
    ).max() < 1e-4
    assert np.abs(
        np.asarray(res.y_sys) - np.asarray(ref.y_sys)
    ).max() < 1e-4
    assert float(np.asarray(res.converged).mean()) == 1.0


def test_fused_admm_nstep_cadence(golden):
    """Algorithm-2 (n_mpc_step > 1) through the fused engine vs the
    generic engine with the same cadence."""
    nb, T, B = 4, 36, 2
    ctrl = _golden_controller(golden, "CONVEX")
    plant32 = _plant32()
    x0s = jnp.tile(jnp.asarray(golden["x0"], jnp.float32)[None], (B, 1))
    ups = jnp.tile(
        jnp.asarray(golden["CONVEX_u_past0"], jnp.float32)[None],
        (B, 1, 1),
    )
    yps = jnp.tile(
        jnp.asarray(golden["CONVEX_y_past0"], jnp.float32)[None],
        (B, 1, 1),
    )
    W = jnp.asarray(golden["w_sys"][:T], jnp.float32)[None].repeat(
        B, axis=0
    )
    sol = ctrl.admm_solver(dtype=jnp.float32)
    ref = jax.vmap(
        lambda a, b, c, w: closed_loop_rollout(
            plant32, sol, a, b, c, w, n_steps=T, n_mpc_step=nb,
            admm_iters=60,
        )
    )(x0s, ups, yps, W)
    run = make_fused_admm_rollout(
        plant32, compute_admm_operator_np(ctrl.spec),
        n=4, m=2, p=2, n_steps=T, n_mpc_step=nb, iters=(4, 8, 2),
        cold_iters=24,
    )
    res = run(x0s, ups, yps, W)
    assert res.u_sys.shape == (B, T, 2)
    assert res.costs.shape == (B, T // nb)
    assert np.abs(
        np.asarray(res.u_sys) - np.asarray(ref.u_sys)
    ).max() < 1e-4
    np.testing.assert_allclose(
        np.asarray(res.costs), np.asarray(ref.costs), rtol=5e-3,
        atol=1e-3,
    )


def test_fused_admm_warm_start_segmented(golden):
    """Segmented run (warm-start state threaded between segments)
    matches the uninterrupted rollout closely. The solver state is
    exactly the generic engine's (s, w) contract."""
    T = 60
    ctrl = _golden_controller(golden, "CONVEX")
    op = compute_admm_operator_np(ctrl.spec)
    plant32 = _plant32()
    B = 2
    tile = lambda a: jnp.tile(  # noqa: E731
        jnp.asarray(a, jnp.float32)[None],
        (B,) + (1,) * np.asarray(a).ndim,
    )
    W = tile(golden["w_sys"][:T])
    kw = dict(n=4, m=2, p=2, iters=CONVEX_ITERS)
    full = make_fused_admm_rollout(
        plant32, op, n_steps=T, cold_iters=24, **kw
    )(tile(golden["x0"]), tile(golden["CONVEX_u_past0"]),
      tile(golden["CONVEX_y_past0"]), W)
    seg1 = make_fused_admm_rollout(
        plant32, op, n_steps=30, cold_iters=24, **kw
    )(tile(golden["x0"]), tile(golden["CONVEX_u_past0"]),
      tile(golden["CONVEX_y_past0"]), W[:, :30])
    seg2 = make_fused_admm_rollout(
        plant32, op, n_steps=30, cold_iters=0, **kw
    )(
        seg1.x_final, seg1.u_past, seg1.y_past, W[:, 30:],
        solver_state0=(seg1.solver_state.s, seg1.solver_state.w),
    )
    joined = np.concatenate(
        [np.asarray(seg1.u_sys), np.asarray(seg2.u_sys)], axis=1
    )
    assert np.abs(joined - np.asarray(full.u_sys)).max() < 1e-5


def test_fused_admm_setpoints_dr0_bit_identical(golden):
    """A constant schedule AT the baked setpoints (dr = 0) must leave
    the applied inputs and solver state BIT-identical to the plain
    engine (the dr channels add exact zeros; only the cost features
    ride a differently-factored -- equal-valued -- quadratic)."""
    ctrl = _golden_controller(golden, "CONVEX")
    op = compute_admm_operator_np(ctrl.spec, return_setpoint_maps=True)
    T = 40
    B = 2
    plant32 = _plant32()
    tile = lambda a: jnp.tile(  # noqa: E731
        jnp.asarray(a, jnp.float32)[None],
        (B,) + (1,) * np.asarray(a).ndim,
    )
    args = (
        tile(golden["x0"]), tile(golden["CONVEX_u_past0"]),
        tile(golden["CONVEX_y_past0"]), tile(golden["w_sys"][:T]),
    )
    kw = dict(
        n=4, m=2, p=2, n_steps=T, iters=CONVEX_ITERS, cold_iters=24,
    )
    plain = make_fused_admm_rollout(plant32, op, **kw)(*args)
    r_bar = np.asarray(op["r_bar"])
    tracked = make_fused_admm_rollout(
        plant32, op, setpoints=r_bar, **kw
    )(*args)
    np.testing.assert_array_equal(
        np.asarray(tracked.u_sys), np.asarray(plain.u_sys)
    )
    np.testing.assert_array_equal(
        np.asarray(tracked.solver_state.s),
        np.asarray(plain.solver_state.s),
    )
    np.testing.assert_allclose(
        np.asarray(tracked.costs), np.asarray(plain.costs),
        rtol=1e-3, atol=1e-5,
    )


def test_fused_admm_setpoint_schedule_matches_reinit(golden):
    """A stepped setpoint schedule through the fused ADMM engine must
    match 'reinit per change' -- a segmented run whose second segment
    uses an operator REBUILT from a controller constructed at the new
    setpoints, warm-start state threaded across (the reference's
    retargeting semantics, ref :945-982, minus its full re-init
    cost). Scaling an equilibrium pair keeps it an equilibrium (LTI).
    """
    T, T1 = 40, 20
    B = 2
    scale = 0.7
    ctrl = _golden_controller(golden, "CONVEX")
    op = compute_admm_operator_np(ctrl.spec, return_setpoint_maps=True)
    r_bar = np.asarray(op["r_bar"])
    r2 = scale * r_bar
    plant32 = _plant32()
    tile = lambda a: jnp.tile(  # noqa: E731
        jnp.asarray(a, jnp.float32)[None],
        (B,) + (1,) * np.asarray(a).ndim,
    )
    W = tile(golden["w_sys"][:T])
    args = (
        tile(golden["x0"]), tile(golden["CONVEX_u_past0"]),
        tile(golden["CONVEX_y_past0"]), W,
    )
    kw = dict(n=4, m=2, p=2, iters=CONVEX_ITERS)

    sched = np.concatenate(
        [np.tile(r_bar, (T1, 1)), np.tile(r2, (T - T1, 1))]
    )
    tracked = make_fused_admm_rollout(
        plant32, op, n_steps=T, cold_iters=24, setpoints=sched, **kw
    )(*args)

    # Reinit path: second controller BUILT at the new setpoints.
    ctrl2 = DirectDataDrivenMPCController(
        n=4, m=2, p=2, u_d=golden["u_d"], y_d=golden["y_d"], L=30,
        Q=3.0 * np.eye(60), R=1e-4 * np.eye(60),
        u_s=r2[:2].reshape(2, 1), y_s=r2[2:].reshape(2, 1),
        eps_max=0.002, lamb_alpha=0.1 / 0.002, lamb_sigma=1000.0,
        c=float(golden["convex_c"]),
        slack_var_constraint_type=SlackVarConstraintTypes.CONVEX,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
    )
    op2 = compute_admm_operator_np(ctrl2.spec)
    seg1 = make_fused_admm_rollout(
        plant32, op, n_steps=T1, cold_iters=24, **kw
    )(*args[:3], W[:, :T1])
    seg2 = make_fused_admm_rollout(
        plant32, op2, n_steps=T - T1, cold_iters=0, **kw
    )(
        seg1.x_final, seg1.u_past, seg1.y_past, W[:, T1:],
        solver_state0=(seg1.solver_state.s, seg1.solver_state.w),
    )
    joined_u = np.concatenate(
        [np.asarray(seg1.u_sys), np.asarray(seg2.u_sys)], axis=1
    )
    assert np.abs(joined_u - np.asarray(tracked.u_sys)).max() < 1e-4
    joined_c = np.concatenate(
        [np.asarray(seg1.costs), np.asarray(seg2.costs)], axis=1
    )
    np.testing.assert_allclose(
        np.asarray(tracked.costs), joined_c, rtol=1e-3, atol=1e-4
    )
    # The retarget must actually move the tracked outputs toward the
    # scaled target (not a no-op schedule).
    y_end = np.asarray(tracked.y_sys)[:, -1]
    assert np.abs(y_end - r2[2:]).max() < np.abs(
        np.asarray(seg1.y_sys)[:, -1] - r2[2:]
    ).max()


def test_fused_admm_pipeline_parity(golden):
    """The pipeline row-split (independent matmul/update chains inside
    the iteration loop) leaves every row's math unchanged up to the
    backend's per-shape gemm accumulation order (measured ~2e-9 on
    CPU): pipeline=2 vs pipeline=1 within a tight slice of the 1e-4
    parity budget over the full rollout."""
    r1 = _golden_run(golden, "CONVEX", B=4, pipeline=1)
    r2 = _golden_run(golden, "CONVEX", B=4, pipeline=2)
    np.testing.assert_allclose(
        np.asarray(r1.u_sys), np.asarray(r2.u_sys), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(r1.costs), np.asarray(r2.costs), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(r1.solver_state.s), np.asarray(r2.solver_state.s),
        atol=1e-6,
    )


def test_stack6_dot_is_f32_grade():
    """The merged 6-pass stacked dot must be f32-grade: vs a float64
    reference its error is within 4x the native f32 HIGHEST dot's on
    ill-scaled operands (and orders of magnitude below 3-pass)."""
    from direct_data_driven_mpc_jax.ops.fused_admm import (
        _dot3,
        _dot6s,
        _stack3,
        _stack6,
    )

    rng = np.random.default_rng(7)
    a = (rng.standard_normal((64, 48)) * 10.0 ** rng.integers(
        -3, 3, (64, 48))).astype(np.float32)
    b = (rng.standard_normal((48, 96)) * 10.0 ** rng.integers(
        -3, 3, (48, 96))).astype(np.float32)
    ref = np.asarray(a, np.float64) @ np.asarray(b, np.float64)
    scale = np.abs(ref).max()
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    err6s = np.abs(
        np.asarray(_dot6s(aj, _stack6(bj))) - ref
    ).max() / scale
    err_hi = np.abs(
        np.asarray(
            jnp.matmul(aj, bj, precision=jax.lax.Precision.HIGHEST)
        ) - ref
    ).max() / scale
    err3 = np.abs(
        np.asarray(_dot3(aj, _stack3(bj))) - ref
    ).max() / scale
    assert err6s < 4 * max(err_hi, 1e-9), (err6s, err_hi)
    assert err6s < err3 / 10, (err6s, err3)


def test_pack_factor_and_ladder_rejection(golden):
    assert pick_pack_factor(60) == 2
    assert pick_pack_factor(30) == 4
    assert pick_pack_factor(200) == 1
    ctrl = _golden_controller(golden, "BOX")
    ladder_op = compute_box_admm_operator_np(
        ctrl.spec, u_bounds=(-0.85, 0.85)
    )  # default: 7-rung ladder
    with pytest.raises(ValueError, match="SINGLE-rung"):
        build_fused_admm_operator(_plant32(), ladder_op, n=4, m=2, p=2)


def test_sharded_fused_admm_matches_unsharded(golden):
    """The fused ADMM engine under shard_map over the virtual 8-device
    mesh reproduces the unsharded engine and psum-reduces the metrics."""
    from direct_data_driven_mpc_jax.parallel.mesh import (
        make_scenario_mesh,
        make_sharded_fused_admm_rollout,
    )

    mesh = make_scenario_mesh(n_data=4, n_model=2)
    ctrl = _golden_controller(golden, "CONVEX")
    op = compute_admm_operator_np(ctrl.spec)
    T, B = 40, 8
    plant32 = _plant32()
    tile = lambda a: jnp.tile(  # noqa: E731
        jnp.asarray(a, jnp.float32)[None],
        (B,) + (1,) * np.asarray(a).ndim,
    )
    rng = np.random.default_rng(1)
    args = (
        tile(golden["x0"]),
        tile(golden["CONVEX_u_past0"]),
        tile(golden["CONVEX_y_past0"]),
        jnp.asarray(
            0.002 * rng.uniform(-1, 1, (B, T, 2)), jnp.float32
        ),
    )
    kw = dict(
        n=4, m=2, p=2, n_steps=T, iters=CONVEX_ITERS, cold_iters=24,
    )
    sharded = make_sharded_fused_admm_rollout(mesh, plant32, op, **kw)
    res_s, metrics = sharded(*args)
    ref = make_fused_admm_rollout(plant32, op, **kw)(*args)
    # Per-shard batches change the dispatch shapes, so f32 rounding
    # differs slightly and the loop amplifies it ~60x (measured
    # sensitivity); well inside the 1e-4 budget, not bitwise.
    np.testing.assert_allclose(
        np.asarray(res_s.u_sys), np.asarray(ref.u_sys), atol=5e-5
    )
    np.testing.assert_allclose(
        np.asarray(res_s.solver_state.s),
        np.asarray(ref.solver_state.s), atol=5e-5,
    )
    assert float(metrics["frac_converged"]) == 1.0
    np.testing.assert_allclose(
        float(metrics["mean_final_cost"]),
        float(np.asarray(ref.costs[:, -1]).mean()), rtol=5e-5,
    )


@pytest.mark.parametrize("L,expected_q", [(8, 4), (40, 1)])
def test_fused_admm_pack_factors(L, expected_q):
    """The packing generalizes: q=4 (nbox <= 32) and q=1 (nbox > 64)
    paths must match the generic engine too (the golden configs only
    exercise q=2)."""
    from direct_data_driven_mpc_jax.models.lti_model import LTIModel

    rng = np.random.default_rng(3)
    plant_model = LTIModel(
        A=np.array([[0.9, 0.2], [0.0, 0.8]]),
        B=np.array([[0.0], [1.0]]),
        C=np.array([[1.0, 0.3], [0.2, 0.5]]),
        D=np.zeros((2, 1)),
        eps_max=0.002,
    )
    n, m, p, N = 2, 1, 2, 30 + 4 * L
    u_d = rng.uniform(-1, 1, (N, m))
    w_d = 0.002 * rng.uniform(-1, 1, (N, p))
    y_d = plant_model.simulate(u_d, w_d, N)
    u_s = np.array([[0.5]])
    y_s = plant_model.get_equilibrium_output_from_input(
        np.array([0.5])
    ).reshape(-1, 1)
    ctrl = DirectDataDrivenMPCController(
        n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(p * L), R=1e-4 * np.eye(m * L),
        u_s=u_s, y_s=y_s,
        eps_max=0.002, lamb_alpha=50.0, lamb_sigma=1000.0, c=0.1,
        slack_var_constraint_type=SlackVarConstraintTypes.CONVEX,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
    )
    op = compute_admm_operator_np(ctrl.spec)
    nbox = op["v_c"].shape[0]
    assert pick_pack_factor(nbox) == expected_q, (L, nbox)
    params32 = plant_model.as_params(dtype=np.float32)
    T, B = 24, 4
    x0s = jnp.tile(
        jnp.asarray(plant_model.get_state(), jnp.float32)[None], (B, 1)
    )
    ups = jnp.tile(
        jnp.asarray(ctrl.u_past.reshape(n, m), jnp.float32)[None],
        (B, 1, 1),
    )
    yps = jnp.tile(
        jnp.asarray(ctrl.y_past.reshape(n, p), jnp.float32)[None],
        (B, 1, 1),
    )
    W = jnp.asarray(0.002 * rng.uniform(-1, 1, (B, T, p)), jnp.float32)
    sol = ctrl.admm_solver(dtype=jnp.float32)
    ref = jax.vmap(
        lambda a, b, c, w: closed_loop_rollout(
            params32, sol, a, b, c, w, n_steps=T, admm_iters=80
        )
    )(x0s, ups, yps, W)
    # Schedules are config-specific; this test checks PACKING, so a
    # generous schedule + the f32-budget tolerance.
    run = make_fused_admm_rollout(
        params32, op, n=n, m=m, p=p, n_steps=T, iters=(0, 16, 6),
        cold_iters=60, tol=1e-4,
    )
    res = run(x0s, ups, yps, W)
    assert np.abs(
        np.asarray(res.u_sys) - np.asarray(ref.u_sys)
    ).max() < 1e-4
    assert float(np.asarray(res.converged).mean()) == 1.0
    assert res.u_sys.shape == (B, T, m)
    assert res.solver_state.s.shape == (B, nbox)


def test_fused_ladder_matches_golden(golden):
    """The ADAPTIVE-ladder fused engine must reproduce the f64
    active-set golden on the saturated box -- starting from the
    DEFAULT middle rung, the batch-shared residual balancer must climb
    to the saturated regime's rung and converge every solve."""
    ctrl = _golden_controller(golden, "BOX")
    ladder_op = compute_box_admm_operator_np(
        ctrl.spec,
        u_bounds=(-float(golden["u_box"]), float(golden["u_box"])),
    )  # default 7-rung ladder
    assert ladder_op["rhos"].shape[0] > 1
    T = golden["BOX_u"].shape[0]
    B = 2
    tile = lambda a: jnp.tile(  # noqa: E731
        jnp.asarray(a, jnp.float32)[None],
        (B,) + (1,) * np.asarray(a).ndim,
    )
    run = make_fused_ladder_rollout(
        _plant32(), ladder_op, n=4, m=2, p=2, n_steps=T,
        iters=BOX_ITERS, cold_iters=60, tol=2e-5,
    )
    res = run(
        tile(golden["x0"]), tile(golden["BOX_u_past0"]),
        tile(golden["BOX_y_past0"]), tile(golden["w_sys"][:T]),
    )
    du = np.abs(np.asarray(res.u_sys) - golden["BOX_u"][None]).max()
    assert du < 1e-4, du
    conv = np.asarray(res.converged)
    # The balancer may spend the first few solves climbing rungs; the
    # settled trajectory must be fully converged.
    assert conv[:, 5:].all(), conv.mean()
    assert np.abs(np.asarray(res.u_sys)).max() <= float(
        golden["u_box"]
    ) + 1e-6
    # The rung actually adapted away from the initial middle rung.
    assert int(np.asarray(res.solver_state.rho_idx)[0]) != (
        ladder_op["rhos"].shape[0] // 2
    )


def test_fused_ladder_rung_settles_loose_box():
    """With a LOOSE box (inactive constraint) the balancer must step
    DOWN from the middle rung toward the curvature-scale rung and
    converge -- the regime a fixed saturated-rung rho is >100x too
    stiff for (qp/box.py module docstring)."""
    rng = np.random.default_rng(0)
    plant32 = _plant32()
    n, m, p, N, L = 4, 2, 2, 400, 30
    u_d = rng.uniform(-1, 1, (N, m))
    w_d = 0.002 * rng.uniform(-1, 1, (N, p))
    import numpy as _np

    A = _np.array(
        [
            [0.921, 0, 0.041, 0],
            [0, 0.918, 0, 0.033],
            [0, 0, 0.924, 0],
            [0, 0, 0, 0.937],
        ]
    )
    from direct_data_driven_mpc_jax.models.lti_model import LTIModel

    plant_model = LTIModel(
        A=A,
        B=_np.array(
            [[0.017, 0.001], [0.001, 0.023], [0, 0.061], [0.072, 0]]
        ),
        C=_np.array([[1.0, 0, 0, 0], [0, 1, 0, 0]]),
        D=_np.zeros((2, 2)),
        eps_max=0.002,
    )
    y_d = plant_model.simulate(u_d, w_d, N)
    ctrl = DirectDataDrivenMPCController(
        n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(p * L), R=1e-4 * np.eye(m * L),
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
        eps_max=0.002, lamb_alpha=0.1 / 0.002, lamb_sigma=1000.0,
        c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
    )
    # Box at +-30: NEVER active (the unconstrained transient peaks at
    # |u| ~ 21), so the ladder solves the unconstrained QP.
    ladder_op = compute_box_admm_operator_np(
        ctrl.spec, u_bounds=(-30.0, 30.0)
    )
    T, B = 40, 2
    tile = lambda a: jnp.tile(  # noqa: E731
        jnp.asarray(a, jnp.float32)[None],
        (B,) + (1,) * np.asarray(a).ndim,
    )
    args = (
        tile(plant_model.get_state()),
        tile(ctrl.u_past.reshape(n, m)),
        tile(ctrl.y_past.reshape(n, p)),
        tile(0.002 * rng.uniform(-1, 1, (T, p))),
    )
    kw = dict(
        n=4, m=2, p=2, n_steps=T, iters=(0, 14, 4), cold_iters=60,
        tol=2e-5,
    )
    run = make_fused_ladder_rollout(
        plant_model.as_params(dtype=np.float32), ladder_op, **kw
    )
    res = run(*args)
    R = ladder_op["rhos"].shape[0]
    # The balancer walks DOWN from the middle rung toward the
    # curvature-scale rung (one balance step per solve), the regime a
    # fixed saturated-rung rho is >100x too stiff for.
    assert int(np.asarray(res.solver_state.rho_idx)[0]) < R // 2
    assert np.asarray(res.converged)[:, 10:].all()
    # Started AT the right rung (no walk) with a transient-sized
    # iteration budget (the closed-loop transient moves theta fast, so
    # the warm start is far off for the first few solves), every solve
    # converges and the trajectory matches the EXACT unconstrained
    # condensed solve.
    from direct_data_driven_mpc_jax.control.linear_engine import (
        build_linear_engine,
        make_linear_batched_rollout,
    )

    bm = build_linear_engine(ctrl, plant_model.as_params())
    ref = make_linear_batched_rollout(bm, n_steps=T)(*args)
    kw2 = dict(kw, iters=(0, 60, 8))
    res2 = make_fused_ladder_rollout(
        plant_model.as_params(dtype=np.float32), ladder_op,
        init_rung=0, **kw2,
    )(*args)
    assert np.asarray(res2.converged).all()
    assert np.abs(
        np.asarray(res2.u_sys) - np.asarray(ref.u_sys)
    ).max() < 1e-4


def test_fused_ladder_segmented_restart_rung_contract(golden):
    """A segmented ladder restart must resume AT the rung the state's
    w is scaled for: passing the state with a matching init_rung
    reproduces the uninterrupted run closely; a mismatched init_rung
    raises."""
    ctrl = _golden_controller(golden, "BOX")
    ladder_op = compute_box_admm_operator_np(
        ctrl.spec,
        u_bounds=(-float(golden["u_box"]), float(golden["u_box"])),
    )
    T, T1, B = 40, 20, 2
    tile = lambda a: jnp.tile(  # noqa: E731
        jnp.asarray(a, jnp.float32)[None],
        (B,) + (1,) * np.asarray(a).ndim,
    )
    W = tile(golden["w_sys"][:T])
    args = (
        tile(golden["x0"]), tile(golden["BOX_u_past0"]),
        tile(golden["BOX_y_past0"]), W,
    )
    kw = dict(n=4, m=2, p=2, iters=BOX_ITERS, tol=2e-5)
    full = make_fused_ladder_rollout(
        _plant32(), ladder_op, n_steps=T, cold_iters=60, **kw
    )(*args)
    seg1 = make_fused_ladder_rollout(
        _plant32(), ladder_op, n_steps=T1, cold_iters=60, **kw
    )(*args[:3], W[:, :T1])
    idx1 = int(np.asarray(seg1.solver_state.rho_idx)[0])
    seg2 = make_fused_ladder_rollout(
        _plant32(), ladder_op, n_steps=T - T1, cold_iters=0,
        init_rung=idx1, **kw,
    )(
        seg1.x_final, seg1.u_past, seg1.y_past, W[:, T1:],
        solver_state0=seg1.solver_state,
    )
    joined = np.concatenate(
        [np.asarray(seg1.u_sys), np.asarray(seg2.u_sys)], axis=1
    )
    assert np.abs(joined - np.asarray(full.u_sys)).max() < 1e-4
    # Mismatched rung must be refused (the w scaling would be off by
    # a ladder spacing).
    wrong = (idx1 + 1) % ladder_op["rhos"].shape[0]
    with pytest.raises(ValueError, match="scaled for that rung"):
        make_fused_ladder_rollout(
            _plant32(), ladder_op, n_steps=T - T1, cold_iters=0,
            init_rung=wrong, **kw,
        )(
            seg1.x_final, seg1.u_past, seg1.y_past, W[:, T1:],
            solver_state0=seg1.solver_state,
        )

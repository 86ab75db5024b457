"""Tracking-condensed engine: setpoint schedules through the fused
engines (control/linear_engine.py ``tracking_op`` channel +
ops/fused_rollout.py ``setpoints``).

The reference can only retarget by re-running its entire init pipeline
per setpoint change (direct_data_driven_mpc_controller.py:945-982);
the generic loop already tracks per-solve schedules via TrackingMap
(tests/test_tracking.py). Here the schedule rides the CONDENSED fused
engines: the setpoint delta is appended to each block's input lanes
(one ``[u_s; y_s]`` per outer block), so tracking runs at full
fused-engine throughput.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.linear_engine import (
    build_linear_engine,
    build_tracking_engine,
    make_linear_batched_rollout,
)
from direct_data_driven_mpc_jax.control.loop import closed_loop_rollout
from direct_data_driven_mpc_jax.ops.fused_rollout import (
    fused_batched_rollout,
    suggest_solves_per_block,
)

from tests.test_closed_loop import _make_setup

K, B, T = 8, 4, 48


@pytest.fixture(scope="module")
def setup():
    plant, ctrl, rng = _make_setup(n_mpc_step=1)
    plant_params = plant.as_params(dtype=np.float32)
    bm_t = build_tracking_engine(
        ctrl, plant_params, solves_per_block=K, dtype=jnp.float32
    )
    bm = build_linear_engine(
        ctrl, plant_params, solves_per_block=K, dtype=jnp.float32
    )
    x0 = jnp.asarray(plant.get_state(), jnp.float32)
    up = jnp.asarray(ctrl.u_past.reshape(4, 2), jnp.float32)
    yp = jnp.asarray(ctrl.y_past.reshape(4, 2), jnp.float32)
    batch = (
        jnp.tile(x0[None], (B, 1)),
        jnp.tile(up[None], (B, 1, 1)),
        jnp.tile(yp[None], (B, 1, 1)),
        jnp.asarray(0.002 * rng.uniform(-1, 1, (B, T, 2)), jnp.float32),
    )
    r0 = np.concatenate(
        [np.asarray(ctrl.u_s).ravel(), np.asarray(ctrl.y_s).ravel()]
    )
    return plant_params, ctrl, bm, bm_t, (x0, up, yp), batch, r0


def _schedule(r0):
    """Step the setpoint to 0.7x after half the outer blocks."""
    n_outer = T // K
    return np.stack(
        [r0 if i < n_outer // 2 else 0.7 * r0 for i in range(n_outer)]
    )


def test_tracking_map_metadata(setup):
    _, ctrl, bm, bm_t, _, _, r0 = setup
    assert bm.n_r == 0 and bm.r_bar is None
    assert bm_t.n_r == ctrl.m + ctrl.p
    np.testing.assert_allclose(np.asarray(bm_t.r_bar), r0, atol=1e-7)
    # Joint cost: theta block + setpoint channel.
    assert bm_t.cost_P.shape[0] == bm.cost_P.shape[0] + bm_t.n_r


def test_constant_setpoint_reduces_to_plain_engine(setup):
    """At dr = 0 the tracking engine's u/y are BIT-IDENTICAL to the
    plain condensed engine (the dr lanes multiply exact zeros)."""
    _, _, bm, bm_t, _, batch, r0 = setup
    x0s, ups, yps, Ws = batch
    res = fused_batched_rollout(
        bm_t, x0s, ups, yps, Ws, n_steps=T,
        setpoints=jnp.asarray(r0, jnp.float32),
    )
    ref = fused_batched_rollout(
        bm, x0s, ups, yps, Ws, n_steps=T
    )
    np.testing.assert_array_equal(
        np.asarray(res.u_sys), np.asarray(ref.u_sys)
    )
    np.testing.assert_array_equal(
        np.asarray(res.y_sys), np.asarray(ref.y_sys)
    )
    # Costs evaluate through the joint [theta; dr] quadratic (different
    # factorization) -- equal to f32 rounding, not bitwise.
    np.testing.assert_allclose(
        np.asarray(res.costs), np.asarray(ref.costs), rtol=1e-3,
        atol=1e-4,
    )


def test_schedule_matches_generic_tracking_loop(setup):
    """A stepped setpoint schedule through the fused engine must match
    the generic loop driving the SAME schedule through TrackingMap
    (per-solve granularity, constant within each outer block)."""
    plant_params, ctrl, _, bm_t, single, batch, r0 = setup
    x0, up, yp = single
    x0s, ups, yps, Ws = batch
    sched_blocks = _schedule(r0)
    tm = ctrl.tracking_map(dtype=jnp.float32)
    gen = closed_loop_rollout(
        plant_params, tm, x0, up, yp, Ws[0], n_steps=T,
        setpoints=jnp.asarray(np.repeat(sched_blocks, K, axis=0),
                              jnp.float32),
    )
    res = fused_batched_rollout(
        bm_t, x0s, ups, yps, Ws, n_steps=T,
        setpoints=jnp.asarray(sched_blocks, jnp.float32),
    )
    np.testing.assert_allclose(
        np.asarray(res.u_sys[0]), np.asarray(gen.u_sys), atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(res.y_sys[0]), np.asarray(gen.y_sys), atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(res.costs[0]), np.asarray(gen.costs), rtol=1e-3,
        atol=1e-3,
    )
    # The retarget must actually bite: outputs drift toward 0.7*y_s.
    y_late = np.asarray(res.y_sys[0, -1])
    y_early = np.asarray(res.y_sys[0, T // 2 - 1])
    target_late = 0.7 * r0[2:]
    assert np.abs(y_late - target_late).max() < np.abs(
        y_early - target_late
    ).max()


def test_per_scenario_schedules(setup):
    """Each scenario can track its OWN setpoint schedule (a (B,
    n_blocks, n_r) array) -- Monte-Carlo over operating points."""
    _, ctrl, _, bm_t, _, batch, r0 = setup
    x0s, ups, yps, Ws = batch
    n_outer = T // K
    scales = np.linspace(0.6, 1.0, B)
    sched = np.stack(
        [np.tile(s * r0, (n_outer, 1)) for s in scales]
    )  # (B, n_outer, n_r)
    res = fused_batched_rollout(
        bm_t, x0s, ups, yps, Ws, n_steps=T,
        setpoints=jnp.asarray(sched, jnp.float32),
    )
    # Each lane must match its own constant-setpoint run.
    for b in (0, B - 1):
        solo = fused_batched_rollout(
            bm_t, x0s[b : b + 1], ups[b : b + 1], yps[b : b + 1],
            Ws[b : b + 1], n_steps=T,
            setpoints=jnp.asarray(scales[b] * r0, jnp.float32),
        )
        np.testing.assert_array_equal(
            np.asarray(res.u_sys[b]), np.asarray(solo.u_sys[0])
        )


def test_validation(setup):
    _, _, bm, bm_t, _, batch, r0 = setup
    x0s, ups, yps, Ws = batch
    with pytest.raises(ValueError, match="requires a `setpoints`"):
        fused_batched_rollout(
            bm_t, x0s, ups, yps, Ws, n_steps=T
        )
    with pytest.raises(ValueError, match="requires a tracking"):
        fused_batched_rollout(
            bm, x0s, ups, yps, Ws, n_steps=T,
            setpoints=jnp.asarray(r0, jnp.float32),
        )
    with pytest.raises(ValueError, match="requires a `setpoints`"):
        make_linear_batched_rollout(bm_t, n_steps=T)(x0s, ups, yps, Ws)
    with pytest.raises(ValueError, match="require a tracking"):
        make_linear_batched_rollout(
            bm, n_steps=T, setpoints=jnp.asarray(r0, jnp.float32)
        )(x0s, ups, yps, Ws)
    # The block-shape helper accounts for the setpoint lanes.
    assert suggest_solves_per_block(4, 4, 2, 2, n_r=4) == (128 - 24) // 2


def test_sharded_tracking_rollout_matches_unsharded(setup):
    """The tracking engine under shard_map over 8 virtual devices: a
    per-scenario schedule shards over `data` with the other scenario
    arrays and reproduces the unsharded fused rollout."""
    from direct_data_driven_mpc_jax.parallel.mesh import (
        make_scenario_mesh,
        make_sharded_fused_rollout,
    )

    _, _, _, bm_t, _, batch, r0 = setup
    x0s, ups, yps, Ws = batch
    n_outer = T // K
    scales = np.linspace(0.6, 1.0, B)
    sched = jnp.asarray(
        np.stack([np.tile(s * r0, (n_outer, 1)) for s in scales]),
        jnp.float32,
    )
    # B=4 scenarios over 4 data shards (the conftest provides 8
    # virtual devices; use a 4x1 mesh so B divides evenly).
    mesh = make_scenario_mesh(n_data=4, n_model=1)
    run = make_sharded_fused_rollout(
        mesh, bm_t, n_steps=T
    )
    res, metrics = run(x0s, ups, yps, Ws, sched)
    ref = fused_batched_rollout(
        bm_t, x0s, ups, yps, Ws, n_steps=T,
        setpoints=sched,
    )
    np.testing.assert_allclose(
        np.asarray(res.u_sys), np.asarray(ref.u_sys), atol=2e-5
    )
    assert len(res.u_sys.sharding.device_set) == 4
    assert float(metrics["frac_converged"]) == 1.0
    with pytest.raises(ValueError, match="per-scenario"):
        run(x0s, ups, yps, Ws, jnp.asarray(r0, jnp.float32))


def test_tracking_with_nstep_cadence():
    """Algorithm 2 (n_mpc_step = n) with a setpoint schedule: the
    tracking-condensed engine must match the generic TrackingMap loop
    at the n-step solve cadence."""
    plant, ctrl, rng = _make_setup(n_mpc_step=4)
    plant_params = plant.as_params(dtype=np.float32)
    Kn, Tn = 3, 48  # 3 solves/block x 4 steps/solve = 12 steps/block
    bm_t = build_tracking_engine(
        ctrl, plant_params, solves_per_block=Kn, dtype=jnp.float32
    )
    x0 = jnp.asarray(plant.get_state(), jnp.float32)
    up = jnp.asarray(ctrl.u_past.reshape(4, 2), jnp.float32)
    yp = jnp.asarray(ctrl.y_past.reshape(4, 2), jnp.float32)
    Ws = jnp.asarray(
        0.002 * rng.uniform(-1, 1, (1, Tn, 2)), jnp.float32
    )
    r0 = np.concatenate(
        [np.asarray(ctrl.u_s).ravel(), np.asarray(ctrl.y_s).ravel()]
    )
    n_outer = Tn // (Kn * 4)
    sched_blocks = np.stack(
        [r0 if i < n_outer // 2 else 0.8 * r0 for i in range(n_outer)]
    )
    res = fused_batched_rollout(
        bm_t, x0[None], up[None], yp[None], Ws, n_steps=Tn,
        n_mpc_step=4,
        setpoints=jnp.asarray(sched_blocks, jnp.float32),
    )
    tm = ctrl.tracking_map(dtype=jnp.float32)
    gen = closed_loop_rollout(
        plant_params, tm, x0, up, yp, Ws[0], n_steps=Tn, n_mpc_step=4,
        setpoints=jnp.asarray(np.repeat(sched_blocks, Kn, axis=0),
                              jnp.float32),
    )
    np.testing.assert_allclose(
        np.asarray(res.u_sys[0]), np.asarray(gen.u_sys), atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(res.y_sys[0]), np.asarray(gen.y_sys), atol=2e-5
    )


def test_classic_engines_track_schedules(setup):
    """Round-4: the CLASSIC condensed paths (sequential scan engine,
    associative-scan time-parallel engine, batched wrapper) thread
    tracking maps too -- same schedule, same outputs as the fused XLA
    engine (which is itself pinned to the generic TrackingMap loop
    above)."""
    from direct_data_driven_mpc_jax.control.linear_engine import (
        linear_closed_loop_rollout,
        time_parallel_rollout,
    )

    _, _, _, bm_t, _, batch, r0 = setup
    x0s, ups, yps, Ws = batch
    sched = jnp.asarray(_schedule(r0), jnp.float32)
    ref = fused_batched_rollout(
        bm_t, x0s, ups, yps, Ws, n_steps=T,
        setpoints=sched,
    )

    lin = linear_closed_loop_rollout(
        bm_t, x0s[0], ups[0], yps[0], Ws[0], n_steps=T,
        setpoints=sched,
    )
    np.testing.assert_allclose(
        np.asarray(lin.u_sys), np.asarray(ref.u_sys[0]), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(lin.costs), np.asarray(ref.costs[0]), rtol=1e-4,
        atol=1e-4,
    )

    tp = time_parallel_rollout(
        bm_t, x0s[0], ups[0], yps[0], Ws[0], n_steps=T,
        setpoints=sched,
    )
    np.testing.assert_allclose(
        np.asarray(tp.u_sys), np.asarray(lin.u_sys), atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(tp.y_sys), np.asarray(lin.y_sys), atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(tp.costs), np.asarray(lin.costs), rtol=1e-3,
        atol=1e-3,
    )

    # Batched wrapper: shared schedule and per-scenario schedules
    # (vmap regroups the f32 matmuls, so to rounding, not bitwise).
    run = make_linear_batched_rollout(bm_t, n_steps=T, setpoints=sched)
    bat = run(x0s, ups, yps, Ws)
    np.testing.assert_allclose(
        np.asarray(bat.u_sys[0]), np.asarray(lin.u_sys), atol=1e-5
    )
    per_lane = jnp.tile(sched[None], (B, 1, 1))
    run_pl = make_linear_batched_rollout(
        bm_t, n_steps=T, setpoints=per_lane
    )
    bat_pl = run_pl(x0s, ups, yps, Ws)
    np.testing.assert_allclose(
        np.asarray(bat_pl.u_sys), np.asarray(bat.u_sys), atol=1e-6
    )


def test_classic_engines_tracking_at_dr0_bit_exact(setup):
    """At dr = 0 the classic engines on the tracking map reproduce the
    plain condensed map bit-for-bit (u/y; costs to f32 rounding)."""
    from direct_data_driven_mpc_jax.control.linear_engine import (
        linear_closed_loop_rollout,
    )

    _, _, bm, bm_t, _, batch, r0 = setup
    x0s, ups, yps, Ws = batch
    r0f = jnp.asarray(r0, jnp.float32)
    res = linear_closed_loop_rollout(
        bm_t, x0s[0], ups[0], yps[0], Ws[0], n_steps=T, setpoints=r0f
    )
    ref = linear_closed_loop_rollout(
        bm, x0s[0], ups[0], yps[0], Ws[0], n_steps=T
    )
    np.testing.assert_array_equal(
        np.asarray(res.u_sys), np.asarray(ref.u_sys)
    )
    np.testing.assert_array_equal(
        np.asarray(res.y_sys), np.asarray(ref.y_sys)
    )
    np.testing.assert_allclose(
        np.asarray(res.costs), np.asarray(ref.costs), rtol=1e-3,
        atol=1e-4,
    )

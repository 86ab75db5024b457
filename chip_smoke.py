#!/usr/bin/env python
"""End-to-end smoke run of the closed-loop MPC engines on one GPU.

    python chip_smoke.py          # phases A-E on one card
    python chip_smoke.py --four   # the four-card mesh path only

Each phase drives a real workload through the user entry points
(``DirectDataDrivenMPCController`` -> ``build_linear_engine`` /
``build_tracking_engine`` / the fused engines), checks the result
against the repo's own reference (the float64 host controller loop, the
generic scan engine, or the committed active-set golden) and prints one
line: device time of a warm run, compile time, memory, and the largest
deviation. Any failed check raises, so the script exits non-zero; the
last stdout line is the JSON device record, printed only when every
phase passed. Data and noise are made from fixed seeds.

The script refuses to run unless JAX's first device is a GPU: JAX falls
back to the CPU silently when its CUDA plugin fails to load.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np

from direct_data_driven_mpc_jax.models.four_tank import (
    FOUR_TANK_EPS_MAX as EPS_MAX,
    four_tank_plant,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_BOX = os.path.join(ROOT, "tests", "golden", "four_tank_box_golden.npz")
U_S = np.array([[1.0], [1.0]])
Y_S = np.array([[0.65], [0.77]])
N_DATA, HORIZON = 400, 30  # paper scale: nz=571, nc=168
CONVEX_ITERS, BOX_ITERS, LADDER_ITERS = (4, 5, 2), (0, 14, 4), (0, 16, 4)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# set-up helpers
# ---------------------------------------------------------------------------


def paper_controller(slack="NONE", c=1.0, seed=0, u_d=None, y_d=None,
                     **extra):
    """Four-tank Robust controller at the paper scale (N=400, L=30),
    data from ``seed`` unless given."""
    from direct_data_driven_mpc_jax.control.controller import (
        DirectDataDrivenMPCController,
    )
    from direct_data_driven_mpc_jax.qp.spec import (
        DataDrivenMPCType,
        SlackVarConstraintTypes,
    )

    if u_d is None:
        rng = np.random.default_rng(seed)
        u_d = rng.uniform(-1, 1, (N_DATA, 2))
        w_d = EPS_MAX * rng.uniform(-1, 1, (N_DATA, 2))
        y_d = four_tank_plant().simulate(u_d, w_d, N_DATA)
    L = HORIZON
    return DirectDataDrivenMPCController(
        n=4, m=2, p=2, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(2 * L), R=1e-4 * np.eye(2 * L),
        u_s=U_S, y_s=Y_S, eps_max=EPS_MAX,
        lamb_alpha=0.1 / EPS_MAX, lamb_sigma=1000.0, c=c,
        slack_var_constraint_type=getattr(SlackVarConstraintTypes, slack),
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1, **extra,
    )


def batch_inputs(x0, u_past, y_past, B, T, seed=0):
    """Tiled initial state and past window, and bounded uniform noise,
    all f32."""
    import jax
    import jax.numpy as jnp

    from direct_data_driven_mpc_jax.parallel.batch import draw_noise_batch

    f32 = jnp.float32

    def tile(a):
        a = jnp.asarray(np.asarray(a, float), f32)
        return jnp.tile(a[None], (B,) + (1,) * a.ndim)

    Ws = draw_noise_batch(jax.random.key(seed), B, T, 2, EPS_MAX, f32)
    return (tile(x0), tile(np.reshape(u_past, (4, 2))),
            tile(np.reshape(y_past, (4, 2))), Ws)


def host_loop(ctrl, x0, u_past0, y_past0, W):
    """Float64 host controller loop (paper Algorithm 1) on one noise
    sequence: per step solve, apply u*[0], step the plant, shift the
    window. Returns (u, y, costs)."""
    plant = four_tank_plant()
    plant.set_state(np.asarray(x0, float))
    ctrl.set_past_input_output_data(
        np.asarray(u_past0, float).reshape(-1, 1),
        np.asarray(y_past0, float).reshape(-1, 1),
    )
    T = W.shape[0]
    us, ys, cs = np.zeros((T, 2)), np.zeros((T, 2)), np.zeros(T)
    for t in range(T):
        ctrl.update_and_solve_data_driven_mpc()
        cs[t] = ctrl.get_optimal_cost_value()
        us[t] = ctrl.get_optimal_control_input_at_step(0)
        ys[t] = plant.simulate_step(u=us[t], w=W[t])
        ctrl.store_input_output_measurement(
            us[t].reshape(-1, 1), ys[t].reshape(-1, 1)
        )
    return us, ys, cs


def timed(fn, *args):
    """Compile ``fn`` for ``args``, run it twice (the second run is the
    reported device time, ending in ``block_until_ready``). Returns
    (result, stats)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    # Place the inputs where the executable expects them (sharded
    # programs take their inputs split over the mesh).
    args = jax.device_put(args, compiled.input_shardings[0])
    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    t_run = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    exe_bytes = None if ma is None else int(
        ma.temp_size_in_bytes + ma.argument_size_in_bytes
        + ma.output_size_in_bytes
    )
    stats = jax.devices()[0].memory_stats() or {}
    return out, {
        "device_s": t_run, "compile_s": t_compile, "exe_bytes": exe_bytes,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }


def report(name, stats, **dev):
    parts = [f"device {stats['device_s'] * 1e3:.3f} ms",
             f"compile {stats['compile_s']:.2f} s",
             f"exe_bytes {stats['exe_bytes']}",
             f"peak_bytes_in_use {stats['peak_bytes_in_use']}"]
    parts += [f"{k} {v:.3e}" for k, v in dev.items()]
    log(f"[{name}] " + ", ".join(parts))


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def max_dev(a, b):
    return float(np.abs(np.asarray(a, float) - np.asarray(b, float)).max())


def rel_cost_excess(c, c_ref, rtol, atol):
    """max(|c - c_ref| - (atol + rtol |c_ref|)) -- <= 0 passes."""
    c, c_ref = np.asarray(c, float), np.asarray(c_ref, float)
    return float((np.abs(c - c_ref) - (atol + rtol * np.abs(c_ref))).max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_a(batches=(4096, 262144), T=400, K=50, n_check=8):
    """Condensed fused rollout, four-tank Robust, slack NONE, vs the
    float64 host controller loop on the first ``n_check`` scenarios."""
    import jax.numpy as jnp

    from direct_data_driven_mpc_jax.control.linear_engine import (
        build_linear_engine,
    )
    from direct_data_driven_mpc_jax.ops.fused_rollout import (
        make_fused_batched_rollout,
    )

    ctrl = paper_controller()
    check(ctrl.spec.nz == 571 and ctrl.spec.nc == 168,
          f"paper QP size nz={ctrl.spec.nz} nc={ctrl.spec.nc}")
    plant = four_tank_plant()
    x0 = plant.get_state().copy()
    up0, yp0 = ctrl.u_past.copy(), ctrl.y_past.copy()
    bm = build_linear_engine(ctrl, plant.as_params(), solves_per_block=K,
                             dtype=jnp.float32)
    run = make_fused_batched_rollout(bm, n_steps=T)
    for B in batches:
        # The host loops move ctrl's window: always start from up0/yp0.
        args = batch_inputs(x0, up0, yp0, B, T, seed=B)
        res, stats = timed(run, *args)
        W = np.asarray(args[3][:n_check], float)
        du = dy = dc = -np.inf
        for i in range(n_check):
            u, y, c = host_loop(ctrl, x0, up0, yp0, W[i])
            du = max(du, max_dev(res.u_sys[i], u))
            dy = max(dy, max_dev(res.y_sys[i], y))
            dc = max(dc, rel_cost_excess(res.costs[i], c, 1e-3, 1e-5))
        report(f"A condensed B={B} T={T} K={K}", stats,
               max_du=du, max_dy=dy, cost_excess=dc)
        check(du < 1e-4 and dy < 1e-4, f"A: du={du} dy={dy}")
        check(dc <= 0.0, f"A: costs outside rtol 1e-3/atol 1e-5 ({dc})")
        check(bool(np.isfinite(np.asarray(res.costs)).all()), "A: costs")


def phase_b(B=4096, T=400, n_check=4):
    """Tracking engine with a 4-phase setpoint schedule vs the generic
    TrackingMap loop on the first ``n_check`` scenarios."""
    import math

    import jax
    import jax.numpy as jnp

    from direct_data_driven_mpc_jax.control.linear_engine import (
        build_tracking_engine,
    )
    from direct_data_driven_mpc_jax.control.loop import closed_loop_rollout
    from direct_data_driven_mpc_jax.ops.fused_rollout import (
        make_fused_batched_rollout,
        suggest_solves_per_block,
    )

    ctrl = paper_controller()
    plant = four_tank_plant()
    K = suggest_solves_per_block(4, 4, 2, 2, n_steps=T, n_r=4)
    bm_t = build_tracking_engine(ctrl, plant.as_params(),
                                 solves_per_block=K, dtype=jnp.float32)
    n_outer = math.ceil(T / K)
    r0 = np.concatenate([U_S.ravel(), Y_S.ravel()])
    # Alternate the paper setpoint and a 0.85x operating point every
    # two outer blocks.
    sched = np.stack([r0 if (i // 2) % 2 == 0 else 0.85 * r0
                      for i in range(n_outer)])
    args = batch_inputs(plant.get_state(), ctrl.u_past, ctrl.y_past, B, T,
                        seed=1)
    run = make_fused_batched_rollout(bm_t, n_steps=T)
    res, stats = timed(run, *args, jnp.asarray(sched, jnp.float32))

    tm = ctrl.tracking_map(dtype=jnp.float32)
    per_solve = jnp.asarray(np.repeat(sched, K, axis=0)[:T], jnp.float32)
    params = plant.as_params(dtype=np.float32)
    gen = jax.jit(jax.vmap(
        lambda x0, up, yp, w: closed_loop_rollout(
            params, tm, x0, up, yp, w, n_steps=T, setpoints=per_solve)
    ))(*(a[:n_check] for a in args))
    du = max_dev(res.u_sys[:n_check], gen.u_sys)
    dy = max_dev(res.y_sys[:n_check], gen.y_sys)
    dc = rel_cost_excess(res.costs[:n_check], gen.costs, 1e-3, 1e-5)
    report(f"B tracking B={B} T={T} K={K}", stats,
           max_du=du, max_dy=dy, cost_excess=dc)
    check(du < 1e-4 and dy < 1e-4, f"B: du={du} dy={dy}")
    check(dc <= 0.0, f"B: costs outside rtol 1e-3/atol 1e-5 ({dc})")


def _golden_batch(golden, scheme, B, T):
    """Batch whose row 0 replays the golden scenario (its first
    ``len(w_sys)`` noise steps); other rows and later steps draw fresh
    bounded noise."""
    import jax.numpy as jnp

    x0s, ups, yps, Ws = batch_inputs(
        golden["x0"], golden[f"{scheme}_u_past0"],
        golden[f"{scheme}_y_past0"], B, T, seed=2)
    Tg = min(T, golden["w_sys"].shape[0])
    Ws = Ws.at[0, :Tg].set(jnp.asarray(golden["w_sys"][:Tg], jnp.float32))
    return (x0s, ups, yps, Ws), Tg


def _golden_check(name, res, golden, scheme, Tg, conv_from=0):
    du = max_dev(res.u_sys[0, :Tg], golden[f"{scheme}_u"][:Tg])
    dc = rel_cost_excess(res.costs[0, :Tg], golden[f"{scheme}_costs"][:Tg],
                         5e-3, 1e-3)
    conv = float(np.asarray(res.converged)[:, conv_from:].mean())
    check(du < 1e-4, f"{name}: golden du={du}")
    check(dc <= 0.0, f"{name}: golden costs outside rtol 5e-3/atol 1e-3")
    check(conv == 1.0, f"{name}: converged fraction {conv}")
    return du, dc, conv


def phase_c(B=65536, T=400):
    """Fused ADMM engine, CONVEX slack (q=2), row 0 vs the golden."""
    from direct_data_driven_mpc_jax.ops.fused_admm import (
        make_fused_admm_rollout,
    )
    from direct_data_driven_mpc_jax.qp.admm import compute_admm_operator_np

    golden = np.load(GOLDEN_BOX)
    ctrl = paper_controller("CONVEX", c=float(golden["convex_c"]),
                            u_d=golden["u_d"], y_d=golden["y_d"])
    run = make_fused_admm_rollout(
        four_tank_plant().as_params(dtype=np.float32),
        compute_admm_operator_np(ctrl.spec), n=4, m=2, p=2, n_steps=T,
        iters=CONVEX_ITERS, cold_iters=24, tol=1e-5,
    )
    args, Tg = _golden_batch(golden, "CONVEX", B, T)
    res, stats = timed(run, *args)
    du, dc, conv = _golden_check("C", res, golden, "CONVEX", Tg)
    report(f"C fused-admm convex B={B} T={T} iters={CONVEX_ITERS}", stats,
           golden_du=du, cost_excess=dc, converged=conv)


def phase_d(B=65536, T=400):
    """Input box |u| <= 0.85: fixed-rho fused engine, then the adaptive
    ladder engine (converged from solve 10 on), row 0 vs the golden."""
    from direct_data_driven_mpc_jax.ops.fused_admm import (
        make_fused_admm_rollout,
        make_fused_ladder_rollout,
    )
    from direct_data_driven_mpc_jax.qp.box import (
        compute_box_admm_operator_np,
    )

    golden = np.load(GOLDEN_BOX)
    ctrl = paper_controller("NONE", u_d=golden["u_d"], y_d=golden["y_d"])
    ub = float(golden["u_box"])
    params = four_tank_plant().as_params(dtype=np.float32)
    args, Tg = _golden_batch(golden, "BOX", B, T)
    kw = dict(n=4, m=2, p=2, n_steps=T, tol=2e-5)

    fixed = make_fused_admm_rollout(
        params, compute_box_admm_operator_np(ctrl.spec, (-ub, ub), rho=1.0),
        iters=BOX_ITERS, cold_iters=60, **kw,
    )
    res, stats = timed(fixed, *args)
    du, dc, conv = _golden_check("D fixed", res, golden, "BOX", Tg)
    u_max = float(np.abs(np.asarray(res.u_sys)).max())
    check(u_max <= ub + 1e-6, f"D fixed: |u| {u_max} above the box")
    report(f"D box fixed-rho B={B} T={T} iters={BOX_ITERS}", stats,
           golden_du=du, cost_excess=dc, converged=conv)

    ladder = make_fused_ladder_rollout(
        params, compute_box_admm_operator_np(ctrl.spec, (-ub, ub)),
        iters=LADDER_ITERS, cold_iters=80, **kw,
    )
    res, stats = timed(ladder, *args)
    du, dc, conv = _golden_check("D ladder", res, golden, "BOX", Tg,
                                 conv_from=10)
    report(f"D box ladder B={B} T={T} iters={LADDER_ITERS}", stats,
           golden_du=du, cost_excess=dc, converged_from_10=conv)


def phase_e(B=4096, T=100, n_check=4, admm_iters=60):
    """Generic scan engine (control/loop.py), NON_CONVEX slack (paper
    Eq. 6d), vs the float64 host controller loop."""
    import jax.numpy as jnp

    from direct_data_driven_mpc_jax.parallel.batch import (
        make_batched_rollout,
    )

    # c=0.05 makes the Eq. 6d bound material on this plant.
    ctrl = paper_controller("NON_CONVEX", c=0.05,
                            allow_nonconvex_slack=True)
    plant = four_tank_plant()
    x0 = plant.get_state().copy()
    up0, yp0 = ctrl.u_past.copy(), ctrl.y_past.copy()
    run = make_batched_rollout(
        plant.as_params(dtype=np.float32),
        ctrl.nonconvex_admm_solver(dtype=jnp.float32), n_steps=T,
        admm_iters=admm_iters,
    )
    args = batch_inputs(x0, up0, yp0, B, T, seed=3)
    res, stats = timed(run, *args)
    W = np.asarray(args[3][:n_check], float)
    du = -np.inf
    for i in range(n_check):
        # A fresh controller per scenario: the host solver warm-starts
        # across steps.
        ref = paper_controller("NON_CONVEX", c=0.05,
                               allow_nonconvex_slack=True)
        u, _, _ = host_loop(ref, x0, up0, yp0, W[i])
        du = max(du, max_dev(res.u_sys[i], u))
    conv = float(np.asarray(res.converged).mean())
    report(f"E generic non-convex B={B} T={T} iters={admm_iters}", stats,
           max_du=du, converged=conv)
    check(du < 1e-4, f"E: du={du}")
    check(conv == 1.0, f"E: converged fraction {conv}")


def four_cards(batches=(16384, 1048576), B_admm=262144, T=400,
               B_mesh=4096, T_mesh=100):
    """The multi-card path: data-parallel fused engines on a (4, 1)
    mesh against the same batch on one device, the model-parallel
    generic engine on a (2, 2) mesh against the vmapped run, and the
    alpha-sharded KKT solve."""
    import jax
    import jax.numpy as jnp

    from direct_data_driven_mpc_jax.control.linear_engine import (
        build_linear_engine,
    )
    from direct_data_driven_mpc_jax.ops.fused_admm import (
        make_fused_admm_rollout,
    )
    from direct_data_driven_mpc_jax.ops.fused_rollout import (
        make_fused_batched_rollout,
    )
    from direct_data_driven_mpc_jax.parallel.batch import (
        make_batched_rollout,
    )
    from direct_data_driven_mpc_jax.parallel.mesh import (
        make_mesh_rollout,
        make_scenario_mesh,
        make_sharded_fused_admm_rollout,
        make_sharded_fused_rollout,
    )
    from direct_data_driven_mpc_jax.qp.admm import compute_admm_operator_np
    from direct_data_driven_mpc_jax.qp.distributed import (
        make_distributed_kkt_solver,
    )
    from direct_data_driven_mpc_jax.qp.solution_map import solve_u

    dev0 = jax.devices()[0]

    def sharded_du(a_sharded, b_single):
        # Compare shard by shard on device 0 (no full host copy).
        du = 0.0
        for sh in a_sharded.addressable_shards:
            part = jax.device_put(sh.data, dev0)
            du = max(du, float(jnp.abs(part - b_single[sh.index]).max()))
        return du

    data_mesh = make_scenario_mesh(n_data=4, n_model=1)
    ctrl = paper_controller()
    plant = four_tank_plant()
    x0 = plant.get_state()
    bm = build_linear_engine(ctrl, plant.as_params(), solves_per_block=50,
                             dtype=jnp.float32)
    sharded = make_sharded_fused_rollout(data_mesh, bm, n_steps=T)
    single = make_fused_batched_rollout(bm, n_steps=T)
    for B in batches:
        args = batch_inputs(x0, ctrl.u_past, ctrl.y_past, B, T, seed=B)
        (res_s, metrics), stats = timed(sharded, *args)
        res_u, _ = timed(single, *args)
        du = sharded_du(res_s.u_sys, res_u.u_sys)
        report(f"4x condensed mesh=(4,1) B={B} T={T}", stats, max_du=du,
               frac_converged=float(metrics["frac_converged"]))
        check(du <= 1e-5, f"4x condensed: du={du}")
        del res_s, res_u, args

    golden = np.load(GOLDEN_BOX)
    ctrl_c = paper_controller("CONVEX", c=float(golden["convex_c"]),
                              u_d=golden["u_d"], y_d=golden["y_d"])
    op = compute_admm_operator_np(ctrl_c.spec)
    params = plant.as_params(dtype=np.float32)
    kw = dict(n=4, m=2, p=2, n_steps=T, iters=CONVEX_ITERS,
              cold_iters=24, tol=1e-5)
    args, _ = _golden_batch(golden, "CONVEX", B_admm, T)
    (res_s, metrics), stats = timed(
        make_sharded_fused_admm_rollout(data_mesh, params, op, **kw), *args)
    res_u, _ = timed(make_fused_admm_rollout(params, op, **kw), *args)
    du = sharded_du(res_s.u_sys, res_u.u_sys)
    frac = float(metrics["frac_converged"])
    report(f"4x fused-admm mesh=(4,1) B={B_admm} T={T}", stats,
           max_du=du, frac_converged=frac)
    # The per-device batch changes the matmul shapes, so f32 rounding
    # differs in the last bits and the warm-started fixed point carries
    # it forward: the repo's sharded-ADMM parity budget
    # (tests/test_fused_admm.py) applies, not bit-equality.
    check(du <= 5e-5, f"4x fused-admm: du={du}")
    check(frac == 1.0, f"4x fused-admm: converged fraction {frac}")
    del res_s, res_u, args

    mesh22 = make_scenario_mesh(n_data=2, n_model=2)
    sol = ctrl.solution_map(dtype=jnp.float32)
    args = batch_inputs(x0, ctrl.u_past, ctrl.y_past, B_mesh, T_mesh,
                        seed=5)
    (res_m, metrics), stats = timed(
        make_mesh_rollout(mesh22, params, sol, n_steps=T_mesh,
                          model_parallel=True), *args)
    ref, _ = timed(make_batched_rollout(params, sol, n_steps=T_mesh), *args)
    du = sharded_du(res_m.u_sys, ref.u_sys)
    report(f"4x generic mesh=(2,2) model-parallel B={B_mesh} T={T_mesh}",
           stats, max_du=du)
    check(du < 1e-4, f"4x model-parallel: du={du}")

    # The small Robust problem of __graft_entry__.dryrun_multichip
    # (n=2, m=p=1, L=6, N=30): in float32 MINRES meets the 1e-4 budget
    # there, while the paper-scale KKT is too ill-conditioned for it.
    from direct_data_driven_mpc_jax.control.controller import (
        DirectDataDrivenMPCController,
    )
    from direct_data_driven_mpc_jax.models.lti_model import LTIModel
    from direct_data_driven_mpc_jax.qp.spec import (
        DataDrivenMPCType,
        SlackVarConstraintTypes,
    )

    small = LTIModel(A=np.array([[0.9, 0.2], [0.0, 0.8]]),
                     B=np.array([[0.0], [1.0]]), C=np.array([[1.0, 0.3]]),
                     D=np.array([[0.1]]), eps_max=EPS_MAX)
    rng = np.random.default_rng(0)
    u_d = rng.uniform(-1, 1, (30, 1))
    y_d = small.simulate(u_d, EPS_MAX * rng.uniform(-1, 1, (30, 1)), 30)
    ctrl_s = DirectDataDrivenMPCController(
        n=2, m=1, p=1, u_d=u_d, y_d=y_d, L=6,
        Q=3.0 * np.eye(6), R=1e-4 * np.eye(6), u_s=np.array([[0.5]]),
        y_s=small.get_equilibrium_output_from_input(
            np.array([0.5])).reshape(-1, 1),
        eps_max=EPS_MAX, lamb_alpha=50.0, lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
    )
    kkt_mesh = make_scenario_mesh(n_data=1, n_model=4)
    solve = make_distributed_kkt_solver(ctrl_s.spec, kkt_mesh,
                                        axis="model", dtype=jnp.float32,
                                        refine=1)
    theta = jnp.asarray(
        np.concatenate([ctrl_s.u_past.ravel(), ctrl_s.y_past.ravel()]),
        jnp.float32)
    (u_dist, res, iters), stats = timed(solve, theta)
    du = max_dev(u_dist, solve_u(ctrl_s.solution_map(jnp.float32), theta))
    report(f"4x alpha-sharded KKT mesh=(1,4) nz={ctrl_s.spec.nz}", stats,
           residual=float(res), max_du=du, iters=float(iters))
    check(float(res) < 1e-4 and du < 1e-4, f"KKT: res={res} du={du}")


PHASES = {"A": phase_a, "B": phase_b, "C": phase_c, "D": phase_d,
          "E": phase_e}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh path")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    d0 = devices[0]
    if d0.platform != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU; JAX's first device is platform "
            f"{d0.platform!r} ({d0.device_kind})"
        )
    need = 4 if args.four else 1
    if len(devices) < need:
        raise SystemExit(f"need {need} GPUs, JAX sees {len(devices)}")

    from direct_data_driven_mpc_jax.utils.compile_cache import (
        enable_compile_cache,
    )

    log(f"compile cache: {enable_compile_cache()}")
    log(f"devices: {len(devices)} x {d0.device_kind}; jax {jax.__version__}")
    t0 = time.perf_counter()
    if args.four:
        four_cards()
    else:
        for name, fn in PHASES.items():
            t1 = time.perf_counter()
            fn()
            log(f"phase {name} done in {time.perf_counter() - t1:.1f} s")
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()

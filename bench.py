#!/usr/bin/env python
"""Benchmark: closed-loop QP solves/s, four-tank Robust scheme.

Default run: a Monte-Carlo batch (262144 scenarios x 400 closed-loop
steps) of the paper's four-tank Robust controller (571-variable QP per
step, one QP solve per step), executed in this process by the fused
condensed rollout (ops/fused_rollout.py). Engines run float32 with the
parity-bound matmuls at ``Precision.HIGHEST``. Solves are counted per
QP solve; every solve's applied input, measured output, and optimal
cost are produced, and every timing ends in ``block_until_ready``.
``python bench.py four_tank_robust <B>`` sets another batch size.

Baseline anchor: the reference implementation re-canonicalizes and
re-solves a CVXPY problem every step on one CPU core. CVXPY is not
installed here, so the anchor measured here is a GENEROUS stand-in: a
single-core NumPy re-solve of the full KKT system from scratch each step
(dense factorize + solve, no canonicalization overhead). Real CVXPY
per-step time is strictly larger, so the reported ``vs_baseline`` ratio
UNDERSTATES the true speedup vs the reference.

Extra configs:
    python bench.py long_horizon      # L=60, N=800
    python bench.py large_plant       # 65536 scenarios, 10x10 plant
    python bench.py four_tank_convex  # CONVEX slack: fused ADMM engine
    python bench.py four_tank_nonconvex  # NON_CONVEX slack (Eq. 6d):
                                      # convex-concave fixed point in
                                      # the generic scan engine
    python bench.py four_tank_box     # saturated actuator box
                                      # |u| <= 0.85, fixed-rho fused
                                      # ADMM engine
    python bench.py four_tank_ladder  # the same box with the ADAPTIVE
                                      # penalty ladder (qp/box.py
                                      # default) in the fused engine
    python bench.py four_tank_admm_tracking  # setpoint schedule
                                      # through the fused ADMM engine
    python bench.py four_tank_convex_q4  # L=15 -> pack factor 4
    python bench.py long_horizon_convex  # L=60 -> pack factor 1
    python bench.py four_tank_convex_generic  # generic scan engine
    python bench.py four_tank_box_generic     # generic scan engine
    python bench.py tracking          # time-varying setpoint schedule
                                      # through the fused condensed
                                      # engine

Prints the device (platform, kind, count) on stderr and exactly one
JSON line on stdout:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
     "device": {"platform": ..., "kind": ..., "count": N}}
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from direct_data_driven_mpc_jax.models.four_tank import four_tank_plant


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def measure_baseline_single_core(
    spec, theta, n_solves: int = 30, n_trials: int = 7
) -> float:
    """Single-core reference-style per-step work: rebuild + dense-solve
    the full KKT system from scratch each step. Returns solves/s.

    BLAS is pinned to ONE thread (the anchor is defined as single-core
    work; multi-threaded BLAS made it load-dependent) and the anchor is
    the median over ``n_trials`` independent timings. The measurement
    context (loadavg, trial spread, whether BLAS was pinned) is logged
    to stderr.
    """
    import os
    import statistics

    nz, nc = spec.nz, spec.nc

    def one_trial() -> float:
        t0 = time.perf_counter()
        for _ in range(n_solves):
            K = np.zeros((nz + nc, nz + nc))
            K[:nz, :nz] = spec.H
            K[:nz, nz:] = spec.A.T
            K[nz:, :nz] = spec.A
            rhs = np.concatenate(
                [-spec.g, spec.b_const + spec.S @ theta]
            )
            z = np.linalg.solve(K + 1e-12 * np.eye(nz + nc), rhs)
            _ = z[spec.u_pred_slice]
        return n_solves / (time.perf_counter() - t0)

    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        threadpool_limits = None
    if threadpool_limits is not None:
        with threadpool_limits(limits=1):
            one_trial()  # warmup (page-in, BLAS init)
            rates = [one_trial() for _ in range(n_trials)]
    else:
        one_trial()
        rates = [one_trial() for _ in range(n_trials)]
    anchor = float(statistics.median(rates))
    ctx = {
        "anchor_solves_per_s": round(anchor, 2),
        "trials": [round(r, 2) for r in rates],
        "n_solves_per_trial": n_solves,
        "blas_single_thread": threadpool_limits is not None,
        "loadavg_1m": round(os.getloadavg()[0], 2),
        "kkt_dim": nz + nc,
    }
    log(f"baseline anchor context: {json.dumps(ctx)}")
    return anchor


def make_amortized_linear_run(bm, n_steps, eps_max, emit_traj):
    """One jitted call running R back-to-back batched rollouts of the
    classic condensed engine (control/linear_engine.py).

    R is a TRACED fori_loop trip count, so one compile serves every R --
    the same executable is timed at R=1 and R=R_big and the per-call
    constant falls out of the difference. Repetition i folds i into
    every scenario's noise key (a fresh Monte-Carlo realization per rep
    -- nothing is CSE-able) and every repetition's trajectories, costs
    and final states are reduced into a carried checksum so no work can
    be dead-code-eliminated.
    """
    import jax
    import jax.numpy as jnp

    from direct_data_driven_mpc_jax.control.linear_engine import (
        linear_closed_loop_rollout,
    )

    def run(x0s, ups, yps, keys, R):
        def one_rep(i, carry):
            checksum, ok = carry

            def one(x0, up, yp, k):
                return linear_closed_loop_rollout(
                    bm, x0, up, yp,
                    n_steps=n_steps,
                    noise_key=jax.random.fold_in(k, i),
                    eps_max=eps_max,
                    emit_trajectories=emit_traj,
                )

            res = jax.vmap(one)(x0s, ups, yps, keys)
            checksum = (
                checksum
                + jnp.sum(res.costs[:, -1])
                + jnp.sum(res.x_final)
            )
            if emit_traj:
                checksum = checksum + jnp.sum(res.u_sys) + jnp.sum(
                    res.y_sys
                )
            ok = ok & jnp.all(res.converged) & jnp.isfinite(checksum)
            return (checksum, ok)

        return jax.lax.fori_loop(
            0, R, one_rep, (jnp.float32(0.0), jnp.bool_(True))
        )

    return jax.jit(run)


#: Longest timed call at ``R_big`` (s): slow configs lower ``R_big`` to
#: fit, or one measurement would run for many minutes.
MAX_TIMED_CALL_S = 20.0


def time_amortized(run_fn, args, R_small: int = 1, R_big: int = 16,
                   reps: int = 2):
    """Time the amortized runner at two R values and decompose wall =
    per_call_overhead + R * per_rep, with ``R_big`` lowered so that one
    call takes at most about ``MAX_TIMED_CALL_S``. Returns a dict of
    timings (s)."""
    import time as _time

    import jax

    def timed(R):
        best = float("inf")
        for _ in range(reps):
            t0 = _time.perf_counter()
            checksum, ok = jax.block_until_ready(run_fn(*args, R))
            best = min(best, _time.perf_counter() - t0)
            if not bool(ok):
                raise RuntimeError("non-finite or non-converged lanes")
        return best

    t_small = timed(R_small)
    R_big = max(R_small + 1,
                min(R_big, int(MAX_TIMED_CALL_S * R_small / t_small)))
    t_big = timed(R_big)
    per_rep = (t_big - t_small) / (R_big - R_small)
    overhead = max(t_small - R_small * per_rep, 0.0)
    return {
        "t_small": t_small,
        "t_big": t_big,
        "R_small": R_small,
        "R_big": R_big,
        "per_rep": per_rep,
        "per_call_overhead": overhead,
        "overhead_frac_of_big": overhead / t_big if t_big else 0.0,
    }


def first_run(run_fn, args) -> None:
    """Compile + one R=1 call; fails on non-finite/non-converged."""
    import jax

    t0 = time.perf_counter()
    checksum, ok = jax.block_until_ready(run_fn(*args, 1))
    log(f"compile + first run (R=1): {time.perf_counter() - t0:.2f}s")
    if not bool(ok):
        raise RuntimeError("non-finite or non-converged lanes")


def log_amortized(tm, B, T) -> float:
    """Log the amortized decomposition; returns solves/s over R_big."""
    solves_per_s = B * T * tm["R_big"] / tm["t_big"]
    log(f"amortized: R={tm['R_small']} {tm['t_small']:.4f}s, "
        f"R={tm['R_big']} {tm['t_big']:.4f}s -> per-rollout "
        f"{tm['per_rep']:.5f}s, per-call overhead "
        f"{tm['per_call_overhead'] * 1e3:.2f} ms "
        f"({tm['overhead_frac_of_big'] * 100:.1f}% of wall); "
        f"{solves_per_s:,.0f} solves/s (per rollout "
        f"{B * T / tm['per_rep']:,.0f})")
    return solves_per_s


def _controller(N, L, plant_model, rng, n, m, p, u_s, y_s, **kw):
    from direct_data_driven_mpc_jax.control.controller import (
        DirectDataDrivenMPCController,
    )
    from direct_data_driven_mpc_jax.qp.spec import (
        DataDrivenMPCType,
        SlackVarConstraintTypes,
    )

    u_d = rng.uniform(-1, 1, (N, m))
    w_d = plant_model.get_eps_max() * rng.uniform(-1, 1, (N, p))
    y_d = plant_model.simulate(u_d, w_d, N)
    params = dict(
        eps_max=plant_model.get_eps_max(),
        lamb_alpha=0.1 / max(plant_model.get_eps_max(), 1e-12),
        lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
    )
    params.update(kw)
    return DirectDataDrivenMPCController(
        n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(p * L), R=1e-4 * np.eye(m * L),
        u_s=u_s, y_s=y_s, **params,
    )


def _tiled_inputs(plant_model, ctrl, B, n, m, p):
    import jax.numpy as jnp

    dtype = jnp.float32
    x0s = jnp.tile(
        jnp.asarray(plant_model.get_state(), dtype)[None], (B, 1)
    )
    ups = jnp.tile(
        jnp.asarray(ctrl.u_past.reshape(n, m), dtype)[None], (B, 1, 1)
    )
    yps = jnp.tile(
        jnp.asarray(ctrl.y_past.reshape(n, p), dtype)[None], (B, 1, 1)
    )
    return x0s, ups, yps


def _result(cfg_name, solves_per_s, ctrl) -> dict:
    theta = np.concatenate(
        [ctrl.u_past.reshape(-1), ctrl.y_past.reshape(-1)]
    )
    baseline = measure_baseline_single_core(ctrl.spec, theta)
    log(f"baseline (single-core full KKT re-solve/step, CVXPY-equivalent "
        f"lower bound on cost): {baseline:.1f} solves/s")
    return {
        "metric": f"closed_loop_qp_solves_per_s_per_chip_{cfg_name}",
        "value": round(solves_per_s, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / baseline, 1),
    }


def run_fused_admm_config(variant: str) -> dict:
    """Fused ADMM engine (ops/fused_admm.py) on the iterative solver
    variants: one scan step per solve with the ADMM warm start and the
    plant state in the carry, batch-packed iteration matmuls, and a
    mixed-precision iteration schedule.

    Variants: ``convex`` (q=2 CONVEX slack), ``box`` (saturated
    |u|<=0.85, fixed rho), ``ladder`` (the ADAPTIVE penalty-ladder box,
    make_fused_ladder_rollout), ``convex_q4`` (L=15 -> nbox=30, pack
    factor 4), ``convex_q1`` (long-horizon L=60 -> nbox=120, pack
    factor 1), ``tracking`` (4-phase setpoint schedule through the
    fused ADMM engine's dr channels).
    """
    import jax
    import jax.numpy as jnp

    from direct_data_driven_mpc_jax.ops.fused_admm import (
        make_fused_admm_rollout,
        make_fused_ladder_rollout,
    )
    from direct_data_driven_mpc_jax.parallel.batch import draw_noise_batch
    from direct_data_driven_mpc_jax.qp.admm import (
        compute_admm_operator_np,
    )
    from direct_data_driven_mpc_jax.qp.box import (
        compute_box_admm_operator_np,
    )
    from direct_data_driven_mpc_jax.qp.spec import SlackVarConstraintTypes

    B, T = 65536, 400
    n, m, p, N, L = 4, 2, 2, 400, 30
    if variant == "convex_q4":
        L = 15  # nbox = p*L = 30 -> pack factor 4
    elif variant == "convex_q1":
        N, L = 800, 60  # nbox = 120 -> pack factor 1
    rng = np.random.default_rng(0)
    plant_model = four_tank_plant()
    slack = (
        SlackVarConstraintTypes.NONE
        if variant in ("box", "ladder")
        else SlackVarConstraintTypes.CONVEX
    )
    ctrl = _controller(
        N, L, plant_model, rng, n, m, p,
        np.array([[1.0], [1.0]]), np.array([[0.65], [0.77]]),
        slack_var_constraint_type=slack,
    )
    setpoints = None
    if variant == "box":
        # Fixed rho (the saturated-regime rung): the single-rung fused
        # engine; the saturation is permanently active here.
        op = compute_box_admm_operator_np(
            ctrl.spec, u_bounds=(-0.85, 0.85), rho=1.0
        )
        # All-3x iterations: 1-pass bf16 noise (~3e-3 at |v|~0.85)
        # stalls the fixed point (measured sweep vs the active-set
        # golden); (0,12,2) is the 100%-converged minimum + margin.
        iters, cold, tol = (0, 14, 4), 60, 2e-5
        cfg_name = "four_tank_box"
    elif variant == "ladder":
        # The ADAPTIVE penalty ladder (qp/box.py's default): starts at
        # the middle rung and residual-balances to the saturated
        # regime; extra margin iterations cover the rung-walk
        # transient.
        op = compute_box_admm_operator_np(
            ctrl.spec, u_bounds=(-0.85, 0.85)
        )
        iters, cold, tol = (0, 16, 4), 80, 2e-5
        cfg_name = "four_tank_ladder"
    elif variant == "tracking":
        op = compute_admm_operator_np(
            ctrl.spec, return_setpoint_maps=True
        )
        iters, cold, tol = (4, 6, 2), 24, 1e-5
        cfg_name = "four_tank_admm_tracking"
        # 4-phase schedule around the baked setpoints (same shape as
        # the condensed tracking config): scaling an equilibrium pair
        # keeps it an equilibrium.
        r_bar = np.asarray(op["r_bar"])
        phases = np.array([1.0, 0.85, 1.1, 0.95])
        setpoints = np.repeat(
            phases[:, None] * r_bar[None], T // 4, axis=0
        )
    else:
        # (4,4,2) is the 100%-converged minimum vs the golden; one
        # 3-pass margin iteration added.
        op = compute_admm_operator_np(ctrl.spec)
        iters, cold, tol = (4, 5, 2), 24, 1e-5
        cfg_name = {
            "convex": "four_tank_convex",
            "convex_q4": "four_tank_convex_q4",
            "convex_q1": "long_horizon_convex",
        }[variant]

    plant_params = plant_model.as_params(dtype=np.float32)
    x0s, ups, yps = _tiled_inputs(plant_model, ctrl, B, n, m, p)
    Ws = draw_noise_batch(
        jax.random.key(0), B, T, p, 0.002, dtype=jnp.float32
    )
    kw = dict(n=n, m=m, p=p, n_steps=T, iters=iters, cold_iters=cold,
              tol=tol)
    if variant == "ladder":
        run = make_fused_ladder_rollout(plant_params, op, **kw)
    else:
        run = make_fused_admm_rollout(
            plant_params, op, setpoints=setpoints, **kw
        )
    log(f"config: {cfg_name}; B={B}, T={T}, iters={iters}+cold{cold} "
        f"[fused ADMM engine]")

    # The ladder's residual balancer walks at most one rung per solve
    # from the init rung, so the first few solves are a documented
    # adaptation transient (see make_fused_ladder_rollout); the
    # settled trajectory must be 100% converged.
    conv_from = 10 if variant == "ladder" else 0

    @jax.jit
    def amortized(x0s, ups, yps, Ws, R):
        def one_rep(i, carry):
            checksum, conv = carry
            res = run(x0s, ups, yps, jnp.roll(Ws, i, axis=1))
            checksum = (
                checksum + jnp.sum(res.costs[:, -1])
                + jnp.sum(res.u_sys) + jnp.sum(res.y_sys)
            )
            frac = jnp.mean(
                res.converged[:, conv_from:].astype(jnp.float32)
            )
            conv = conv & jnp.isfinite(checksum) & (frac == 1.0)
            return (checksum, conv)

        return jax.lax.fori_loop(
            0, R, one_rep, (jnp.float32(0.0), jnp.bool_(True))
        )

    args = (x0s, ups, yps, Ws)
    first_run(amortized, args)
    R_big = max(2, int(4e9 / (B * T)))
    tm = time_amortized(amortized, args, R_small=1, R_big=R_big)
    return _result(cfg_name, log_amortized(tm, B, T), ctrl)


def run_convex_config(nonconvex: bool = False, box: bool = False) -> dict:
    """Generic scan engine (control/loop.py) with an iterative solver:
    CONVEX slack by default (warm-started fixed-iteration ADMM,
    qp/admm.py).

    With ``nonconvex=True``: the NON_CONVEX variant (paper Eq. 6d) via
    the convex-concave fixed point (qp/nonconvex.py) -- the variant the
    reference refuses to solve at all (4 warm-started outer iterations
    x 16 inner ADMM iterations per solve).

    With ``box=True``: slack-NONE controller plus a saturated input box
    ``|u| <= 0.85`` (below the ~1.0 steady-state input, so the
    constraint is permanently active) solved by the box ADMM at a fixed
    rho (qp/box.py)."""
    import jax
    import jax.numpy as jnp

    from direct_data_driven_mpc_jax.parallel.batch import (
        batched_closed_loop,
        draw_noise_batch,
    )
    from direct_data_driven_mpc_jax.qp.spec import SlackVarConstraintTypes

    # 16 fixed iterations: over-relaxed ADMM (alpha=1.6, qp/admm.py)
    # needs <= 14 to hit 1e-8 on this config (cold AND warm-start max
    # along the trajectory); plain ADMM needed 30.
    B, T, admm_iters = 4096, 400, 16
    n, m, p, N, L = 4, 2, 2, 400, 30
    rng = np.random.default_rng(0)
    plant_model = four_tank_plant()
    slack = (
        SlackVarConstraintTypes.NON_CONVEX
        if nonconvex
        else SlackVarConstraintTypes.NONE
        if box
        else SlackVarConstraintTypes.CONVEX
    )
    # NON_CONVEX: c=0.05 so the Eq. 6d bound is material (at c=1 the
    # box never binds on this config and the problem degenerates to
    # slack-NONE).
    ctrl = _controller(
        N, L, plant_model, rng, n, m, p,
        np.array([[1.0], [1.0]]), np.array([[0.65], [0.77]]),
        c=0.05 if nonconvex else 1.0,
        slack_var_constraint_type=slack,
        allow_nonconvex_slack=nonconvex,
    )
    if nonconvex:
        solver = ctrl.nonconvex_admm_solver(dtype=jnp.float32)
        cfg_name = "four_tank_nonconvex"
    elif box:
        # Fixed rho (the saturated-regime rung of qp/box.py's ladder):
        # the bound is permanently active on this workload, so the
        # single rung converges every solve.
        solver = ctrl.box_admm_solver(
            u_bounds=(-0.85, 0.85), rho=1.0, dtype=jnp.float32
        )
        cfg_name = "four_tank_box_generic"
        admm_iters = 60  # early-exit cap
    else:
        solver = ctrl.admm_solver(dtype=jnp.float32)
        cfg_name = "four_tank_convex_generic"
    log(f"config: {cfg_name}; B={B}, T={T}, admm_iters={admm_iters} "
        f"[generic scan engine]")

    x0s, ups, yps = _tiled_inputs(plant_model, ctrl, B, n, m, p)
    Ws = draw_noise_batch(
        jax.random.key(0), B, T, p, 0.002, dtype=jnp.float32
    )
    plant_params = plant_model.as_params(dtype=np.float32)

    # Same amortized contract as make_amortized_linear_run: R reps in
    # one call, rep i runs a time-rolled noise realization.
    @jax.jit
    def amortized(x0s, ups, yps, Ws, R):
        def one_rep(i, carry):
            checksum, conv = carry
            res = batched_closed_loop(
                plant_params, solver, x0s, ups, yps,
                jnp.roll(Ws, i, axis=1),
                n_steps=T, admm_iters=admm_iters,
            )
            checksum = (
                checksum
                + jnp.sum(res.costs[:, -1])
                + jnp.sum(res.u_sys)
                + jnp.sum(res.y_sys)
            )
            conv = conv & jnp.all(res.converged) & jnp.isfinite(checksum)
            return (checksum, conv)

        return jax.lax.fori_loop(
            0, R, one_rep, (jnp.float32(0.0), jnp.bool_(True))
        )

    args = (x0s, ups, yps, Ws)
    first_run(amortized, args)
    tm = time_amortized(amortized, args, R_small=1, R_big=24)
    return _result(cfg_name, log_amortized(tm, B, T), ctrl)


def run_tracking_config() -> dict:
    """Time-varying setpoint tracking through the fused condensed
    rollout: the four-tank headline shape with a per-block setpoint
    schedule riding the input lanes (control/linear_engine.py tracking
    channel). The reference retargets only by re-running its whole init
    pipeline per setpoint change; here the schedule costs ~m+p extra
    operand lanes.
    """
    import math

    import jax
    import jax.numpy as jnp

    from direct_data_driven_mpc_jax.control.linear_engine import (
        build_tracking_engine,
    )
    from direct_data_driven_mpc_jax.ops.fused_rollout import (
        make_amortized_fused_run,
        make_fused_batched_rollout,
        suggest_solves_per_block,
    )
    from direct_data_driven_mpc_jax.parallel.batch import draw_noise_batch

    B, T = 4096, 400
    n, m, p, N, L = 4, 2, 2, 400, 30
    dtype = jnp.float32
    rng = np.random.default_rng(0)
    plant_model = four_tank_plant()
    u_s = np.array([[1.0], [1.0]])
    y_s = np.array([[0.65], [0.77]])
    ctrl = _controller(N, L, plant_model, rng, n, m, p, u_s, y_s)
    K = suggest_solves_per_block(n, n, m, p, n_steps=T, n_r=m + p)
    t0 = time.perf_counter()
    bm_t = build_tracking_engine(
        ctrl, plant_model.as_params(), solves_per_block=K, dtype=dtype
    )
    log(f"config: four_tank_tracking; B={B}, T={T}, K={K} "
        f"(+{bm_t.n_r} setpoint lanes); tracking block map composed in "
        f"{time.perf_counter() - t0:.2f}s")

    n_outer = math.ceil(T / K)
    r0 = np.concatenate([u_s.ravel(), y_s.ravel()])
    # 4-phase retarget schedule: alternate the paper setpoint and a
    # 0.85x operating point every 2 outer blocks (~100 steps/phase).
    sched = jnp.asarray(
        np.stack(
            [r0 if (i // 2) % 2 == 0 else 0.85 * r0
             for i in range(n_outer)]
        ),
        dtype,
    )
    x0s, ups, yps = _tiled_inputs(plant_model, ctrl, B, n, m, p)
    Ws = draw_noise_batch(jax.random.key(0), B, T, p, 0.002, dtype=dtype)

    run = make_amortized_fused_run(bm_t, n_steps=T, setpoints=sched)
    args = (x0s, ups, yps, Ws)
    first_run(run, args)

    # Correctness probe on a small slice: the retarget must bite (late
    # outputs near the 0.85x target at the end of a low phase).
    probe = jax.jit(make_fused_batched_rollout(bm_t, n_steps=T))(
        x0s[:8], ups[:8], yps[:8], Ws[:8], sched
    )
    y_end = np.asarray(probe.y_sys[:, -1])  # schedule ends low
    if np.abs(y_end - 0.85 * r0[2:]).max() >= 0.05:
        raise RuntimeError(f"retarget probe missed: y(T)={y_end[0]}")
    log(f"retarget probe: y(T)={y_end[0]} vs target {0.85 * r0[2:]}")

    R_big = min(4096, max(32, 64 * (262144 // B)))
    tm = time_amortized(run, args, R_small=1, R_big=R_big)
    return _result("four_tank_tracking", log_amortized(tm, B, T), ctrl)


def run_condensed_config(config: str, B: int | None = None) -> dict:
    """Slack-NONE configs through the fused condensed rollout
    (ops/fused_rollout.py): ``four_tank_robust`` (the headline),
    ``long_horizon`` (L=60, N=800) and ``large_plant`` (10x10 random
    stable plant, cost channel as a post-pass over the trajectories)."""
    import jax
    import jax.numpy as jnp

    from direct_data_driven_mpc_jax.control.linear_engine import (
        build_linear_engine,
    )
    from direct_data_driven_mpc_jax.models.random_lti import (
        random_stable_lti,
    )
    from direct_data_driven_mpc_jax.ops.fused_rollout import (
        make_amortized_fused_run,
        suggest_solves_per_block,
    )
    from direct_data_driven_mpc_jax.parallel.batch import draw_noise_batch

    dtype = jnp.float32
    rng = np.random.default_rng(0)
    T = 400
    if config == "large_plant":
        B = B or 65536
        n = m = p = 10
        N, L = 600, 30
        plant_model = random_stable_lti(seed=0, ns=n, m=m, p=p)
        u_s = 0.5 * np.ones((m, 1))
        y_s = plant_model.get_equilibrium_output_from_input(
            u_s.flatten()
        ).reshape(-1, 1)
    else:
        n, m, p = 4, 2, 2
        if config == "long_horizon":
            B = B or 65536
            N, L = 800, 60
        else:
            B = B or 262144
            N, L = 400, 30
        plant_model = four_tank_plant()
        u_s = np.array([[1.0], [1.0]])
        y_s = np.array([[0.65], [0.77]])

    t0 = time.perf_counter()
    ctrl = _controller(N, L, plant_model, rng, n, m, p, u_s, y_s)
    log(f"config: {config}; controller init (host, f64 KKT "
        f"factorization): {time.perf_counter() - t0:.2f}s; QP "
        f"nz={ctrl.spec.nz}, nc={ctrl.spec.nc}")

    # K fills a 128-wide fused contraction for small states; large-state
    # shapes move the cost channel to a post-pass over the emitted
    # trajectories (the K*n_theta cost columns would dominate the
    # fused operator).
    S_cond = plant_model.get_system_order() + n * (m + p)
    if S_cond <= 128:
        K = suggest_solves_per_block(
            plant_model.get_system_order(), n, m, p, n_steps=T
        )
        cost_mode = "inkernel"
    else:
        K = 25
        cost_mode = "post"
    t0 = time.perf_counter()
    bm = build_linear_engine(
        ctrl, plant_model.as_params(), solves_per_block=K, dtype=dtype,
    )
    log(f"affine block-map composition (K={K}, cost_mode={cost_mode}): "
        f"{time.perf_counter() - t0:.2f}s; B={B}, T={T} "
        f"[fused condensed rollout]")
    x0s, ups, yps = _tiled_inputs(plant_model, ctrl, B, n, m, p)
    noise = draw_noise_batch(
        jax.random.key(0), B, T, p, plant_model.get_eps_max(),
        dtype=dtype,
    )
    run = make_amortized_fused_run(bm, n_steps=T, cost_mode=cost_mode)
    args = (x0s, ups, yps, noise)
    first_run(run, args)
    if config == "large_plant":
        R_big = 16
    else:
        R_big = min(4096, max(32, 64 * (262144 // B)))
    tm = time_amortized(run, args, R_small=1, R_big=R_big)
    solves_per_s = log_amortized(tm, B, T)

    # Single-scenario per-step latency (host affine path) -- the
    # real-time-budget metric.
    lat = []
    for _ in range(200):
        t0 = time.perf_counter()
        ctrl.update_and_solve_data_driven_mpc()
        lat.append(time.perf_counter() - t0)
    log(f"single-scenario host solve p50: "
        f"{np.percentile(lat, 50) * 1e6:.1f} us, p99: "
        f"{np.percentile(lat, 99) * 1e6:.1f} us")
    return _result(config, solves_per_s, ctrl)


ADMM_CONFIGS = {
    "four_tank_convex": "convex",
    "four_tank_box": "box",
    "four_tank_ladder": "ladder",
    "four_tank_admm_tracking": "tracking",
    "four_tank_convex_q4": "convex_q4",
    "long_horizon_convex": "convex_q1",
}
CONDENSED_CONFIGS = ("four_tank_robust", "long_horizon", "large_plant")


def run_config(config: str, B: int | None = None) -> dict:
    if config in ADMM_CONFIGS:
        return run_fused_admm_config(ADMM_CONFIGS[config])
    if config == "four_tank_nonconvex":
        return run_convex_config(nonconvex=True)
    if config == "four_tank_convex_generic":
        return run_convex_config()
    if config == "four_tank_box_generic":
        return run_convex_config(box=True)
    if config == "tracking":
        return run_tracking_config()
    if config in CONDENSED_CONFIGS:
        return run_condensed_config(config, B)
    raise SystemExit(f"unknown config {config!r}")


def device_record() -> dict:
    import jax

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def main() -> None:
    from direct_data_driven_mpc_jax.utils.compile_cache import (
        enable_compile_cache,
    )

    config = sys.argv[1] if len(sys.argv) > 1 else "four_tank_robust"
    B = int(sys.argv[2]) if len(sys.argv) > 2 else None
    device = device_record()
    log(f"device: {device}")
    # A measurement needs the accelerator: JAX falls back to the CPU
    # silently when its CUDA plugin fails to load.
    if device["platform"] != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX found {device['platform']!r}"
        )
    log(f"compile cache: {enable_compile_cache()}")
    result = run_config(config, B)
    result["device"] = device
    print(json.dumps(result))


if __name__ == "__main__":
    main()

"""Measure the fused ADMM engine (ops/fused_admm.py) on the GPU.

Usage: python scripts/measure_fused_admm.py
           [convex|convex_q4|convex_q1|box|ladder|tracking] [B]
Environment: ADMM_PIPE (row chains, default 1), ADMM_ITERS ("n1,n3,n6").

Prints amortized + per-rollout solves/s and the converged fraction.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from direct_data_driven_mpc_jax.control.controller import (
        DirectDataDrivenMPCController,
    )
    from direct_data_driven_mpc_jax.models.four_tank import four_tank_plant
    from direct_data_driven_mpc_jax.ops.fused_admm import (
        make_fused_admm_rollout,
        make_fused_ladder_rollout,
        pick_pack_factor,
    )
    from direct_data_driven_mpc_jax.parallel.batch import draw_noise_batch
    from direct_data_driven_mpc_jax.qp.admm import (
        compute_admm_operator_np,
    )
    from direct_data_driven_mpc_jax.qp.box import (
        compute_box_admm_operator_np,
    )
    from direct_data_driven_mpc_jax.qp.spec import (
        DataDrivenMPCType,
        SlackVarConstraintTypes,
    )

    variant = sys.argv[1] if len(sys.argv) > 1 else "convex"
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 65536
    pipe = int(os.environ.get("ADMM_PIPE", "1"))
    iters_env = os.environ.get("ADMM_ITERS")
    T = 400
    n, m, p, N, L = 4, 2, 2, 400, 30
    if variant == "convex_q4":  # nbox = p*L = 30 -> pack factor 4
        L = 15
    elif variant == "convex_q1":  # nbox = 120 -> pack factor 1
        N, L = 800, 60
    rng = np.random.default_rng(0)
    plant_model = four_tank_plant()
    u_d = rng.uniform(-1, 1, (N, m))
    w_d = 0.002 * rng.uniform(-1, 1, (N, p))
    y_d = plant_model.simulate(u_d, w_d, N)
    slack = (
        SlackVarConstraintTypes.NONE
        if variant in ("box", "ladder")
        else SlackVarConstraintTypes.CONVEX
    )
    ctrl = DirectDataDrivenMPCController(
        n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(p * L), R=1e-4 * np.eye(m * L),
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
        eps_max=0.002, lamb_alpha=0.1 / 0.002, lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=slack,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
    )
    setpoints = None
    if variant == "box":
        op = compute_box_admm_operator_np(
            ctrl.spec, u_bounds=(-0.85, 0.85), rho=1.0
        )
        iters, cold, tol = (0, 14, 4), 60, 2e-5
    elif variant == "ladder":
        op = compute_box_admm_operator_np(
            ctrl.spec, u_bounds=(-0.85, 0.85)
        )
        iters, cold, tol = (0, 16, 4), 80, 2e-5
    elif variant == "tracking":
        op = compute_admm_operator_np(
            ctrl.spec, return_setpoint_maps=True
        )
        iters, cold, tol = (4, 6, 2), 24, 1e-5
        r_bar = np.asarray(op["r_bar"])
        phases = np.array([1.0, 0.85, 1.1, 0.95])
        setpoints = np.repeat(
            phases[:, None] * r_bar[None], T // 4, axis=0
        )
    else:
        op = compute_admm_operator_np(ctrl.spec)
        iters, cold, tol = (4, 5, 2), 24, 1e-5
    nbox = np.asarray(op["v_c"]).shape[-1]
    log(f"nbox={nbox}, q={pick_pack_factor(nbox)}")
    if iters_env:
        iters = tuple(int(x) for x in iters_env.split(","))
    log(f"device: {jax.devices()[0]}, variant={variant}, B={B}, "
        f"iters={iters}, cold={cold}, pipeline={pipe}")

    plant_params = plant_model.as_params(dtype=np.float32)
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
    Ws = draw_noise_batch(jax.random.key(0), B, T, p, 0.002, dtype=dtype)

    kw = dict(
        n=n, m=m, p=p, n_steps=T, iters=iters, cold_iters=cold, tol=tol
    )
    if variant == "ladder":
        run = make_fused_ladder_rollout(
            plant_params, op, pipeline=pipe, **kw
        )
    else:
        run = make_fused_admm_rollout(
            plant_params, op, pipeline=pipe, setpoints=setpoints, **kw
        )

    @jax.jit
    def amortized(x0s, ups, yps, Ws, R):
        def one_rep(i, carry):
            checksum, conv = carry
            res = run(x0s, ups, yps, jnp.roll(Ws, i, axis=1))
            checksum = (
                checksum + jnp.sum(res.costs[:, -1])
                + jnp.sum(res.u_sys) + jnp.sum(res.y_sys)
            )
            conv = conv & jnp.isfinite(checksum)
            frac = jnp.mean(res.converged.astype(jnp.float32))
            return (checksum, conv & (frac == 1.0))

        return jax.lax.fori_loop(
            0, R, one_rep, (jnp.float32(0.0), jnp.bool_(True))
        )

    t0 = time.perf_counter()
    cs, ok = jax.block_until_ready(amortized(x0s, ups, yps, Ws, 1))
    log(f"compile+first: {time.perf_counter() - t0:.1f}s, "
        f"all-converged={bool(ok)}")

    R = max(2, int(4e9 / (B * T)))
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        cs, ok = jax.block_until_ready(amortized(x0s, ups, yps, Ws, R))
        best = min(best, time.perf_counter() - t0)
    t1 = time.perf_counter()
    cs, ok = jax.block_until_ready(amortized(x0s, ups, yps, Ws, 1))
    t_one = time.perf_counter() - t1
    per_rep = (best - t_one) / (R - 1)
    log(f"R={R} wall {best:.2f}s (R=1 {t_one:.2f}s) -> per-rollout "
        f"{per_rep:.4f}s; {B * T / per_rep:,.0f} solves/s per rollout, "
        f"{B * T * R / best:,.0f} amortized; all-converged={bool(ok)}")


if __name__ == "__main__":
    main()

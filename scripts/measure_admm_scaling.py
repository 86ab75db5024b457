"""Measure the generic ADMM closed-loop engine (control/loop.py) vs
batch size on the GPU (the calibration point for the fused ADMM
engine).

For B in the sweep: amortized solves/s of the four-tank CONVEX-slack
rollout (16 warm-started over-relaxed iterations/solve, the bench
four_tank_convex workload) and the box variant at B=65536.

Usage: python scripts/measure_admm_scaling.py [convex|box] [B ...]
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
    from direct_data_driven_mpc_jax.parallel.batch import (
        batched_closed_loop,
        draw_noise_batch,
    )
    from direct_data_driven_mpc_jax.qp.spec import (
        DataDrivenMPCType,
        SlackVarConstraintTypes,
    )

    variant = sys.argv[1] if len(sys.argv) > 1 else "convex"
    Bs = [int(b) for b in sys.argv[2:]] or [4096, 16384, 65536]
    T = 400
    n, m, p, N, L = 4, 2, 2, 400, 30
    rng = np.random.default_rng(0)
    plant_model = four_tank_plant()
    u_d = rng.uniform(-1, 1, (N, m))
    w_d = 0.002 * rng.uniform(-1, 1, (N, p))
    y_d = plant_model.simulate(u_d, w_d, N)
    slack = (
        SlackVarConstraintTypes.NONE
        if variant == "box"
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
    if variant == "box":
        solver = ctrl.box_admm_solver(
            u_bounds=(-0.85, 0.85), rho=1.0, dtype=jnp.float32
        )
        admm_iters = 60
    else:
        solver = ctrl.admm_solver(dtype=jnp.float32)
        admm_iters = 16
    log(f"device: {jax.devices()[0]}, variant={variant}, "
        f"admm_iters={admm_iters}")

    plant_params = plant_model.as_params(dtype=np.float32)
    dtype = jnp.float32

    for B in Bs:
        x0s = jnp.tile(
            jnp.asarray(plant_model.get_state(), dtype)[None], (B, 1)
        )
        ups = jnp.tile(
            jnp.asarray(ctrl.u_past.reshape(n, m), dtype)[None],
            (B, 1, 1),
        )
        yps = jnp.tile(
            jnp.asarray(ctrl.y_past.reshape(n, p), dtype)[None],
            (B, 1, 1),
        )
        Ws = draw_noise_batch(
            jax.random.key(0), B, T, p, 0.002, dtype=dtype
        )

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
                    checksum + jnp.sum(res.costs[:, -1])
                    + jnp.sum(res.u_sys) + jnp.sum(res.y_sys)
                )
                conv = conv & jnp.all(res.converged)
                return (checksum, conv)

            return jax.lax.fori_loop(
                0, R, one_rep, (jnp.float32(0.0), jnp.bool_(True))
            )

        t0 = time.perf_counter()
        cs, ok = jax.block_until_ready(amortized(x0s, ups, yps, Ws, 1))
        log(f"B={B}: compile+first {time.perf_counter() - t0:.1f}s, "
            f"converged={bool(ok)}")
        R = max(2, int(2e9 / (B * T)))  # ~2G solves per timing
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            cs, ok = jax.block_until_ready(
                amortized(x0s, ups, yps, Ws, R)
            )
            best = min(best, time.perf_counter() - t0)
        t1 = time.perf_counter()
        cs, ok = jax.block_until_ready(amortized(x0s, ups, yps, Ws, 1))
        t_one = time.perf_counter() - t1
        per_rep = (best - t_one) / (R - 1)
        log(f"B={B}: R={R} wall {best:.2f}s, per-rollout {per_rep:.4f}s"
            f" -> {B * T / per_rep:,.0f} solves/s per rollout, "
            f"{B * T * R / best:,.0f} amortized")


if __name__ == "__main__":
    main()

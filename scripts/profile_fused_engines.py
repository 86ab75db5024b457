#!/usr/bin/env python
"""Time and trace the two fused engines on the GPU.

    python scripts/profile_fused_engines.py [--out DIR] [--reps N]

Engines and shapes (four-tank Robust, N=400, L=30, T=400 steps):

- condensed fused rollout (ops/fused_rollout.py), K=50, B=4096 and
  B=262144;
- fused ADMM engine (ops/fused_admm.py), CONVEX slack, q=2,
  iters (4, 5, 2), B=65536.

Each engine is compiled, warmed up, then timed ``--reps`` times (every
run ends in ``block_until_ready``; the median is reported). One more
run is traced with ``jax.profiler`` into ``DIR/<engine>`` and reduced
to: device kernels per outer block (condensed) or per solve (ADMM), the
device idle share over the traced call, and the three device
operations that take the most time. Prints one JSON line per engine.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (shared four-tank set-up)

# Lines of a device plane that summarize rather than list kernels.
_SUMMARY_LINES = ("XLA Modules", "XLA Ops", "Steps", "Source",
                  "Framework Name Scope", "XLA TraceMe")


def reduce_trace(trace_dir: str) -> dict:
    """Kernel count, busy/idle share and top operations of the device
    planes in the newest ``.xplane.pb`` under ``trace_dir``."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    data = ProfileData.from_file(paths[-1])
    lines_seen = {}
    events = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines_seen[f"{plane.name}|{line.name}"] = len(evs)
            if line.name.startswith(_SUMMARY_LINES):
                continue
            events += [(e.start_ns, e.start_ns + e.duration_ns, e.name)
                       for e in evs if e.duration_ns > 0]
    return {"lines": lines_seen, **summarize_events(events)}


def summarize_events(events) -> dict:
    """Kernel count, busy time (the union of the events' intervals),
    idle share over the window from the first start to the last end,
    and the three names with the most device time, from
    ``(start_ns, end_ns, name)`` events."""
    if not events:
        return {"kernels": 0}
    events = sorted(events)
    busy, cur_s, cur_e = 0.0, events[0][0], events[0][1]
    for s, e, _ in events[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e, _ in events) - events[0][0]
    by_name = {}
    for s, e, name in events:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return {
        "kernels": len(events),
        "device_window_ms": window / 1e6,
        "device_busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / window,
        "top3": [{"name": n[:120], "ms": t / 1e6,
                  "share_of_busy": t / busy} for n, t in top],
    }


def measure(name, fn, args, reps, out_dir, units, unit_name, solves):
    import jax

    jf = jax.jit(fn)
    t0 = time.perf_counter()
    jax.block_until_ready(jf(*args))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(jf(*args))
        times.append(time.perf_counter() - t0)
    trace_dir = os.path.join(out_dir, name)
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(jf(*args))
    red = reduce_trace(trace_dir)
    med = statistics.median(times)
    rec = {
        "engine": name,
        "compile_plus_first_s": compile_s,
        "median_s": med,
        "min_s": min(times),
        "max_s": max(times),
        "solves_per_s": solves / med,
        f"kernels_per_{unit_name}": red.get("kernels", 0) / units,
        **{k: v for k, v in red.items() if k != "lines"},
        "trace_lines": red["lines"],
    }
    print(json.dumps(rec), flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "profiles"),
                    help="trace directory (default: <checkout>/profiles)")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

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
    from direct_data_driven_mpc_jax.qp.admm import compute_admm_operator_np
    from direct_data_driven_mpc_jax.utils.compile_cache import (
        enable_compile_cache,
    )

    d0 = jax.devices()[0]
    if d0.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {d0.platform!r}")
    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {smi}; jax {jax.__version__}", flush=True)

    T, K = 400, 50
    ctrl = chip_smoke.paper_controller()
    plant = chip_smoke.four_tank_plant()
    bm = build_linear_engine(ctrl, plant.as_params(), solves_per_block=K,
                             dtype=jnp.float32)
    cond = make_fused_batched_rollout(bm, n_steps=T)
    for B in (4096, 262144):
        batch = chip_smoke.batch_inputs(plant.get_state(), ctrl.u_past,
                                        ctrl.y_past, B, T)
        measure(f"condensed_B{B}", cond, batch, args.reps, args.out,
                units=T // K, unit_name="outer_block", solves=B * T)
        del batch

    golden = np.load(chip_smoke.GOLDEN_BOX)
    ctrl_c = chip_smoke.paper_controller(
        "CONVEX", c=float(golden["convex_c"]), u_d=golden["u_d"],
        y_d=golden["y_d"])
    admm = make_fused_admm_rollout(
        plant.as_params(dtype=np.float32),
        compute_admm_operator_np(ctrl_c.spec), n=4, m=2, p=2, n_steps=T,
        iters=chip_smoke.CONVEX_ITERS, cold_iters=24, tol=1e-5,
    )
    B = 65536
    batch = chip_smoke.batch_inputs(golden["x0"], golden["CONVEX_u_past0"],
                                    golden["CONVEX_y_past0"], B, T)
    measure(f"fused_admm_convex_B{B}", admm, batch, args.reps, args.out,
            units=T, unit_name="solve", solves=B * T)
    print(f"card: {smi}", flush=True)


if __name__ == "__main__":
    main()

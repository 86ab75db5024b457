"""The bench's amortized measurement harness, exercised on CPU.

bench.py runs on the accelerator; these tests pin the harness's
semantics so a refactor cannot silently break the headline
measurement: R repetitions accumulate distinct noise realizations
(nothing CSE-able / DCE-able), the convergence flag propagates, and
the wall-time decomposition is linear in R.
"""

import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")  # bench.py lives at the repo root

from bench import make_amortized_linear_run, time_amortized  # noqa: E402

from direct_data_driven_mpc_jax.control.controller import (
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_jax.control.linear_engine import (
    build_linear_engine,
)
from direct_data_driven_mpc_jax.models.lti_model import LTIModel
from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

from tests.test_closed_loop import FOUR_TANK


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    plant = LTIModel(**FOUR_TANK)
    N, L, n, m, p = 400, 30, 4, 2, 2
    u_d = rng.uniform(-1, 1, (N, m))
    w_d = 0.002 * rng.uniform(-1, 1, (N, p))
    y_d = plant.simulate(u_d, w_d, N)
    ctrl = DirectDataDrivenMPCController(
        n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(p * L), R=1e-4 * np.eye(m * L),
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
        eps_max=0.002, lamb_alpha=50.0, lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
    )
    bm = build_linear_engine(ctrl, plant.as_params(), solves_per_block=10)
    B = 4
    x0s = jnp.tile(
        jnp.asarray(plant.get_state(), jnp.float32)[None], (B, 1)
    )
    ups = jnp.tile(
        jnp.asarray(ctrl.u_past.reshape(n, m), jnp.float32)[None],
        (B, 1, 1),
    )
    yps = jnp.tile(
        jnp.asarray(ctrl.y_past.reshape(n, p), jnp.float32)[None],
        (B, 1, 1),
    )
    keys = jax.random.split(jax.random.key(0), B)
    return bm, (x0s, ups, yps, keys)


def test_amortized_run_accumulates_distinct_reps(setup):
    bm, args = setup
    run = make_amortized_linear_run(
        bm, n_steps=40, eps_max=0.002, emit_traj=True
    )
    cs1, ok1 = run(*args, 1)
    cs2, ok2 = run(*args, 2)
    cs4, ok4 = run(*args, 4)
    assert bool(ok1) and bool(ok2) and bool(ok4)
    # Each rep folds its index into the noise keys: rep checksums are
    # distinct realizations, so increments differ between reps (a CSE'd
    # or reused rollout would add the same value every time).
    inc_1_2 = float(cs2 - cs1)
    inc_2_4 = float(cs4 - cs2)
    assert abs(inc_1_2) > 0
    assert abs(inc_2_4 - 2 * inc_1_2) > 1e-6 * max(abs(inc_1_2), 1.0)


def test_amortized_run_metrics_only_mode(setup):
    bm, args = setup
    run = make_amortized_linear_run(
        bm, n_steps=40, eps_max=0.002, emit_traj=False
    )
    cs, ok = run(*args, 3)
    assert bool(ok) and np.isfinite(float(cs))


def test_time_amortized_decomposition(setup):
    bm, args = setup
    run = make_amortized_linear_run(
        bm, n_steps=40, eps_max=0.002, emit_traj=False
    )
    run(*args, 1)  # compile once
    tm = time_amortized(run, args, R_small=1, R_big=4, reps=2)
    # This tiny CPU workload is dominated by dispatch noise, so the
    # timing VALUES are not asserted (per_rep can even come out
    # negative here); the decomposition's algebra and invariants are.
    assert tm["t_small"] > 0 and tm["t_big"] > 0
    assert tm["per_rep"] == pytest.approx(
        (tm["t_big"] - tm["t_small"]) / (tm["R_big"] - tm["R_small"])
    )
    assert tm["per_call_overhead"] >= 0  # clamped, never negative
    # When not clamped, overhead + R_small*per_rep reconstructs t_small.
    if tm["per_call_overhead"] > 0:
        recon = tm["per_call_overhead"] + tm["R_small"] * tm["per_rep"]
        assert recon == pytest.approx(tm["t_small"], rel=1e-9)
    assert tm["overhead_frac_of_big"] >= 0.0
    if tm["per_rep"] > 0:
        assert tm["overhead_frac_of_big"] <= 1.0



def test_time_amortized_caps_r_big_by_wall_time(monkeypatch):
    import time

    import bench

    def slow_run(R):
        time.sleep(0.02 * R)
        return jnp.float32(0.0), jnp.bool_(True)

    monkeypatch.setattr(bench, "MAX_TIMED_CALL_S", 0.1)
    tm = time_amortized(slow_run, (), R_small=1, R_big=1000, reps=1)
    # One R=1 call takes >= 20 ms, so at most 5 reps fit in 0.1 s.
    assert 2 <= tm["R_big"] <= 5
    assert tm["t_big"] < 0.5

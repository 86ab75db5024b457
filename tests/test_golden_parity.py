"""End-to-end golden-trajectory parity: every engine vs the committed
independent-solver fixture.

``tests/golden/four_tank_golden.npz`` (generated by
tests/golden/generate_golden.py) holds seeded closed-loop trajectories
of the paper's three robust schemes (TEC, TEC n-step, UCON; reference
utilities/reproduction/paper_reproduction.py:23-41) produced by an
INDEPENDENT float64 null-space QP solver run through a plain Python
loop with reference Algorithm 1/2 semantics. Every shipped engine must
reproduce the applied-input sequence to:

- < 1e-9 in float64 (two exact solvers of the same convex QP), and
- < 1e-4 in float32 -- the north-star control-input deviation budget
  (BASELINE.json; reference validation bar README.md:110-119).
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.controller import (
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_jax.control.linear_engine import (
    build_linear_engine,
    linear_closed_loop_rollout,
    time_parallel_rollout,
)
from direct_data_driven_mpc_jax.control.loop import closed_loop_rollout
from direct_data_driven_mpc_jax.control.operation import (
    simulate_data_driven_mpc_control_loop,
)
from direct_data_driven_mpc_jax.models.lti_model import LTIModel
from direct_data_driven_mpc_jax.ops.lti import LTIParams
from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

from tests.test_closed_loop import FOUR_TANK

GOLDEN = os.path.join(
    os.path.dirname(__file__), "golden", "four_tank_golden.npz"
)

SCHEMES = {
    "TEC": (1, True, 120),
    "TEC_N_STEP": (4, True, 120),
    "UCON": (1, False, 40),
}

F64_BUDGET = 1e-9
F32_BUDGET = 1e-4  # the north-star deviation bar


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _controller(golden, scheme):
    n_mpc_step, use_terminal, _ = SCHEMES[scheme]
    return DirectDataDrivenMPCController(
        n=4, m=2, p=2,
        u_d=golden["u_d"], y_d=golden["y_d"], L=30,
        Q=3.0 * np.eye(60), R=1e-4 * np.eye(60),
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
        eps_max=0.002, lamb_alpha=0.1 / 0.002, lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=DataDrivenMPCType.ROBUST,
        n_mpc_step=n_mpc_step,
        use_terminal_constraint=use_terminal,
    )


def _inputs(golden, scheme, dtype):
    n_mpc_step, _, n_steps = SCHEMES[scheme]
    x0 = jnp.asarray(golden["x0"], dtype)
    up = jnp.asarray(golden[f"{scheme}_u_past0"], dtype)
    yp = jnp.asarray(golden[f"{scheme}_y_past0"], dtype)
    W = jnp.asarray(golden["w_sys"][:n_steps], dtype)
    return x0, up, yp, W, n_steps, n_mpc_step


def _du(u, golden, scheme):
    ref = golden[f"{scheme}_u"]
    return np.abs(np.asarray(u, dtype=np.float64) - ref).max()


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_host_controller_loop_matches_golden(golden, scheme):
    """Interactive controller class + host Python loop (the
    reference-shaped path) vs the independent-solver golden run."""
    _, _, n_steps = SCHEMES[scheme]
    plant = LTIModel(**FOUR_TANK)
    plant.set_state(golden["x0"])
    ctrl = _controller(golden, scheme)
    u_host, y_host = simulate_data_driven_mpc_control_loop(
        plant, ctrl, n_steps,
        np_random=np.random.default_rng(0),
        verbose=0, w_sys=golden["w_sys"][:n_steps],
    )
    assert _du(u_host, golden, scheme) < F64_BUDGET
    np.testing.assert_allclose(
        y_host, golden[f"{scheme}_y"], atol=F64_BUDGET
    )


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize(
    "dtype,budget",
    [(jnp.float64, F64_BUDGET), (jnp.float32, F32_BUDGET)],
    ids=["f64", "f32"],
)
def test_fused_scan_engine_matches_golden(golden, scheme, dtype, budget):
    ctrl = _controller(golden, scheme)
    sol = ctrl.solution_map(dtype=dtype)
    x0, up, yp, W, n_steps, n_mpc_step = _inputs(golden, scheme, dtype)
    plant = LTIParams(
        *(jnp.asarray(a, dtype)
          for a in (FOUR_TANK["A"], FOUR_TANK["B"],
                    FOUR_TANK["C"], FOUR_TANK["D"]))
    )
    result = closed_loop_rollout(
        plant, sol, x0, up, yp, W,
        n_steps=n_steps, n_mpc_step=n_mpc_step,
    )
    assert _du(result.u_sys, golden, scheme) < budget


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize(
    "dtype,budget",
    [(jnp.float64, F64_BUDGET), (jnp.float32, F32_BUDGET)],
    ids=["f64", "f32"],
)
def test_condensed_engine_matches_golden(golden, scheme, dtype, budget):
    ctrl = _controller(golden, scheme)
    plant = LTIParams(
        FOUR_TANK["A"], FOUR_TANK["B"], FOUR_TANK["C"], FOUR_TANK["D"]
    )
    bm = build_linear_engine(ctrl, plant, solves_per_block=10, dtype=dtype)
    x0, up, yp, W, n_steps, n_mpc_step = _inputs(golden, scheme, dtype)
    result = linear_closed_loop_rollout(
        bm, x0, up, yp, W=W, n_steps=n_steps, n_mpc_step=n_mpc_step,
    )
    assert _du(result.u_sys, golden, scheme) < budget


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_time_parallel_engine_matches_golden(golden, scheme):
    ctrl = _controller(golden, scheme)
    plant = LTIParams(
        FOUR_TANK["A"], FOUR_TANK["B"], FOUR_TANK["C"], FOUR_TANK["D"]
    )
    bm = build_linear_engine(
        ctrl, plant, solves_per_block=10, dtype=jnp.float64
    )
    x0, up, yp, W, n_steps, n_mpc_step = _inputs(
        golden, scheme, jnp.float64
    )
    result = time_parallel_rollout(
        bm, x0, up, yp, W, n_steps=n_steps, n_mpc_step=n_mpc_step
    )
    assert _du(result.u_sys, golden, scheme) < F64_BUDGET


@pytest.mark.parametrize("scheme", ["TEC"])
def test_pallas_kernel_matches_golden(golden, scheme):
    """The fused condensed rollout (the bench headline engine) must
    hit the same float32 budget as the other engines."""
    from direct_data_driven_mpc_jax.ops.fused_rollout import (
        fused_batched_rollout,
    )

    ctrl = _controller(golden, scheme)
    plant = LTIParams(
        FOUR_TANK["A"], FOUR_TANK["B"], FOUR_TANK["C"], FOUR_TANK["D"]
    )
    bm = build_linear_engine(
        ctrl, plant, solves_per_block=10, dtype=jnp.float32
    )
    x0, up, yp, W, n_steps, n_mpc_step = _inputs(
        golden, scheme, jnp.float32
    )
    result = fused_batched_rollout(
        bm, x0[None], up[None], yp[None], W[None], n_steps=n_steps,
    )
    assert _du(result.u_sys[0], golden, scheme) < F32_BUDGET

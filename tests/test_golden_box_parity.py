"""End-to-end golden parity for the INEQUALITY-constrained loops.

``tests/golden/four_tank_box_golden.npz`` (generate_golden_box.py)
holds seeded closed-loop trajectories for

- the CONVEX slack box (paper Remark 3; reference
  direct_data_driven_mpc_controller.py:658-675) at c = 0.05 (the box
  binds on 92% of solves -- measured during generation), and
- a saturated input box |u| <= 0.85 (beyond the reference),

produced by an INDEPENDENT float64 primal ACTIVE-SET solver (a
different algorithm family from the shipped ADMM) through a plain
Python Algorithm-1 loop, every solve certified by a full KKT check.
The device ADMM engines must reproduce the applied inputs to the
north-star budget.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.controller import (
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_jax.control.loop import closed_loop_rollout
from direct_data_driven_mpc_jax.ops.lti import LTIParams
from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

from tests.test_closed_loop import FOUR_TANK

GOLDEN = os.path.join(
    os.path.dirname(__file__), "golden", "four_tank_box_golden.npz"
)

F32_BUDGET = 1e-4  # the north-star deviation bar
F64_BUDGET = 3e-6  # iterative solver at tol 1e-6 vs the exact solve


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _controller(golden, scheme):
    kw = dict(
        n=4, m=2, p=2,
        u_d=golden["u_d"], y_d=golden["y_d"], L=30,
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


def _run(golden, scheme, solver, dtype, admm_iters):
    n_steps = golden[f"{scheme}_u"].shape[0]
    plant = LTIParams(
        *(jnp.asarray(a, dtype)
          for a in (FOUR_TANK["A"], FOUR_TANK["B"],
                    FOUR_TANK["C"], FOUR_TANK["D"]))
    )
    return closed_loop_rollout(
        plant, solver,
        jnp.asarray(golden["x0"], dtype),
        jnp.asarray(golden[f"{scheme}_u_past0"], dtype),
        jnp.asarray(golden[f"{scheme}_y_past0"], dtype),
        jnp.asarray(golden["w_sys"][:n_steps], dtype),
        n_steps=n_steps, admm_iters=admm_iters,
    )


def _check(res, golden, scheme, budget):
    du = np.abs(
        np.asarray(res.u_sys, np.float64) - golden[f"{scheme}_u"]
    ).max()
    dy = np.abs(
        np.asarray(res.y_sys, np.float64) - golden[f"{scheme}_y"]
    ).max()
    assert du < budget and dy < 10 * budget, (du, dy)
    assert bool(np.all(np.asarray(res.converged)))
    np.testing.assert_allclose(
        np.asarray(res.costs, np.float64), golden[f"{scheme}_costs"],
        rtol=5e-3, atol=10 * budget,
    )
    return du


@pytest.mark.parametrize(
    "dtype,budget,iters",
    [(jnp.float64, F64_BUDGET, 200), (jnp.float32, F32_BUDGET, 60)],
    ids=["f64", "f32"],
)
def test_convex_slack_admm_matches_golden(golden, dtype, budget, iters):
    """Warm-started device ADMM (qp/admm.py) vs the active-set golden
    on the CONVEX slack box loop."""
    ctrl = _controller(golden, "CONVEX")
    solver = ctrl.admm_solver(dtype=dtype)
    res = _run(golden, "CONVEX", solver, dtype, iters)
    _check(res, golden, "CONVEX", budget)


@pytest.mark.parametrize(
    "dtype,budget,iters",
    [(jnp.float64, F64_BUDGET, 300), (jnp.float32, F32_BUDGET, 80)],
    ids=["f64", "f32"],
)
def test_box_admm_fixed_rho_matches_golden(golden, dtype, budget, iters):
    """Saturated-input box at the bench's fixed rho = 1.0 (qp/box.py)
    vs the active-set golden."""
    ctrl = _controller(golden, "BOX")
    solver = ctrl.box_admm_solver(
        u_bounds=(-float(golden["u_box"]), float(golden["u_box"])),
        rho=1.0, dtype=dtype,
    )
    res = _run(golden, "BOX", solver, dtype, iters)
    du = _check(res, golden, "BOX", budget)
    # The box genuinely bites: the applied inputs saturate.
    assert np.abs(np.asarray(res.u_sys)).max() <= float(
        golden["u_box"]
    ) + 1e-6
    assert du < budget


def test_box_admm_penalty_ladder_matches_golden(golden):
    """The adaptive penalty-ladder variant (default rho=None) settles
    onto the right rung and hits the same f32 budget."""
    ctrl = _controller(golden, "BOX")
    solver = ctrl.box_admm_solver(
        u_bounds=(-float(golden["u_box"]), float(golden["u_box"])),
        dtype=jnp.float32,
    )
    res = _run(golden, "BOX", solver, jnp.float32, 120)
    _check(res, golden, "BOX", F32_BUDGET)


def test_golden_box_activity_metadata(golden):
    """The fixture must actually exercise the projections (guards
    against a silently-inactive box making these tests vacuous)."""
    assert (golden["CONVEX_n_active"] > 0).mean() > 0.5
    assert (golden["BOX_n_active"] > 0).mean() > 0.9
    assert np.abs(golden["BOX_u"]).max() <= float(golden["u_box"]) + 1e-9

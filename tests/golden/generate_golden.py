"""Generate the golden closed-loop parity fixture.

The reference validates its implementation with a seeded reproduction
run (reference README.md:110-119, seed at
examples/robust_data_driven_mpc_reproduction.py:76-77); CVXPY is not
available in this image, so the committed golden trajectories are
produced by an INDEPENDENT tight-tolerance float64 solver of the
identical QP sequence: the null-space reduction of the equality-
constrained QP (the same algorithm as tests/test_qp.py::
_null_space_solve, precomputed once since A is constant), run through
a plain Python closed loop that mirrors the reference's Algorithm 1/2
semantics (utilities/controller/controller_operation.py:266-310).

This is a genuinely different solve path from the shipped engines
(pseudoinverse of the KKT matrix vs null-space reduction; Python loop
vs lax.scan/condensed recursion), so end-to-end agreement to <1e-4 on
the applied inputs certifies the whole pipeline, not one component.

Run from the repo root:  python tests/golden/generate_golden.py
Writes tests/golden/four_tank_golden.npz (committed).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import scipy.linalg

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from direct_data_driven_mpc_jax.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_jax.control.operation import (  # noqa: E402
    generate_initial_input_output_data,
    randomize_initial_system_state,
)
from direct_data_driven_mpc_jax.models.lti_model import LTIModel  # noqa: E402
from direct_data_driven_mpc_jax.qp.spec import (  # noqa: E402
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

FOUR_TANK = dict(
    A=np.array(
        [
            [0.921, 0, 0.041, 0],
            [0, 0.918, 0, 0.033],
            [0, 0, 0.924, 0],
            [0, 0, 0, 0.937],
        ]
    ),
    B=np.array([[0.017, 0.001], [0.001, 0.023], [0, 0.061], [0.072, 0]]),
    C=np.array([[1.0, 0, 0, 0], [0, 1, 0, 0]]),
    D=np.zeros((2, 2)),
    eps_max=0.002,
)

SEED = 0
N, L, n, m, p = 400, 30, 4, 2, 2

#: scheme name -> (n_mpc_step, use_terminal_constraint, n_steps)
SCHEMES = {
    "TEC": (1, True, 120),
    "TEC_N_STEP": (4, True, 120),
    # UCON is unstable for most seeds (reference README warning); keep
    # the golden window short enough that f64 trajectories stay small.
    "UCON": (1, False, 40),
}


class NullSpaceAffineSolver:
    """Per-step QP solve via null-space reduction, precomputed once.

    z(theta) minimizes z^T (H/2) z + g^T z s.t. A z = b_const + S theta.
    Parameterize z = P b + Nb xi with P = pinv(A) and Nb = null(A);
    the reduced problem min over xi is solved by the pseudoinverse of
    the reduced Hessian (exactly tests/test_qp.py::_null_space_solve,
    hoisted out of the loop because A is constant).
    """

    def __init__(self, spec):
        self.spec = spec
        A, H, g = spec.A, spec.H, spec.g
        self.P = np.linalg.pinv(A)
        self.Nb = scipy.linalg.null_space(A)
        Hr = self.Nb.T @ H @ self.Nb
        self.pinv_Hr = np.linalg.pinv(Hr)
        self.H, self.g = H, g

    def solve_u(self, theta: np.ndarray) -> np.ndarray:
        spec = self.spec
        b = spec.b_const + spec.S @ theta
        z_p = self.P @ b
        gr = self.Nb.T @ (self.H @ z_p + self.g)
        xi = -self.pinv_Hr @ gr
        z = z_p + self.Nb @ xi
        # Residual sanity: this is supposed to be an exact solve.
        assert np.abs(spec.A @ z - b).max() < 1e-8
        return z[spec.u_pred_slice]


def run_scheme(plant, ctrl, x0, w_sys, n_steps, n_mpc_step):
    """Reference-semantics closed loop (Algorithm 1/2) around the
    independent null-space solver."""
    solver = NullSpaceAffineSolver(ctrl.spec)
    x = x0.copy()
    u_past = ctrl.u_past.reshape(-1).copy()
    y_past = ctrl.y_past.reshape(-1).copy()
    A, B = FOUR_TANK["A"], FOUR_TANK["B"]
    C, D = FOUR_TANK["C"], FOUR_TANK["D"]
    u_sys = np.zeros((n_steps, m))
    y_sys = np.zeros((n_steps, p))
    for t in range(0, n_steps, n_mpc_step):
        theta = np.concatenate([u_past, y_past])
        u_opt = solver.solve_u(theta)
        for k in range(t, min(t + n_mpc_step, n_steps)):
            u_k = u_opt[(k - t) * m : (k - t + 1) * m]
            y_k = C @ x + D @ u_k + w_sys[k]
            x = A @ x + B @ u_k
            u_past = np.concatenate([u_past[m:], u_k])
            y_past = np.concatenate([y_past[p:], y_k])
            u_sys[k] = u_k
            y_sys[k] = y_k
    return u_sys, y_sys


def main() -> None:
    rng = np.random.default_rng(SEED)
    plant = LTIModel(**FOUR_TANK)
    config = {
        "u_range": (-1.0, 1.0),
        "N": N,
        "n": n,
        "eps_max": 0.002,
        "L": L,
    }
    x0 = randomize_initial_system_state(plant, config, rng)
    plant.set_state(x0)
    u_d, y_d = generate_initial_input_output_data(plant, config, rng)
    x0 = plant.get_state().copy()

    max_steps = max(s[2] for s in SCHEMES.values())
    w_sys = 0.002 * rng.uniform(-1.0, 1.0, (max_steps, p))

    out = {
        "seed": SEED,
        "u_d": u_d,
        "y_d": y_d,
        "x0": x0,
        "w_sys": w_sys,
    }
    for name, (n_mpc_step, use_terminal, n_steps) in SCHEMES.items():
        ctrl = DirectDataDrivenMPCController(
            n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L,
            Q=3.0 * np.eye(p * L), R=1e-4 * np.eye(m * L),
            u_s=np.array([[1.0], [1.0]]),
            y_s=np.array([[0.65], [0.77]]),
            eps_max=0.002, lamb_alpha=0.1 / 0.002, lamb_sigma=1000.0,
            c=1.0,
            slack_var_constraint_type=SlackVarConstraintTypes.NONE,
            controller_type=DataDrivenMPCType.ROBUST,
            n_mpc_step=n_mpc_step,
            use_terminal_constraint=use_terminal,
        )
        u_sys, y_sys = run_scheme(
            plant, ctrl, x0, w_sys, n_steps, n_mpc_step
        )
        out[f"{name}_u"] = u_sys
        out[f"{name}_y"] = y_sys
        out[f"{name}_u_past0"] = ctrl.u_past.reshape(n, m)
        out[f"{name}_y_past0"] = ctrl.y_past.reshape(n, p)
        print(
            f"{name}: {n_steps} steps, |u|max={np.abs(u_sys).max():.4f}, "
            f"y_final={y_sys[-1]}"
        )

    path = os.path.join(os.path.dirname(__file__), "four_tank_golden.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()

"""Generate golden closed-loop fixtures for the INEQUALITY-constrained
variants (CONVEX slack box + saturated input box).

The slack-NONE golden (generate_golden.py) pins the affine engines to
an independent null-space solver; the ADMM engines (qp/admm.py CONVEX
slack, qp/box.py input box) were previously validated only by per-solve
KKT checks. Here the independent high-accuracy reference is a PRIMAL
ACTIVE-SET solver (a genuinely different algorithm family from ADMM:
combinatorial working-set iteration over exact float64 pinned-KKT
solves, terminated by a full KKT certificate per solve), run through a
plain Python closed loop with reference Algorithm 1/2 semantics
(reference utilities/controller/controller_operation.py:266-310; the
CONVEX slack box is reference direct_data_driven_mpc_controller.py:
658-675 / paper Remark 3 -- the input box is beyond the reference).

Every solve's KKT conditions (stationarity, primal feasibility, dual
sign, complementary slackness) are asserted to ~1e-9 in float64, so
the committed trajectories are certified optimal regardless of how the
working set was found.

Run from the repo root:  python tests/golden/generate_golden_box.py
Writes tests/golden/four_tank_box_golden.npz (committed).
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from direct_data_driven_mpc_jax.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_jax.control.operation import (  # noqa: E402
    generate_initial_input_output_data,
    randomize_initial_system_state,
)
from direct_data_driven_mpc_jax.models.lti_model import LTIModel  # noqa: E402
from direct_data_driven_mpc_jax.qp.box import (  # noqa: E402
    _box_rows_and_bounds,
)
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
N_STEPS = 120

#: CONVEX-slack bound coefficient. At the example config's c = 1.0 the
#: sigma box never binds on this trajectory (the solve degenerates to
#: slack-NONE and the fixture would not test the projection at all);
#: measured activity on this seed: c=0.25 -> 4% of solves, c=0.1 ->
#: 15%, c=0.05 -> 93% with <= 13 active rows -- c = 0.05 keeps the box
#: genuinely active while the loop stays well-behaved.
CONVEX_C = 0.05
#: Saturated actuator box (below the ~1.0 steady-state input, so the
#: constraint is permanently active) -- matches bench four_tank_box.
U_BOX = 0.85


class ActiveSetBoxSolver:
    """Primal active-set solver for
    ``min z^T (H/2) z + g^T z  s.t.  A z = b,  lo <= z[rows] <= hi``.

    Working-set iteration: pin the guessed-active rows to their bounds,
    solve the equality-KKT system exactly (float64), then update the
    guess from bound violations (add) and wrong-sign multipliers
    (drop). Warm-started with the previous closed-loop step's working
    set this settles in 0-3 iterations; an anti-cycling fallback
    switches to single-row updates if the joint update ping-pongs.
    Every returned solution carries a full KKT certificate.
    """

    def __init__(self, spec, rows, lo, hi, tol: float = 1e-10):
        self.spec = spec
        self.rows = np.asarray(rows, dtype=int)
        self.lo = np.asarray(lo, dtype=np.float64)
        self.hi = np.asarray(hi, dtype=np.float64)
        self.tol = tol
        self.H, self.g, self.A = spec.H, spec.g, spec.A
        self.nz, self.nc = spec.nz, spec.nc
        # Working set: {box-row index in 0..nbox-1: side}, side +1 for
        # the upper bound, -1 for the lower.
        self.W: dict[int, int] = {}
        self.kkt_iters: list[int] = []

    def _pinned_solve(self, b, W):
        """Exact KKT solve with the rows of ``W`` pinned to their
        bounds. Returns (z, mu) with mu the pinned-row multipliers."""
        idx = sorted(W)
        k = len(idx)
        dim = self.nz + self.nc + k
        K = np.zeros((dim, dim))
        K[: self.nz, : self.nz] = self.H
        K[: self.nz, self.nz : self.nz + self.nc] = self.A.T
        K[self.nz : self.nz + self.nc, : self.nz] = self.A
        rhs = np.zeros(dim)
        rhs[: self.nz] = -self.g
        rhs[self.nz : self.nz + self.nc] = b
        for j, i in enumerate(idx):
            r = self.rows[i]
            K[: self.nz, self.nz + self.nc + j][r] = 1.0
            K[self.nz + self.nc + j, r] = 1.0
            rhs[self.nz + self.nc + j] = (
                self.hi[i] if W[i] > 0 else self.lo[i]
            )
        try:
            sol = np.linalg.solve(K, rhs)
        except np.linalg.LinAlgError:
            sol = np.linalg.lstsq(K, rhs, rcond=None)[0]
        z = sol[: self.nz]
        mu = {i: sol[self.nz + self.nc + j] for j, i in enumerate(idx)}
        # Stationarity residual of the pinned system (exact solve).
        res = np.abs(K @ sol - rhs).max()
        assert res < 1e-8, f"pinned KKT solve residual {res}"
        return z, mu

    def solve(self, theta: np.ndarray):
        """Returns ``(z, cost, n_active)``; certifies KKT optimality."""
        spec = self.spec
        b = spec.b_const + spec.S @ theta
        tol = self.tol
        W = dict(self.W)
        single_row_mode = False
        for it in range(200):
            z, mu = self._pinned_solve(b, W)
            v = z[self.rows]
            # Violations among inactive rows; wrong-sign multipliers
            # among active rows (Lagrangian sign convention: upper
            # bound needs mu >= 0, lower needs mu <= 0).
            viol = {}
            for i in range(self.rows.size):
                if i in W:
                    continue
                if v[i] > self.hi[i] + tol:
                    viol[i] = (1, v[i] - self.hi[i])
                elif v[i] < self.lo[i] - tol:
                    viol[i] = (-1, self.lo[i] - v[i])
            wrong = {
                i: abs(mu[i])
                for i in W
                if (W[i] > 0 and mu[i] < -tol)
                or (W[i] < 0 and mu[i] > tol)
            }
            if not viol and not wrong:
                self.W = W
                self.kkt_iters.append(it)
                self._certify(z, mu, W, b)
                cost = 0.5 * z @ self.H @ z + self.g @ z + spec.r0
                return z, float(cost), len(W)
            if single_row_mode or it >= 30:
                # Anti-cycling: change exactly one row per iteration
                # (most-violated first, then most-wrong multiplier).
                single_row_mode = True
                if viol:
                    i = max(viol, key=lambda i: viol[i][1])
                    W[i] = viol[i][0]
                else:
                    i = max(wrong, key=wrong.get)
                    del W[i]
            else:
                for i, (side, _) in viol.items():
                    W[i] = side
                for i in wrong:
                    del W[i]
        raise RuntimeError("active-set iteration did not settle")

    def _certify(self, z, mu, W, b, tol: float = 1e-8):
        """Full KKT certificate in float64."""
        grad = self.H @ z + self.g
        # Recover nu from the equality rows: stationarity restricted to
        # the complement is already enforced by the pinned solve; here
        # re-check the ORIGINAL problem's conditions explicitly.
        E_mu = np.zeros(self.nz)
        for i, side in W.items():
            E_mu[self.rows[i]] += mu[i]
        # Stationarity: grad + A^T nu + E^T mu = 0 for some nu -- check
        # by projecting onto null(A^T) complement: solve least squares.
        nu = np.linalg.lstsq(self.A.T, -(grad + E_mu), rcond=None)[0]
        stat = np.abs(grad + E_mu + self.A.T @ nu).max()
        assert stat < tol, f"stationarity residual {stat}"
        assert np.abs(self.A @ z - b).max() < tol
        v = z[self.rows]
        assert np.all(v <= self.hi + tol) and np.all(v >= self.lo - tol)
        for i, side in W.items():
            m_i = mu[i]
            assert (side > 0 and m_i >= -tol) or (
                side < 0 and m_i <= tol
            ), f"dual sign violated: row {i}, side {side}, mu {m_i}"
            bound = self.hi[i] if side > 0 else self.lo[i]
            assert abs(v[i] - bound) < tol  # complementary slackness


def run_box_scheme(ctrl, rows, lo, hi, x0, w_sys, n_steps):
    """Reference-semantics Algorithm-1 loop around the active-set
    solver (mirrors generate_golden.py::run_scheme)."""
    solver = ActiveSetBoxSolver(ctrl.spec, rows, lo, hi)
    spec = ctrl.spec
    x = x0.copy()
    u_past = ctrl.u_past.reshape(-1).copy()
    y_past = ctrl.y_past.reshape(-1).copy()
    A, B = FOUR_TANK["A"], FOUR_TANK["B"]
    C, D = FOUR_TANK["C"], FOUR_TANK["D"]
    u_sys = np.zeros((n_steps, m))
    y_sys = np.zeros((n_steps, p))
    costs = np.zeros(n_steps)
    n_active = np.zeros(n_steps, dtype=int)
    for t in range(n_steps):
        theta = np.concatenate([u_past, y_past])
        z, costs[t], n_active[t] = solver.solve(theta)
        u_opt = z[spec.u_pred_slice]
        u_k = u_opt[:m]
        y_k = C @ x + D @ u_k + w_sys[t]
        x = A @ x + B @ u_k
        u_past = np.concatenate([u_past[m:], u_k])
        y_past = np.concatenate([y_past[p:], y_k])
        u_sys[t] = u_k
        y_sys[t] = y_k
    return u_sys, y_sys, costs, n_active, solver.kkt_iters


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
    w_sys = 0.002 * rng.uniform(-1.0, 1.0, (N_STEPS, p))

    out = {
        "seed": SEED,
        "u_d": u_d,
        "y_d": y_d,
        "x0": x0,
        "w_sys": w_sys,
        "convex_c": CONVEX_C,
        "u_box": U_BOX,
    }

    base = dict(
        n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(p * L), R=1e-4 * np.eye(m * L),
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
        eps_max=0.002, lamb_alpha=0.1 / 0.002, lamb_sigma=1000.0,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
    )

    # --- CONVEX slack box (paper Remark 3, ref :658-675) ---
    ctrl = DirectDataDrivenMPCController(
        **base, c=CONVEX_C,
        slack_var_constraint_type=SlackVarConstraintTypes.CONVEX,
    )
    sl = ctrl.spec.sigma_pred_slice
    rows = np.arange(sl.start, sl.stop)
    bnd = float(ctrl.spec.sigma_bound)
    u_sys, y_sys, costs, n_act, iters = run_box_scheme(
        ctrl, rows, -bnd * np.ones(rows.size), bnd * np.ones(rows.size),
        x0, w_sys, N_STEPS,
    )
    frac_active = float((n_act > 0).mean())
    print(
        f"CONVEX (c={CONVEX_C}): active-box solves {frac_active:.2f}, "
        f"max active rows {n_act.max()}, max AS iters {max(iters)}, "
        f"y_final={y_sys[-1]}"
    )
    assert frac_active > 0.5, (
        "sigma box almost never binds -- fixture would not test the "
        "projection; tighten CONVEX_C"
    )
    out.update(
        CONVEX_u=u_sys, CONVEX_y=y_sys, CONVEX_costs=costs,
        CONVEX_n_active=n_act,
        CONVEX_u_past0=ctrl.u_past.reshape(n, m),
        CONVEX_y_past0=ctrl.y_past.reshape(n, p),
    )

    # --- Saturated input box (beyond the reference; bench
    # four_tank_box) ---
    ctrl = DirectDataDrivenMPCController(
        **base, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
    )
    rows, lo, hi, _, _ = _box_rows_and_bounds(
        ctrl.spec, (-U_BOX, U_BOX), None, True
    )
    u_sys, y_sys, costs, n_act, iters = run_box_scheme(
        ctrl, rows, lo, hi, x0, w_sys, N_STEPS
    )
    frac_active = float((n_act > 0).mean())
    print(
        f"BOX (|u|<={U_BOX}): active-box solves {frac_active:.2f}, "
        f"max active rows {n_act.max()}, max AS iters {max(iters)}, "
        f"|u|max={np.abs(u_sys).max():.4f}, y_final={y_sys[-1]}"
    )
    assert np.abs(u_sys).max() <= U_BOX + 1e-9
    assert frac_active > 0.9, "input box should be essentially always active"
    out.update(
        BOX_u=u_sys, BOX_y=y_sys, BOX_costs=costs, BOX_n_active=n_act,
        BOX_u_past0=ctrl.u_past.reshape(n, m),
        BOX_y_past0=ctrl.y_past.reshape(n, p),
    )

    path = os.path.join(
        os.path.dirname(__file__), "four_tank_box_golden.npz"
    )
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()

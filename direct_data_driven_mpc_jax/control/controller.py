"""Reference-parity Direct Data-Driven MPC controller class.

API parity with the reference's ``DirectDataDrivenMPCController``
(direct_data_driven_mpc/direct_data_driven_mpc_controller.py:22-982):
same constructor signature, validation rules, method names and
semantics. Architecture is entirely different: instead of rebuilding a
CVXPY problem every step (ref :389-407), construction assembles the
static QP spec once and derives an exact affine solution operator
(slack ``NONE``) or a pre-factorized ADMM operator (``CONVEX``); the
per-step "solve" is then a ~microsecond host matvec in float64 -- exact
KKT solutions, vs CVXPY's iterative-solver tolerance.

This class is the interactive single-scenario surface. For large-scale
batched simulation use the same operators on-device through
:meth:`solution_map` / :meth:`admm_solver` /
``control.loop.closed_loop_rollout`` (the per-step work here is 16
numbers in, 60 out -- far below device dispatch overhead, so the host
path is the right tool at batch size one).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from direct_data_driven_mpc_jax.ops.host import (
    evaluate_persistent_excitation_np,
    hankel_matrix_np,
)
from direct_data_driven_mpc_jax.qp.admm import (
    admm_solve_np,
    compute_admm_operator_np,
    compute_admm_solver,
    ADMMSolver,
)
from direct_data_driven_mpc_jax.qp.assembly import build_qp_spec
from direct_data_driven_mpc_jax.qp.solution_map import (
    compute_solution_map,
    compute_solution_operator_np,
    compute_tracking_map,
    SolutionMap,
    TrackingMap,
)
from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    QPDims,
    SlackVarConstraintTypes,
)


class DirectDataDrivenMPCController:
    """Nominal / Robust direct data-driven MPC controller.

    Attributes mirror the reference (ref :29-87): ``n, m, p, u_d, y_d,
    N, u_past, y_past, L, Q, R, u_s, y_s, eps_max, lamb_alpha,
    lamb_sigma, c, slack_var_constraint_type, n_mpc_step,
    use_terminal_constraint, HLn_ud, HLn_yd, optimal_u``.
    """

    def __init__(
        self,
        n: int,
        m: int,
        p: int,
        u_d: np.ndarray,
        y_d: np.ndarray,
        L: int,
        Q: np.ndarray,
        R: np.ndarray,
        u_s: np.ndarray,
        y_s: np.ndarray,
        eps_max: Optional[float] = None,
        lamb_alpha: Optional[float] = None,
        lamb_sigma: Optional[float] = None,
        c: Optional[float] = None,
        slack_var_constraint_type: SlackVarConstraintTypes = (
            SlackVarConstraintTypes.CONVEX
        ),
        controller_type: DataDrivenMPCType = DataDrivenMPCType.NOMINAL,
        n_mpc_step: int = 1,
        use_terminal_constraint: bool = True,
        admm_iters: int = 200,
        allow_nonconvex_slack: bool = False,
    ):
        self.controller_type = controller_type
        if controller_type not in (
            DataDrivenMPCType.NOMINAL,
            DataDrivenMPCType.ROBUST,
        ):
            raise ValueError("Unsupported controller type.")

        self.n = n
        self.m = m
        self.p = p
        self.u_d = np.asarray(u_d, dtype=np.float64)
        self.y_d = np.asarray(y_d, dtype=np.float64)
        self.N = self.u_d.shape[0]

        # Past-measurement windows seeded with the last n data samples
        # (column vectors, reference semantics ref :184-185).
        self.u_past = self.u_d[-n:, :].reshape(-1, 1)
        self.y_past = self.y_d[-n:, :].reshape(-1, 1)

        self.L = L
        self.Q = np.asarray(Q, dtype=np.float64)
        self.R = np.asarray(R, dtype=np.float64)
        self.u_s = np.asarray(u_s, dtype=np.float64)
        self.y_s = np.asarray(y_s, dtype=np.float64)

        self.eps_max = eps_max
        self.lamb_alpha = lamb_alpha
        self.lamb_sigma = lamb_sigma
        self.c = c

        self.slack_var_constraint_type = slack_var_constraint_type
        if slack_var_constraint_type not in (
            SlackVarConstraintTypes.NON_CONVEX,
            SlackVarConstraintTypes.CONVEX,
            SlackVarConstraintTypes.NONE,
        ):
            raise ValueError("Unsupported slack variable constraint type.")

        if self.controller_type == DataDrivenMPCType.ROBUST:
            if None in (eps_max, lamb_alpha, lamb_sigma, c):
                raise ValueError(
                    "All robust MPC parameters (eps_max, lamb_alpha, "
                    "lamb_sigma, c) must be provided for a 'ROBUST' "
                    "controller."
                )

        if not 1 <= n_mpc_step <= L:
            # The applied sequence ubar*[0, n_mpc_step-1] must lie
            # inside the optimized prediction segment [0, L-1].
            raise ValueError(
                f"n_mpc_step ({n_mpc_step}) must be in [1, L={L}]."
            )
        self.n_mpc_step = n_mpc_step
        self.use_terminal_constraint = use_terminal_constraint
        self.admm_iters = admm_iters
        # Opt-in solver for the paper's Eq. 6d NON_CONVEX slack variant
        # (the reference raises NotImplementedError for it; with this
        # flag the convex-concave solver in qp/nonconvex.py is used).
        self.allow_nonconvex_slack = allow_nonconvex_slack
        self._admm_state: Optional[tuple] = None
        self._status = "unsolved"
        self._cost_value: Optional[float] = None

        self.evaluate_input_persistent_excitation()
        self.check_prediction_horizon_length()
        self.check_weighting_matrices_dimensions()
        self.initialize_data_driven_mpc()

    # --- validation (reference rules) ------------------------------------
    def evaluate_input_persistent_excitation(self) -> None:
        """PE of order (L + 2n): length bound (paper Remark 1) + Hankel
        rank check (Definition 1). Reference: ref :242-296."""
        u_d_n = self.u_d.shape[1]
        if u_d_n != self.m:
            raise ValueError(
                f"The length of the elements of the data sequence ({u_d_n}) "
                f"should match the number of inputs of the system "
                f"({self.m})."
            )
        N_min = self.m * (self.L + 2 * self.n) + self.L + 2 * self.n - 1
        if self.N < N_min:
            raise ValueError(
                "Initial input trajectory data is not persistently exciting "
                "of order (L + 2 * n). It does not satisfy the inequality: "
                "N - L - 2 * n + 1 >= m * (L + 2 * n). The required minimum "
                f"N is {N_min}, but got {self.N}."
            )
        expected_order = self.L + 2 * self.n
        rank, ok = evaluate_persistent_excitation_np(
            self.u_d, order=expected_order
        )
        if not ok:
            raise ValueError(
                "Initial input trajectory data is not persistently exciting "
                "of order (L + 2 * n). The rank of its induced Hankel "
                f"matrix ({rank}) does not match the expected rank "
                f"({u_d_n * expected_order})."
            )

    def check_prediction_horizon_length(self) -> None:
        """Nominal: L >= n (Assumption 3); Robust: L >= 2n (Assumption
        4). Reference: ref :298-325."""
        if self.controller_type == DataDrivenMPCType.NOMINAL:
            if self.L < self.n:
                raise ValueError(
                    "The prediction horizon (`L`) must be greater than or "
                    "equal to the estimated system order `n`."
                )
        elif self.controller_type == DataDrivenMPCType.ROBUST:
            if self.L < 2 * self.n:
                raise ValueError(
                    "The prediction horizon (`L`) must be greater than or "
                    "equal to two times the estimated system order `n`."
                )

    def check_weighting_matrices_dimensions(self) -> None:
        """Q must be (pL, pL), R must be (mL, mL). Reference: ref
        :327-343."""
        if self.Q.shape != (self.p * self.L, self.p * self.L):
            raise ValueError(
                "Output weighting square matrix Q should be of order (p * L)"
            )
        if self.R.shape != (self.m * self.L, self.m * self.L):
            raise ValueError(
                "Input weighting square matrix R should be of order (m * L)"
            )

    # --- construction ----------------------------------------------------
    def initialize_data_driven_mpc(self) -> None:
        """Build Hankels, assemble the static QP, derive the per-step
        solution operator, and validate with an initial solve
        (reference pipeline: ref :345-387)."""
        self.HLn_ud = hankel_matrix_np(self.u_d, self.L + self.n)
        self.HLn_yd = hankel_matrix_np(self.y_d, self.L + self.n)

        dims = QPDims(n=self.n, m=self.m, p=self.p, L=self.L, N=self.N)
        self._spec = build_qp_spec(
            self.HLn_ud,
            self.HLn_yd,
            dims,
            Q=self.Q,
            R=self.R,
            u_s=self.u_s,
            y_s=self.y_s,
            controller_type=self.controller_type,
            eps_max=self.eps_max,
            lamb_alpha=self.lamb_alpha,
            lamb_sigma=self.lamb_sigma,
            c=self.c,
            slack_var_constraint_type=self.slack_var_constraint_type,
            use_terminal_constraint=self.use_terminal_constraint,
            allow_nonconvex_slack=self.allow_nonconvex_slack,
        )

        self._use_admm = (
            self._spec.slack_var_constraint_type
            == SlackVarConstraintTypes.CONVEX
        )
        self._use_nonconvex = (
            self._spec.slack_var_constraint_type
            == SlackVarConstraintTypes.NON_CONVEX
        )
        if self._use_nonconvex:
            from direct_data_driven_mpc_jax.qp.nonconvex import (
                compute_nonconvex_operator_np,
            )

            self._op = compute_nonconvex_operator_np(self._spec)
        elif self._use_admm:
            self._op = compute_admm_operator_np(self._spec)
        else:
            self._op = compute_solution_operator_np(self._spec)
            if not self._op["feasible"]:
                # Parity with the reference's failing initial solve
                # (ref :386 + :804-808): an operator whose affine map
                # cannot satisfy the equality constraints means the
                # problem is infeasible for some past windows.
                raise ValueError(
                    "MPC problem is infeasible: the equality "
                    "constraints are inconsistent (primal residuals "
                    f"{self._op['primal_residual_const']:.2e} const / "
                    f"{self._op['primal_residual_gain']:.2e} gain)."
                )
        self._admm_state = None

        # Optional native (C) hot path for the per-step solve; falls
        # back to NumPy transparently when no compiler is available.
        # (No native path for the NON_CONVEX variant yet: its host
        # solve is already microseconds via the pre-factorized ADMM.)
        self._native = None
        if not self._use_nonconvex:
            try:
                from direct_data_driven_mpc_jax import native as _native_mod

                if _native_mod.get_lib() is not None:
                    self._native = (
                        _native_mod.NativeADMMSolver(self._op)
                        if self._use_admm
                        else _native_mod.NativeAffineSolver(self._op)
                    )
            except Exception:
                self._native = None

        # Initial solve validates the formulation and populates
        # optimal_u (reference does the same, ref :386-387).
        self.update_and_solve_data_driven_mpc()

    @property
    def spec(self):
        """The assembled static QP spec (for tests / device solvers)."""
        return self._spec

    def solution_map(self, dtype=None) -> SolutionMap:
        """Device-resident exact affine operator (slack NONE paths)."""
        import jax.numpy as jnp

        if self._use_admm or self._use_nonconvex:
            raise ValueError(
                "CONVEX/NON_CONVEX slack controllers use iterative "
                "operators; call admm_solver() / nonconvex_admm_solver()."
            )
        return compute_solution_map(
            self._spec, dtype=dtype or jnp.float32
        )

    def solution_operator(self) -> dict:
        """The float64 affine solution operator (slack-NONE paths): the
        public entry for the condensed engine
        (``control.linear_engine.build_affine_block_map`` /
        ``build_linear_engine``). Keys: ``z_base, Z, u_base, U_gain,
        cost_P, cost_q, cost_r`` (see
        ``qp.solution_map.compute_solution_operator_np``)."""
        if self._use_admm or self._use_nonconvex:
            raise ValueError(
                "CONVEX/NON_CONVEX slack controllers do not condense to "
                "an affine operator; use admm_solver() / "
                "nonconvex_admm_solver() with the generic engine."
            )
        return self._op

    def tracking_map(self, dtype=None) -> TrackingMap:
        """Setpoint-parametric device operator ``u*(theta, [u_s; y_s])``
        (slack-NONE paths): time-varying reference tracking in the
        fused engine with zero re-initialization -- pass a per-solve
        ``setpoints`` schedule to ``control.loop.closed_loop_rollout``.
        (The reference retargets only by re-running its whole init
        pipeline, ref :945-982.)"""
        import jax.numpy as jnp

        if self._use_admm or self._use_nonconvex:
            raise ValueError(
                "CONVEX/NON_CONVEX slack controllers do not condense to "
                "an affine operator; tracking schedules need a "
                "slack-NONE controller."
            )
        return compute_tracking_map(
            self._spec, dtype=dtype or jnp.float32
        )

    def tracking_operator(self) -> dict:
        """The float64 setpoint-parametric operator dict (slack-NONE
        paths): the public entry for the TRACKING condensed engine
        (``control.linear_engine.build_tracking_engine`` /
        ``build_affine_block_map(..., tracking_op=...)``). Keys:
        ``U_theta, U_r, cost_P, u_s, y_s, ...`` (see
        ``qp.solution_map.compute_tracking_operator_np``)."""
        from direct_data_driven_mpc_jax.qp.solution_map import (
            compute_tracking_operator_np,
        )

        if self._use_admm or self._use_nonconvex:
            raise ValueError(
                "CONVEX/NON_CONVEX slack controllers do not condense to "
                "an affine operator; tracking schedules need a "
                "slack-NONE controller."
            )
        return compute_tracking_operator_np(self._spec)

    def admm_solver(self, dtype=None) -> ADMMSolver:
        """Device-resident ADMM operator (CONVEX slack paths)."""
        import jax.numpy as jnp

        if not self._use_admm:
            raise ValueError(
                "admm_solver() is the CONVEX-slack operator; slack-NONE "
                "controllers use solution_map(), NON_CONVEX ones "
                "nonconvex_admm_solver()."
            )
        return compute_admm_solver(self._spec, dtype=dtype or jnp.float32)

    def box_admm_solver(
        self,
        u_bounds=None,
        y_bounds=None,
        rho=None,
        alpha: float = 1.6,
        dtype=None,
    ):
        """Device-resident general-box ADMM operator (qp/box.py):
        actuator saturation ``u_min <= u <= u_max`` and/or output
        corridors ``y_min <= y <= y_max`` over the whole prediction
        horizon -- practical MPC constraints the reference cannot
        express at all (its only inequality is the CONVEX slack box,
        ref :658-675, which is kept automatically when present).

        Bounds are ``(lo, hi)`` pairs of scalars or per-channel arrays;
        ``None`` on either side means unbounded. Feed the returned
        solver to ``control.loop.closed_loop_rollout`` (warm-started
        across steps like the CONVEX-slack ADMM).
        """
        import jax.numpy as jnp

        from direct_data_driven_mpc_jax.qp.box import (
            compute_box_admm_solver,
        )

        if self._use_nonconvex:
            raise ValueError(
                "box constraints with the NON_CONVEX slack variant are "
                "not supported (its bound is state-dependent)."
            )
        return compute_box_admm_solver(
            self._spec, u_bounds=u_bounds, y_bounds=y_bounds,
            rho=rho, alpha=alpha, dtype=dtype or jnp.float32,
        )

    def nonconvex_admm_solver(self, dtype=None):
        """Device-resident convex-concave operator for the NON_CONVEX
        slack variant (paper Eq. 6d; qp/nonconvex.py). Only available
        when constructed with ``allow_nonconvex_slack=True`` -- a
        capability the reference lacks (ref :666-670 raises)."""
        import jax.numpy as jnp

        from direct_data_driven_mpc_jax.qp.nonconvex import (
            compute_nonconvex_admm_solver,
        )

        if not self._use_nonconvex:
            raise ValueError(
                "nonconvex_admm_solver() requires a NON_CONVEX slack "
                "controller (allow_nonconvex_slack=True)."
            )
        return compute_nonconvex_admm_solver(
            self._spec, dtype=dtype or jnp.float32
        )

    # --- per-step solve ---------------------------------------------------
    def _theta(self) -> np.ndarray:
        return np.concatenate(
            [self.u_past.reshape(-1), self.y_past.reshape(-1)]
        )

    def update_and_solve_data_driven_mpc(self) -> None:
        """Solve the MPC problem at the current past window and store
        the optimal control input (reference: ref :389-407; here a
        single affine matvec or warm-started ADMM run)."""
        self.solve_mpc_problem()
        self.get_optimal_control_input()

    def solve_mpc_problem(self) -> str:
        theta = self._theta()
        if self._use_nonconvex:
            from direct_data_driven_mpc_jax.qp.nonconvex import (
                nonconvex_admm_solve_np,
            )

            u, cost, self._admm_state, stats = nonconvex_admm_solve_np(
                self._op,
                theta,
                inner_iters=self.admm_iters,
                state=self._admm_state,
            )
            converged = stats[-1]
            self._u_opt = u
            self._cost_value = cost
            self._status = (
                "optimal"
                if converged and np.isfinite(u).all()
                else "optimal_inaccurate"
                if np.isfinite(u).all()
                else "infeasible"
            )
            return self._status
        if self._use_admm:
            if self._native is not None:
                if self._admm_state is None:
                    nbox = self._native.nbox
                    self._admm_state = (
                        np.zeros(nbox), np.zeros(nbox)
                    )
                s, w = self._admm_state
                u, cost, _, r_prim, r_dual = self._native.solve(
                    theta, s, w, self.admm_iters, 1e-8
                )
                converged = r_prim <= 1e-8 and r_dual <= 1e-8
            else:
                u, cost, self._admm_state, (_, _, converged) = (
                    admm_solve_np(
                        self._op,
                        theta,
                        num_iters=self.admm_iters,
                        state=self._admm_state,
                    )
                )
            self._u_opt = u
            self._cost_value = cost
            self._status = (
                "optimal"
                if converged and np.isfinite(u).all()
                else "optimal_inaccurate"
                if np.isfinite(u).all()
                else "infeasible"
            )
        else:
            if self._native is not None:
                u, cost = self._native.solve(theta)
            else:
                op = self._op
                u = op["u_base"] + op["U_gain"] @ theta
                cost = float(
                    theta @ op["cost_P"] @ theta
                    + op["cost_q"] @ theta
                    + op["cost_r"]
                )
            self._u_opt = u
            self._cost_value = cost
            self._status = (
                "optimal" if np.isfinite(u).all() else "infeasible"
            )
        return self._status

    def get_problem_solve_status(self) -> str:
        return self._status

    def get_optimal_cost_value(self) -> float:
        return self._cost_value

    def get_optimal_control_input(self) -> np.ndarray:
        """Store/return ubar*[0, L-1] flattened (reference: ref
        :780-808)."""
        if self._status in ("optimal", "optimal_inaccurate"):
            self.optimal_u = self._u_opt.flatten()
            return self.optimal_u
        raise ValueError("MPC problem was not solved optimally.")

    def get_optimal_control_input_at_step(
        self, n_step: int = 0
    ) -> np.ndarray:
        """Slice the optimal input at prediction step ``n_step`` in
        [0, L-1] (reference: ref :810-842)."""
        if not 0 <= n_step < self.L:
            raise ValueError(
                f"The specified prediction time step ({n_step}) is out of "
                f"range. It should be within [0, {self.L - 1}]."
            )
        return self.optimal_u[n_step * self.m : (n_step + 1) * self.m]

    # --- measurement window ----------------------------------------------
    def store_input_output_measurement(
        self, u_current: np.ndarray, y_current: np.ndarray
    ) -> None:
        """Ring-buffer shift of the past-n window (reference: ref
        :844-895)."""
        expected_u0 = (self.m, 1)
        expected_y0 = (self.p, 1)
        if u_current.shape != expected_u0 or y_current.shape != expected_y0:
            raise ValueError(
                f"Incorrect dimensions. Expected dimensions are "
                f"{expected_u0} for u_current and {expected_y0} for "
                f"y_current, but got {u_current.shape} and "
                f"{y_current.shape} instead."
            )
        self.u_past = np.vstack([self.u_past[self.m :], u_current])
        self.y_past = np.vstack([self.y_past[self.p :], y_current])

    def set_past_input_output_data(
        self, u_past: np.ndarray, y_past: np.ndarray
    ) -> None:
        """Bulk-set the past window (reference: ref :897-943)."""
        expected_u = (self.n * self.m, 1)
        expected_y = (self.n * self.p, 1)
        if u_past.shape != expected_u:
            raise ValueError(
                f"Incorrect dimensions. u_past must be shaped as "
                f"{expected_u}. Got {u_past.shape}. instead"
            )
        if y_past.shape != expected_y:
            raise ValueError(
                f"Incorrect dimensions. y_past must be shaped as "
                f"{expected_y}. Got {y_past.shape} instead."
            )
        self.u_past = np.asarray(u_past, dtype=np.float64)
        self.y_past = np.asarray(y_past, dtype=np.float64)

    def set_input_output_setpoints(
        self, u_s: np.ndarray, y_s: np.ndarray
    ) -> None:
        """Online retargeting: swap setpoints and re-derive the solution
        operator (reference re-runs the full init, ref :945-982; here
        that is one KKT refactorization, no object reconstruction)."""
        if u_s.shape != self.u_s.shape:
            raise ValueError(
                f"Incorrect dimensions. u_s must have shape "
                f"{self.u_s.shape}, got {u_s.shape}"
            )
        if y_s.shape != self.y_s.shape:
            raise ValueError(
                f"Incorrect dimensions. y_s must have shape "
                f"{self.y_s.shape}, got {y_s.shape}"
            )
        self.u_s = np.asarray(u_s, dtype=np.float64)
        self.y_s = np.asarray(y_s, dtype=np.float64)
        self.initialize_data_driven_mpc()

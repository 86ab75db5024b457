"""Stateful LTI plant classes with reference-parity API.

Capability parity with ``utilities/model_simulation.py`` (LTIModel at
:9-288, LTISystemModel at :290-373). The classes are thin stateful
wrappers over the pure functional core in ``ops/lti.py`` /
``ops/estimation.py``: the state ``x`` is carried as a plain float64
numpy vector (interactive single-scenario use), while batched /
on-device simulation goes through ``LTIParams`` + ``lti_rollout``
directly (``as_params()`` hands out the pytree).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from direct_data_driven_mpc_jax.ops.host import (
    equilibrium_input_from_output_np,
    equilibrium_output_from_input_np,
    estimate_initial_state_np,
    lti_rollout_np,
    observability_matrix_np,
    toeplitz_input_output_matrix_np,
)
from direct_data_driven_mpc_jax.ops.lti import LTIParams
from direct_data_driven_mpc_jax.utils.config import load_yaml_config_params


class LTIModel:
    """Discrete-time LTI plant ``y = Cx + Du + w``, ``x' = Ax + Bu``.

    Output is computed BEFORE the state update (reference semantics,
    model_simulation.py:94-96).
    """

    def __init__(
        self,
        A: np.ndarray,
        B: np.ndarray,
        C: np.ndarray,
        D: np.ndarray,
        eps_max: float = 0.0,
    ):
        self.A = np.asarray(A, dtype=np.float64)
        self.B = np.asarray(B, dtype=np.float64)
        self.C = np.asarray(C, dtype=np.float64)
        self.D = np.asarray(D, dtype=np.float64)
        self.eps_max = float(eps_max)
        self.n = self.A.shape[0]
        self.m = self.B.shape[1]
        self.p = self.C.shape[0]
        self.x = np.zeros(self.n)
        # Precompute observability + Toeplitz (t = n) matrices for the
        # least-squares initial-state observer (ref :63-67).
        self.Ot = observability_matrix_np(self.A, self.C)
        self.Tt = toeplitz_input_output_matrix_np(
            self.A, self.B, self.C, self.D, self.n
        )

    # --- functional bridge ------------------------------------------------
    def as_params(self, dtype=None) -> LTIParams:
        """The plant as an :class:`LTIParams` pytree for scan/vmap use."""
        cast = (lambda a: np.asarray(a, dtype=dtype)) if dtype else np.asarray
        return LTIParams(
            A=cast(self.A), B=cast(self.B), C=cast(self.C), D=cast(self.D)
        )

    # --- simulation -------------------------------------------------------
    def simulate_step(self, u: np.ndarray, w: np.ndarray) -> np.ndarray:
        """One step; updates ``self.x`` and returns ``y`` of shape (p,)."""
        u = np.asarray(u, dtype=np.float64).reshape(self.m)
        w = np.asarray(w, dtype=np.float64).reshape(self.p)
        y = self.C @ self.x + self.D @ u + w
        self.x = self.A @ self.x + self.B @ u
        return y

    def simulate(
        self, U: np.ndarray, W: np.ndarray, steps: int
    ) -> np.ndarray:
        """Multi-step rollout; updates ``self.x``; returns ``(steps, p)``."""
        U = np.asarray(U, dtype=np.float64)[:steps]
        W = np.asarray(W, dtype=np.float64)[:steps]
        self.x, Y = lti_rollout_np(
            self.A, self.B, self.C, self.D, self.x, U, W
        )
        return Y

    # --- estimation -------------------------------------------------------
    def get_initial_state_from_trajectory(
        self, U: np.ndarray, Y: np.ndarray
    ) -> np.ndarray:
        """LS-observer estimate of the state at the START of the
        ``(U, Y)`` window (flattened length-``n*m``/``n*p`` vectors)."""
        return estimate_initial_state_np(self.Ot, self.Tt, U, Y)

    def get_equilibrium_output_from_input(
        self, u_eq: np.ndarray
    ) -> np.ndarray:
        return equilibrium_output_from_input_np(
            self.A, self.B, self.C, self.D, u_eq
        )

    def get_equilibrium_input_from_output(
        self, y_eq: np.ndarray
    ) -> np.ndarray:
        return equilibrium_input_from_output_np(
            self.A, self.B, self.C, self.D, y_eq
        )

    # --- accessors (reference API, ref :215-288) --------------------------
    def get_system_order(self) -> int:
        return self.n

    def get_number_inputs(self) -> int:
        return self.m

    def get_number_outputs(self) -> int:
        return self.p

    def get_state(self) -> np.ndarray:
        return self.x

    def get_eps_max(self) -> float:
        return self.eps_max

    def set_state(self, state: np.ndarray) -> None:
        state = np.asarray(state, dtype=np.float64)
        if state.shape != self.x.shape:
            raise ValueError(
                "Incorrect dimensions. Expected state shape "
                f"{self.x.shape}, but got {state.shape}"
            )
        self.x = state

    def set_eps_max(self, eps_max: float) -> None:
        self.eps_max = float(eps_max)


class LTISystemModel(LTIModel):
    """LTI plant loaded from a YAML config file (reference semantics:
    model_simulation.py:290-373, incl. shape validation)."""

    def __init__(
        self,
        config_file: str,
        model_key_value: Optional[str] = None,
        verbose: int = 0,
    ):
        self.verbose = verbose
        params = load_yaml_config_params(
            config_file=config_file, key=model_key_value
        )
        if verbose > 1:
            print(
                f"    Model parameters loaded from {config_file} with key "
                f"'{model_key_value}'"
            )
        if any(k not in params for k in ("A", "B", "C", "D")):
            raise ValueError(
                "Missing required matrices (A, B, C, or D) in the config "
                "file."
            )
        A = np.array(params["A"], dtype=float)
        B = np.array(params["B"], dtype=float)
        C = np.array(params["C"], dtype=float)
        D = np.array(params["D"], dtype=float)
        eps_max = params.get("eps_max", 0)

        if A.shape[0] != A.shape[1]:
            raise ValueError("Matrix A must be square.")
        if B.shape[0] != A.shape[0]:
            raise ValueError("Matrix B's row count must match A's.")
        if C.shape[1] != A.shape[1]:
            raise ValueError("Matrix C's column count must match A's.")
        if D.shape[0] != C.shape[0]:
            raise ValueError("Matrix D's row count must match C's.")

        super().__init__(A=A, B=B, C=C, D=D, eps_max=eps_max)

        if verbose == 1:
            print("System model initialized with loaded parameters")
        if verbose > 1:
            print("System model initialized with:")
            print(
                f"    A: {A.shape}, B: {B.shape}, C: {C.shape}, D: "
                f"{D.shape}, eps_max: {eps_max}"
            )

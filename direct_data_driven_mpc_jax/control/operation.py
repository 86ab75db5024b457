"""Closed-loop orchestration helpers.

Capability parity with
``utilities/controller/controller_operation.py`` (functions cited
per-symbol below). Two execution paths are provided for the control
loop itself:

- :func:`simulate_data_driven_mpc_control_loop` -- stateful,
  step-by-step (reference Algorithm 1/2 semantics, ref :201-331), using
  the controller class; right for interactive use and verbose tracing.
- the fused on-device engine in ``control/loop.py`` -- identical
  semantics, compiled to a single scan; right for benchmarking and
  scenario batching. ``tests/test_closed_loop.py`` asserts the two
  paths produce identical trajectories for identical noise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from numpy.random import Generator

from direct_data_driven_mpc_jax.control.controller import (
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_jax.models.lti_model import LTIModel
from direct_data_driven_mpc_jax.utils.config import (
    DataDrivenMPCParamsDictType,
)


def randomize_initial_system_state(
    system_model: LTIModel,
    controller_config: DataDrivenMPCParamsDictType,
    np_random: Generator,
) -> np.ndarray:
    """Generate a plausible random initial plant state.

    Random state in [-1, 1]^n -> simulate n steps with random inputs
    and bounded noise -> LS-estimate the state at the window start.
    Reference: controller_operation.py:13-77.
    """
    ns = system_model.get_system_order()
    mm = system_model.get_number_inputs()
    pp = system_model.get_number_outputs()
    eps_max_sim = system_model.get_eps_max()
    u_range = controller_config["u_range"]

    x_i0 = np_random.uniform(-1.0, 1.0, size=ns)
    system_model.set_state(state=x_i0)
    u_i = np_random.uniform(*u_range, (ns, mm))
    w_i = eps_max_sim * np_random.uniform(-1.0, 1.0, (ns, pp))
    y_i = system_model.simulate(U=u_i, W=w_i, steps=ns)
    return system_model.get_initial_state_from_trajectory(
        U=u_i.flatten(), Y=y_i.flatten()
    )


def generate_initial_input_output_data(
    system_model: LTIModel,
    controller_config: DataDrivenMPCParamsDictType,
    np_random: Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Persistently-exciting excitation phase: ``u_d ~ U(u_range)``,
    bounded noise, N-step plant rollout -> ``(u_d, y_d)``.
    Reference: controller_operation.py:79-135.
    """
    mm = system_model.get_number_inputs()
    pp = system_model.get_number_outputs()
    eps_max_sim = system_model.get_eps_max()
    N = controller_config["N"]
    u_range = controller_config["u_range"]

    u_d = np_random.uniform(*u_range, (N, mm))
    w_d = eps_max_sim * np_random.uniform(-1.0, 1.0, (N, pp))
    y_d = system_model.simulate(U=u_d, W=w_d, steps=N)
    return u_d, y_d


def simulate_n_input_output_measurements(
    system_model: LTIModel,
    controller_config: DataDrivenMPCParamsDictType,
    np_random: Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply the constant setpoint input for n steps (with noise) to
    produce a window for re-seeding a controller's past data.
    Reference: controller_operation.py:137-199.
    """
    mm = system_model.get_number_inputs()
    pp = system_model.get_number_outputs()
    eps_max_sim = system_model.get_eps_max()
    n = controller_config["n"]
    u_s = controller_config["u_s"]

    U_n = np.tile(u_s, (n, 1)).reshape(n, mm)
    W_n = eps_max_sim * np_random.uniform(-1.0, 1.0, (n, pp))
    Y_n = system_model.simulate(U=U_n, W=W_n, steps=n)
    return U_n, Y_n


def simulate_data_driven_mpc_control_loop(
    system_model: LTIModel,
    data_driven_mpc_controller: DirectDataDrivenMPCController,
    n_steps: int,
    np_random: Generator,
    verbose: int,
    w_sys: np.ndarray | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-loop simulation following the paper's Algorithm 1
    (1-step) / Algorithm 2 (n-step).

    Reference: controller_operation.py:201-331 (noise pre-drawn up
    front at :263; solve every ``n_mpc_step`` steps at :269-275; apply
    ubar*[k-t], step plant, shift window at :278-305).

    ``w_sys`` may be injected explicitly so the exact same noise can be
    fed to the fused device engine for parity tests.
    """
    mm = system_model.get_number_inputs()
    pp = system_model.get_number_outputs()
    eps_max_sim = system_model.get_eps_max()

    u_s = data_driven_mpc_controller.u_s
    y_s = data_driven_mpc_controller.y_s
    n_mpc_step = data_driven_mpc_controller.n_mpc_step

    u_sys = np.zeros((n_steps, mm))
    y_sys = np.zeros((n_steps, pp))

    if w_sys is None:
        w_sys = eps_max_sim * np_random.uniform(-1.0, 1.0, (n_steps, pp))

    for t in range(0, n_steps, n_mpc_step):
        # 1) Solve the data-driven MPC from the past n measurements.
        data_driven_mpc_controller.update_and_solve_data_driven_mpc()

        for k in range(t, min(t + n_mpc_step, n_steps)):
            # 2) Apply ubar*[k - t]; simulate; store the measurement.
            n_step = k - t
            u_sys[k, :] = (
                data_driven_mpc_controller.get_optimal_control_input_at_step(
                    n_step=n_step
                )
            )
            y_sys[k, :] = system_model.simulate_step(
                u=u_sys[k, :], w=w_sys[k, :]
            )
            data_driven_mpc_controller.store_input_output_measurement(
                u_current=u_sys[k, :].reshape(-1, 1),
                y_current=y_sys[k, :].reshape(-1, 1),
            )

        if verbose > 1:
            mpc_cost_val = data_driven_mpc_controller.get_optimal_cost_value()
            u_error = u_s.flatten() - u_sys[k, :].flatten()
            y_error = y_s.flatten() - y_sys[k, :].flatten()
            fu = ", ".join(
                f"u_{i + 1}e = {e:>6.3f}" for i, e in enumerate(u_error)
            )
            fy = ", ".join(
                f"y_{i + 1}e = {e:>6.3f}" for i, e in enumerate(y_error)
            )
            print(
                f"    Time step: {t:>4} - MPC cost value: "
                f"{mpc_cost_val:>8.4f} - Error: {fu}, {fy}"
            )

    return u_sys, y_sys

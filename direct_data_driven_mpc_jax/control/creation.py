"""Controller factory from a configuration dictionary.

Capability parity with
``utilities/controller/controller_creation.py:192-275`` (the YAML ->
params mapping itself lives in ``utils/config.py``).
"""

from __future__ import annotations

import numpy as np

from direct_data_driven_mpc_jax.control.controller import (
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_jax.utils.config import (
    DataDrivenMPCParamsDictType,
)


def create_data_driven_mpc_controller(
    controller_config: DataDrivenMPCParamsDictType,
    u_d: np.ndarray,
    y_d: np.ndarray,
    use_terminal_constraint: bool = True,
    allow_nonconvex_slack: bool = False,
) -> DirectDataDrivenMPCController:
    """Create a controller from a config dict + initial I/O data.

    ``m``/``p`` are inferred from the data column counts (reference
    semantics, controller_creation.py:223-224).

    ``allow_nonconvex_slack=True`` opts into actually SOLVING the
    NON_CONVEX slack variant (paper Eq. 6d; qp/nonconvex.py) instead of
    the reference-parity ``NotImplementedError``.
    """
    m = u_d.shape[1]
    p = y_d.shape[1]
    return DirectDataDrivenMPCController(
        n=controller_config["n"],
        m=m,
        p=p,
        u_d=u_d,
        y_d=y_d,
        L=controller_config["L"],
        Q=controller_config["Q"],
        R=controller_config["R"],
        u_s=controller_config["u_s"],
        y_s=controller_config["y_s"],
        eps_max=controller_config["eps_max"],
        lamb_alpha=controller_config["lamb_alpha"],
        lamb_sigma=controller_config["lamb_sigma"],
        c=controller_config["c"],
        slack_var_constraint_type=controller_config[
            "slack_var_constraint_type"
        ],
        controller_type=controller_config["controller_type"],
        n_mpc_step=controller_config["n_mpc_step"],
        use_terminal_constraint=use_terminal_constraint,
        allow_nonconvex_slack=allow_nonconvex_slack,
    )

"""YAML configuration loading and controller-parameter derivation.

Accepts the reference's YAML schemas verbatim (compatibility
requirement): the controller schema keys at
``examples/config/controllers/data_driven_mpc_example_params.yaml`` and
plant schemas like ``examples/config/models/four_tank_system_params.yaml``.
The derived-parameter rules replicate
``utilities/controller/controller_creation.py:50-190`` exactly,
including the hardcoded fallbacks:

- ``lamb_alpha = lambda_alpha_epsilon_bar / eps_max`` or ``1000.0``
  when ``eps_max == 0`` (ref :131-136)
- ``c = 1.0`` (ref :142)
- ``n_mpc_step`` defaults to ``n`` (Algorithm 2 default, ref :156-160)
- int -> enum maps with silent fallbacks (slack -> NONE,
  controller -> ROBUST, ref :145-154)
- setpoints reshaped to column vectors (ref :166-168)
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple, TypedDict

import numpy as np

from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

# Int -> enum mappings used by the YAML schema (ref :12-23).
DataDrivenMPCTypesMap = {
    0: DataDrivenMPCType.NOMINAL,
    1: DataDrivenMPCType.ROBUST,
}
SlackVarConstraintTypesMap = {
    0: SlackVarConstraintTypes.NONE,
    1: SlackVarConstraintTypes.CONVEX,
    2: SlackVarConstraintTypes.NON_CONVEX,
}

# Required keys in a controller configuration file (ref :45-48).
DD_MPC_FILE_PARAMS = [
    "N",
    "u_d_range",
    "epsilon_bar",
    "L",
    "Q_scalar",
    "R_scalar",
    "lambda_sigma",
    "lambda_alpha_epsilon_bar",
    "slack_var_constraint_type",
    "controller_type",
    "n",
    "u_s",
    "y_s",
]


class DataDrivenMPCParamsDictType(TypedDict, total=False):
    """Controller-parameter dictionary (ref :26-41)."""

    u_range: Tuple[float, float]
    N: int
    n: int
    eps_max: float
    L: int
    Q: np.ndarray
    R: np.ndarray
    lamb_alpha: float
    lamb_sigma: float
    c: float
    slack_var_constraint_type: SlackVarConstraintTypes
    controller_type: DataDrivenMPCType
    n_mpc_step: int
    u_s: np.ndarray
    y_s: np.ndarray


def load_yaml_config_params(config_file: str, key: str) -> Any:
    """Load the parameters under ``key`` from a YAML config file.

    Reference semantics: ``utilities/yaml_config_loading.py:6-37``.

    Raises:
        FileNotFoundError: if the file does not exist.
        ValueError: if ``key`` is missing.
    """
    if not os.path.exists(config_file):
        raise FileNotFoundError(
            f"Configuration file {config_file} not found."
        )
    # Imported here: only YAML loading needs PyYAML, not the engines.
    import yaml

    with open(config_file, "r") as f:
        config = yaml.safe_load(f)
    if key not in config:
        raise ValueError(f"Missing `{key}` value in the configuration file.")
    return config[key]


def get_data_driven_mpc_controller_params(
    config_file: str,
    controller_key_value: str,
    m: int,
    p: int,
    verbose: int = 0,
) -> DataDrivenMPCParamsDictType:
    """Load + derive controller parameters from a YAML config file.

    ``m``/``p`` size the stacked-horizon weighting matrices
    ``Q = Q_scalar * I(pL)`` and ``R = R_scalar * I(mL)`` (ref
    :125-127).
    """
    params = load_yaml_config_params(config_file, controller_key_value)
    if verbose > 1:
        print(
            f"    Data-Driven MPC controller parameters loaded from "
            f"{config_file} with key '{controller_key_value}'"
        )

    for key in DD_MPC_FILE_PARAMS:
        if key not in params:
            raise ValueError(
                f"Missing required parameter key '{key}' in the "
                "configuration file."
            )

    dd: Dict[str, Any] = {}
    dd["u_range"] = params["u_d_range"]
    dd["N"] = params["N"]
    n = params["n"]
    dd["n"] = n
    eps_max = params["epsilon_bar"]
    dd["eps_max"] = eps_max
    L = params["L"]
    dd["L"] = L
    dd["Q"] = params["Q_scalar"] * np.eye(p * L)
    dd["R"] = params["R_scalar"] * np.eye(m * L)

    lambda_alpha_epsilon_bar = params["lambda_alpha_epsilon_bar"]
    if eps_max != 0:
        dd["lamb_alpha"] = lambda_alpha_epsilon_bar / eps_max
    else:
        dd["lamb_alpha"] = 1000.0  # noise-free fallback (ref :134-136)

    dd["lamb_sigma"] = params["lambda_sigma"]
    dd["c"] = 1.0  # Remark 3 constant (ref :142)

    dd["slack_var_constraint_type"] = SlackVarConstraintTypesMap.get(
        params["slack_var_constraint_type"], SlackVarConstraintTypes.NONE
    )
    dd["controller_type"] = DataDrivenMPCTypesMap.get(
        params["controller_type"], DataDrivenMPCType.ROBUST
    )

    # Algorithm 2 default: apply n inputs per solve (ref :156-160).
    dd["n_mpc_step"] = n

    dd["u_s"] = np.array(params["u_s"], dtype=float).reshape(-1, 1)
    dd["y_s"] = np.array(params["y_s"], dtype=float).reshape(-1, 1)

    if verbose == 1:
        print("Data-Driven MPC controller initialized with loaded parameters")
    if verbose > 1:
        print("Data-Driven MPC controller initialized with:")
        for key, value in dd.items():
            if key in ("Q", "R"):
                print(f"    {key}: scalar {value[0, 0]} {value.shape}")
            elif key in ("controller_type", "slack_var_constraint_type"):
                print(f"    {key}: {value.name}")
            elif key in ("u_s", "y_s"):
                formatted = ", ".join(f"[{row[0]}]" for row in value)
                print(f"    {key}: [{formatted}]")
            else:
                print(f"    {key}: {value}")

    return dd  # type: ignore[return-value]

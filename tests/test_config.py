"""Unit tests for YAML loading and the derived-parameter rules
(reference: controller_creation.py:105-168)."""

import numpy as np
import pytest
import yaml

from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)
from direct_data_driven_mpc_jax.utils.config import (
    get_data_driven_mpc_controller_params,
    load_yaml_config_params,
)

BASE = {
    "N": 100,
    "u_d_range": [-1, 1],
    "epsilon_bar": 0.002,
    "L": 10,
    "Q_scalar": 3,
    "R_scalar": 0.0001,
    "lambda_sigma": 1000,
    "lambda_alpha_epsilon_bar": 0.1,
    "slack_var_constraint_type": 0,
    "controller_type": 1,
    "n": 2,
    "u_s": [1, 1],
    "y_s": [0.65, 0.77],
}


def _write(tmp_path, params, key="params"):
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump({key: params}))
    return str(path)


def test_loader_missing_file_and_key(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_yaml_config_params(str(tmp_path / "nope.yaml"), "k")
    path = _write(tmp_path, BASE)
    with pytest.raises(ValueError, match="Missing `other`"):
        load_yaml_config_params(path, "other")


def test_derived_parameter_rules(tmp_path):
    path = _write(tmp_path, BASE)
    dd = get_data_driven_mpc_controller_params(path, "params", m=2, p=2)
    # lamb_alpha = lambda_alpha_epsilon_bar / eps_max (ref :131-136)
    assert dd["lamb_alpha"] == pytest.approx(0.1 / 0.002)
    assert dd["c"] == 1.0  # hardcoded (ref :142)
    assert dd["n_mpc_step"] == 2  # defaults to n (ref :156-160)
    assert dd["Q"].shape == (2 * 10, 2 * 10) and dd["Q"][0, 0] == 3
    assert dd["R"][0, 0] == pytest.approx(1e-4)
    assert dd["u_s"].shape == (2, 1)  # column vectors (ref :166-168)
    assert dd["controller_type"] == DataDrivenMPCType.ROBUST
    assert (
        dd["slack_var_constraint_type"] == SlackVarConstraintTypes.NONE
    )


def test_noise_free_lamb_alpha_fallback(tmp_path):
    params = dict(BASE, epsilon_bar=0)
    path = _write(tmp_path, params)
    dd = get_data_driven_mpc_controller_params(path, "params", m=2, p=2)
    assert dd["lamb_alpha"] == 1000.0  # ref :134-136


def test_silent_enum_fallbacks(tmp_path):
    # Unknown ints fall back silently: slack -> NONE, controller ->
    # ROBUST (ref :145-154).
    params = dict(BASE, slack_var_constraint_type=99, controller_type=99)
    path = _write(tmp_path, params)
    dd = get_data_driven_mpc_controller_params(path, "params", m=2, p=2)
    assert dd["slack_var_constraint_type"] == SlackVarConstraintTypes.NONE
    assert dd["controller_type"] == DataDrivenMPCType.ROBUST


def test_missing_required_key_raises(tmp_path):
    params = dict(BASE)
    del params["lambda_sigma"]
    path = _write(tmp_path, params)
    with pytest.raises(ValueError, match="lambda_sigma"):
        get_data_driven_mpc_controller_params(path, "params", m=2, p=2)

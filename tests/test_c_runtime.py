"""Standalone C deployment runtime parity (native/ddmpc_runtime.c).

Exports a designed controller + plant to the binary blob
(utils/export.py), runs the FULL closed loop in the pure-C demo binary
(no Python in the loop), and asserts trajectory agreement with the
Python controller class on the identical noise sequence — the
deployment path must be exactly the controller it was designed as.
"""

import os
import subprocess

import numpy as np
import pytest

from direct_data_driven_mpc_jax import native
from direct_data_driven_mpc_jax.control.controller import (
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_jax.control.operation import (
    simulate_data_driven_mpc_control_loop,
)
from direct_data_driven_mpc_jax.models.lti_model import LTIModel
from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)
from direct_data_driven_mpc_jax.utils.export import export_controller

pytestmark = pytest.mark.skipif(
    native.build_runtime_demo() is None,
    reason="no C compiler available",
)


def _four_tank():
    return LTIModel(
        A=np.array(
            [
                [0.921, 0, 0.041, 0],
                [0, 0.918, 0, 0.033],
                [0, 0, 0.924, 0],
                [0, 0, 0, 0.937],
            ]
        ),
        B=np.array(
            [[0.017, 0.001], [0.001, 0.023], [0, 0.061], [0.072, 0]]
        ),
        C=np.array([[1.0, 0, 0, 0], [0, 1, 0, 0]]),
        D=np.zeros((2, 2)),
        eps_max=0.002,
    )


def _controller(plant, slack, n_mpc_step=1, seed=0):
    n, m, p, N, L = 4, 2, 2, 120, 10
    rng = np.random.default_rng(seed)
    u_d = rng.uniform(-1, 1, (N, m))
    w_d = 0.002 * rng.uniform(-1, 1, (N, p))
    y_d = plant.simulate(u_d, w_d, N)
    return DirectDataDrivenMPCController(
        n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(p * L), R=1e-4 * np.eye(m * L),
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
        eps_max=0.002, lamb_alpha=0.1 / 0.002, lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=slack,
        controller_type=DataDrivenMPCType.ROBUST,
        n_mpc_step=n_mpc_step,
    )


@pytest.mark.parametrize(
    "slack,n_mpc_step",
    [
        (SlackVarConstraintTypes.NONE, 1),
        (SlackVarConstraintTypes.NONE, 4),
        (SlackVarConstraintTypes.CONVEX, 1),
    ],
)
def test_c_runtime_closed_loop_matches_python(tmp_path, slack, n_mpc_step):
    T = 40
    plant = _four_tank()
    plant.set_state(np.zeros(4))
    ctrl = _controller(plant, slack, n_mpc_step=n_mpc_step)
    x0 = plant.get_state().copy()

    blob = os.path.join(tmp_path, "ctrl.blob")
    export_controller(ctrl, blob, plant=plant, x0=x0)

    rng = np.random.default_rng(7)
    w_sys = 0.002 * rng.uniform(-1.0, 1.0, (T, 2))
    noise_path = os.path.join(tmp_path, "noise.f64")
    np.ascontiguousarray(w_sys, dtype="<f8").tofile(noise_path)

    out_path = os.path.join(tmp_path, "out.f64")
    demo = native.build_runtime_demo()
    proc = subprocess.run(
        [demo, blob, noise_path, str(T), out_path],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    raw = np.fromfile(out_path, dtype="<f8")
    assert raw.size == T * 2 + T * 2 + T
    u_c = raw[: T * 2].reshape(T, 2)
    y_c = raw[T * 2 : T * 4].reshape(T, 2)
    costs_c = raw[T * 4 :]

    # Python reference loop on the identical noise, from the same
    # plant state and controller window.
    plant.set_state(x0)
    u_py, y_py = simulate_data_driven_mpc_control_loop(
        plant, ctrl, n_steps=T,
        np_random=np.random.default_rng(0), verbose=0, w_sys=w_sys,
    )

    atol = 1e-10 if slack == SlackVarConstraintTypes.NONE else 1e-7
    np.testing.assert_allclose(u_c, u_py, atol=atol)
    np.testing.assert_allclose(y_c, y_py, atol=atol)
    assert np.isfinite(costs_c).all()
    # Cost of the final solve matches the Python controller's.
    assert costs_c[-1] == pytest.approx(
        ctrl.get_optimal_cost_value(), abs=1e-6
    )


def test_c_runtime_rejects_bad_blob(tmp_path):
    demo = native.build_runtime_demo()
    bad = os.path.join(tmp_path, "bad.blob")
    with open(bad, "wb") as f:
        f.write(b"NOTDDMPC" + b"\x00" * 64)
    noise = os.path.join(tmp_path, "noise.f64")
    np.zeros(4).tofile(noise)
    proc = subprocess.run(
        [demo, bad, noise, "2", os.path.join(tmp_path, "o.f64")],
        capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode != 0
    assert "bad header" in proc.stderr


def test_c_runtime_truncated_blob(tmp_path):
    plant = _four_tank()
    ctrl = _controller(plant, SlackVarConstraintTypes.NONE)
    blob = os.path.join(tmp_path, "ctrl.blob")
    export_controller(ctrl, blob, plant=plant)
    data = open(blob, "rb").read()
    trunc = os.path.join(tmp_path, "trunc.blob")
    with open(trunc, "wb") as f:
        f.write(data[: len(data) // 2])
    noise = os.path.join(tmp_path, "noise.f64")
    np.zeros(8).tofile(noise)
    demo = native.build_runtime_demo()
    proc = subprocess.run(
        [demo, trunc, noise, "2", os.path.join(tmp_path, "o.f64")],
        capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode != 0
    assert "truncated" in proc.stderr

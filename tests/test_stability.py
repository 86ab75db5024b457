"""Closed-loop stability certificates from the condensed transition
matrix: the paper's empirical observations become decidable facts."""

import numpy as np
import pytest

import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.linear_engine import (
    build_affine_block_map,
    closed_loop_spectrum,
    linear_closed_loop_rollout,
)

from tests.test_closed_loop import _make_setup


def _spectrum(use_terminal, n_mpc_step=1, seed=0):
    plant, ctrl, rng = _make_setup(
        seed=seed, n_mpc_step=n_mpc_step, use_terminal=use_terminal
    )
    bm = build_affine_block_map(
        plant.as_params(), ctrl._op, n=4, m=2, p=2,
        n_mpc_step=n_mpc_step, dtype=jnp.float64,
    )
    return closed_loop_spectrum(bm), bm, plant, ctrl, rng


def test_tec_scheme_certified_stable():
    spec, *_ = _spectrum(use_terminal=True)
    assert spec["stable"], spec["spectral_radius"]
    assert spec["spectral_radius"] < 1.0


def test_tec_nstep_certified_stable():
    spec, *_ = _spectrum(use_terminal=True, n_mpc_step=4)
    assert spec["stable"], spec["spectral_radius"]


def test_ucon_scheme_certified_unstable():
    # The reference README warns UCON "is unstable and diverges" for
    # most seeds (robust_data_driven_mpc_reproduction.py:21-28) -- an
    # empirical observation there; a spectral certificate here.
    spec, bm, plant, ctrl, rng = _spectrum(use_terminal=False)
    assert not spec["stable"], spec["spectral_radius"]
    assert spec["spectral_radius"] > 1.0

    # And the certificate predicts reality: a long rollout diverges.
    W = 0.002 * rng.uniform(-1, 1, (400, 2))
    res = linear_closed_loop_rollout(
        bm,
        plant.get_state(),
        ctrl.u_past.reshape(4, 2),
        ctrl.y_past.reshape(4, 2),
        W=W,
        n_steps=400,
    )
    y_err_early = np.abs(
        np.asarray(res.y_sys[:50]) - [0.65, 0.77]
    ).max()
    y_err_late = np.abs(
        np.asarray(res.y_sys[-50:]) - [0.65, 0.77]
    ).max()
    assert y_err_late > 10 * y_err_early

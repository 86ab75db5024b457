"""Fused condensed rollout (ops/fused_rollout.py, the bench headline
engine) vs the condensed linear engine."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.linear_engine import (
    build_affine_block_map,
    make_linear_batched_rollout,
)
from direct_data_driven_mpc_jax.ops.fused_rollout import (
    fused_batched_rollout,
)

from tests.test_closed_loop import _make_setup


@pytest.mark.parametrize("n_steps,K", [(40, 8), (37, 8)])
def test_pallas_kernel_matches_linear_engine(n_steps, K):
    plant, ctrl, rng = _make_setup(n_mpc_step=1)
    bm = build_affine_block_map(
        plant.as_params(), ctrl._op, n=4, m=2, p=2,
        solves_per_block=K, dtype=jnp.float32,
    )
    B = 16
    x0s = jnp.tile(
        jnp.asarray(plant.get_state(), jnp.float32)[None], (B, 1)
    )
    ups = jnp.tile(
        jnp.asarray(ctrl.u_past.reshape(4, 2), jnp.float32)[None],
        (B, 1, 1),
    )
    yps = jnp.tile(
        jnp.asarray(ctrl.y_past.reshape(4, 2), jnp.float32)[None],
        (B, 1, 1),
    )
    Ws = jnp.asarray(
        0.002 * rng.uniform(-1, 1, (B, n_steps, 2)), jnp.float32
    )

    ref_run = make_linear_batched_rollout(bm, n_steps=n_steps)
    ref = ref_run(x0s, ups, yps, Ws)

    res = fused_batched_rollout(bm, x0s, ups, yps, Ws, n_steps=n_steps)
    np.testing.assert_allclose(
        np.asarray(res.u_sys), np.asarray(ref.u_sys), atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(res.y_sys), np.asarray(ref.y_sys), atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(res.costs), np.asarray(ref.costs), rtol=1e-3,
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(res.u_past), np.asarray(ref.u_past), atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(res.x_final), np.asarray(ref.x_final), atol=2e-5
    )


def test_cost_precision_split_path_matches_fused():
    """The mixed-precision cost channel (parity-bound columns at
    HIGHEST, cost-feature columns via the explicit bf16_3x
    decomposition, ops/fused_rollout.py) must leave u/y/state
    BIT-IDENTICAL (same HIGHEST dot over the same columns) and keep
    costs within the bf16_3x error bound. Locks the offset arithmetic
    and the hi/lo operand decomposition of the split path."""
    plant, ctrl, rng = _make_setup(n_mpc_step=1)
    bm = build_affine_block_map(
        plant.as_params(), ctrl._op, n=4, m=2, p=2,
        solves_per_block=8, dtype=jnp.float32,
    )
    B, n_steps = 16, 40
    x0s = jnp.tile(
        jnp.asarray(plant.get_state(), jnp.float32)[None], (B, 1)
    )
    ups = jnp.tile(
        jnp.asarray(ctrl.u_past.reshape(4, 2), jnp.float32)[None],
        (B, 1, 1),
    )
    yps = jnp.tile(
        jnp.asarray(ctrl.y_past.reshape(4, 2), jnp.float32)[None],
        (B, 1, 1),
    )
    Ws = jnp.asarray(
        0.002 * rng.uniform(-1, 1, (B, n_steps, 2)), jnp.float32
    )
    fused = fused_batched_rollout(
        bm, x0s, ups, yps, Ws, n_steps=n_steps, cost_precision="highest",
    )
    split = fused_batched_rollout(
        bm, x0s, ups, yps, Ws, n_steps=n_steps, cost_precision="high",
    )
    for field in ("u_sys", "y_sys", "x_final"):
        np.testing.assert_array_equal(
            np.asarray(getattr(split, field)),
            np.asarray(getattr(fused, field)),
            err_msg=field,
        )
    np.testing.assert_allclose(
        np.asarray(split.costs), np.asarray(fused.costs),
        rtol=1e-3, atol=1e-5,
    )
    with pytest.raises(ValueError, match="cost_precision"):
        fused_batched_rollout(
            bm, x0s, ups, yps, Ws, n_steps=n_steps,
            cost_precision="bfloat16",
        )


def test_cost_mode_post_matches_inkernel():
    """cost_mode="post" (cost channel reconstructed from emitted
    trajectories, for large-state configs) must leave u/y untouched
    and reproduce the per-solve costs to diagnostic accuracy, incl.
    n-step cadence and trailing trim."""

    for n_mpc_step, n_steps in ((1, 48), (4, 42)):
        plant, ctrl, rng = _make_setup(n_mpc_step=n_mpc_step)
        bm = build_affine_block_map(
            plant.as_params(dtype=np.float32), ctrl._op, n=4, m=2, p=2,
            n_mpc_step=n_mpc_step, solves_per_block=4,
            dtype=jnp.float32,
        )
        B = 4
        x0s = jnp.tile(
            jnp.asarray(plant.get_state(), jnp.float32)[None], (B, 1)
        )
        ups = jnp.tile(
            jnp.asarray(ctrl.u_past.reshape(4, 2), jnp.float32)[None],
            (B, 1, 1),
        )
        yps = jnp.tile(
            jnp.asarray(ctrl.y_past.reshape(4, 2), jnp.float32)[None],
            (B, 1, 1),
        )
        Ws = jnp.asarray(
            0.002 * rng.uniform(-1, 1, (B, n_steps, 2)), jnp.float32
        )
        ref = fused_batched_rollout(
            bm, x0s, ups, yps, Ws, n_steps=n_steps,
            n_mpc_step=n_mpc_step,
        )
        post = fused_batched_rollout(
            bm, x0s, ups, yps, Ws, n_steps=n_steps,
            n_mpc_step=n_mpc_step, cost_mode="post",
        )
        np.testing.assert_array_equal(
            np.asarray(post.u_sys), np.asarray(ref.u_sys)
        )
        np.testing.assert_array_equal(
            np.asarray(post.y_sys), np.asarray(ref.y_sys)
        )
        assert post.costs.shape == ref.costs.shape
        np.testing.assert_allclose(
            np.asarray(post.costs), np.asarray(ref.costs), rtol=1e-3,
            atol=1e-3,
        )
        # The post-pass is a pure function of the emitted trajectories:
        # the same call again reproduces it bit for bit.
        again = fused_batched_rollout(
            bm, x0s, ups, yps, Ws, n_steps=n_steps,
            n_mpc_step=n_mpc_step, cost_mode="post",
        )
        np.testing.assert_array_equal(
            np.asarray(again.costs), np.asarray(post.costs)
        )


def test_cost_mode_post_rejects_tracking_maps():
    from direct_data_driven_mpc_jax.control.linear_engine import (
        build_tracking_engine,
    )
    from direct_data_driven_mpc_jax.ops.fused_rollout import (
        make_fused_batched_rollout,
    )

    plant, ctrl, rng = _make_setup(n_mpc_step=1)
    bm_t = build_tracking_engine(
        ctrl, plant.as_params(dtype=np.float32), solves_per_block=4,
        dtype=jnp.float32,
    )
    with pytest.raises(NotImplementedError, match="post"):
        make_fused_batched_rollout(
            bm_t, n_steps=16, cost_mode="post"
        )


def test_cost_rank_truncation_bounds():
    """cost_rank_rtol truncates only the cost DIAGNOSTIC channel:
    u/y stay bit-identical, and the cost error is bounded by the
    dropped eigenvalue mass (here: aggressive rtol to force real
    truncation; 1e-6 default drops nothing on this config)."""
    import numpy as np

    from direct_data_driven_mpc_jax.ops.fused_rollout import (
        make_fused_batched_rollout,
    )

    plant, ctrl, rng = _make_setup(n_mpc_step=1)
    bm = build_affine_block_map(
        plant.as_params(dtype=np.float32), ctrl._op, n=4, m=2, p=2,
        solves_per_block=4, dtype=jnp.float32,
    )
    evals = np.linalg.eigvalsh(np.asarray(bm.cost_P, np.float64))
    rtol = float(evals[len(evals) // 2] / evals[-1]) * 1.01  # drop half
    B, T = 2, 24
    x0s = jnp.tile(
        jnp.asarray(plant.get_state(), jnp.float32)[None], (B, 1)
    )
    ups = jnp.tile(
        jnp.asarray(ctrl.u_past.reshape(4, 2), jnp.float32)[None],
        (B, 1, 1),
    )
    yps = jnp.tile(
        jnp.asarray(ctrl.y_past.reshape(4, 2), jnp.float32)[None],
        (B, 1, 1),
    )
    Ws = jnp.asarray(0.002 * rng.uniform(-1, 1, (B, T, 2)), jnp.float32)
    full = make_fused_batched_rollout(bm, T)(
        x0s, ups, yps, Ws
    )
    trunc = make_fused_batched_rollout(
        bm, T, cost_rank_rtol=rtol
    )(x0s, ups, yps, Ws)
    np.testing.assert_array_equal(
        np.asarray(trunc.u_sys), np.asarray(full.u_sys)
    )
    np.testing.assert_array_equal(
        np.asarray(trunc.y_sys), np.asarray(full.y_sys)
    )
    # Truncation drops PSD mass, so truncated costs UNDER-estimate,
    # by at most (sum of dropped eigenvalues) * max ||theta||^2.
    c_full = np.asarray(full.costs, np.float64)
    c_tr = np.asarray(trunc.costs, np.float64)
    assert np.all(c_tr <= c_full + 1e-3)
    dropped = evals[evals <= rtol * evals[-1]].sum()
    th_max = 16 * max(
        np.abs(np.asarray(full.u_sys)).max(),
        np.abs(np.asarray(full.y_sys)).max(),
        1.0,
    ) ** 2
    assert np.abs(c_tr - c_full).max() <= dropped * th_max


def test_amortized_run_rolls_noise_per_rep():
    """Repetition i of the amortized harness runs the rollout on the
    packed noise rolled by i outer blocks: the checksum of R reps
    equals the sum of R single rollouts on explicitly rolled noise."""
    from direct_data_driven_mpc_jax.ops.fused_rollout import (
        make_amortized_fused_run,
    )

    plant, ctrl, rng = _make_setup(n_mpc_step=1)
    K, n_steps, B = 8, 40, 4
    bm = build_affine_block_map(
        plant.as_params(), ctrl._op, n=4, m=2, p=2,
        solves_per_block=K, dtype=jnp.float32,
    )
    x0s = jnp.tile(
        jnp.asarray(plant.get_state(), jnp.float32)[None], (B, 1)
    )
    ups = jnp.tile(
        jnp.asarray(ctrl.u_past.reshape(4, 2), jnp.float32)[None],
        (B, 1, 1),
    )
    yps = jnp.tile(
        jnp.asarray(ctrl.y_past.reshape(4, 2), jnp.float32)[None],
        (B, 1, 1),
    )
    Ws = jnp.asarray(
        0.002 * rng.uniform(-1, 1, (B, n_steps, 2)), jnp.float32
    )
    run = make_amortized_fused_run(bm, n_steps=n_steps)
    cs3, ok = run(x0s, ups, yps, Ws, 3)
    assert bool(ok)
    expect = 0.0
    for i in range(3):
        # Rolling the packed noise by i outer blocks == rolling the
        # time axis by i * K steps.
        res = fused_batched_rollout(
            bm, x0s, ups, yps, jnp.roll(Ws, i * K, axis=1),
            n_steps=n_steps,
        )
        # The harness sums the CENTERED final state (s - s_star).
        s_fin = jnp.concatenate(
            [res.x_final, res.u_past.reshape(B, -1),
             res.y_past.reshape(B, -1)], axis=1,
        ) - bm.s_star[None]
        expect += float(
            jnp.sum(res.costs[:, -K:]) + jnp.sum(s_fin)
            + jnp.sum(res.u_sys) + jnp.sum(res.y_sys)
        )
    np.testing.assert_allclose(float(cs3), expect, rtol=1e-5)

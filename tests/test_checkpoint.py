"""Checkpoint/resume determinism: interrupted == uninterrupted,
bit-for-bit."""

import numpy as np

import jax
import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.segmented import (
    SegmentState,
    resume_from_checkpoint,
    run_segmented,
)
from direct_data_driven_mpc_jax.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)

from tests.test_closed_loop import _make_setup


def _initial_state(plant, ctrl, B, key):
    x = jnp.tile(jnp.asarray(plant.get_state())[None], (B, 1))
    up = jnp.tile(jnp.asarray(ctrl.u_past.reshape(4, 2))[None], (B, 1, 1))
    yp = jnp.tile(jnp.asarray(ctrl.y_past.reshape(4, 2))[None], (B, 1, 1))
    return SegmentState(x=x, u_past=up, y_past=yp, segment=0, key=key)


def test_resume_is_bit_identical(tmp_path):
    plant, ctrl, _ = _make_setup(n_mpc_step=1)
    params = plant.as_params()
    sol = ctrl.solution_map(dtype=jnp.float64)
    B = 2
    key = jax.random.key(42)
    ckpt = str(tmp_path / "state.npz")

    # Uninterrupted: 4 segments of 10 steps.
    s0 = _initial_state(plant, ctrl, B, key)
    _, full = run_segmented(
        params, sol, s0, eps_max=0.002, segment_steps=10, n_segments=4,
        dtype=jnp.float64,
    )

    # Interrupted: 2 segments, checkpoint, "crash", resume, 2 more.
    s0 = _initial_state(plant, ctrl, B, key)
    mid, part1 = run_segmented(
        params, sol, s0, eps_max=0.002, segment_steps=10, n_segments=2,
        checkpoint_path=ckpt, dtype=jnp.float64,
    )
    template = _initial_state(plant, ctrl, B, key)
    restored = resume_from_checkpoint(ckpt, template)
    assert restored.segment == 2
    _, part2 = run_segmented(
        params, sol, restored, eps_max=0.002, segment_steps=10,
        n_segments=2, dtype=jnp.float64,
    )

    resumed_u = np.concatenate([part1.u_sys, part2.u_sys], axis=1)
    resumed_y = np.concatenate([part1.y_sys, part2.y_sys], axis=1)
    np.testing.assert_array_equal(resumed_u, np.asarray(full.u_sys))
    np.testing.assert_array_equal(resumed_y, np.asarray(full.y_sys))


def test_same_key_bit_identical_rollout():
    plant, ctrl, _ = _make_setup(n_mpc_step=1)
    params = plant.as_params()
    sol = ctrl.solution_map(dtype=jnp.float64)
    key = jax.random.key(7)
    B = 2
    s1 = _initial_state(plant, ctrl, B, key)
    s2 = _initial_state(plant, ctrl, B, key)
    _, r1 = run_segmented(
        params, sol, s1, 0.002, segment_steps=15, n_segments=1,
        dtype=jnp.float64,
    )
    _, r2 = run_segmented(
        params, sol, s2, 0.002, segment_steps=15, n_segments=1,
        dtype=jnp.float64,
    )
    np.testing.assert_array_equal(r1.u_sys, r2.u_sys)

    # Different key -> different noise -> different outputs.
    s3 = _initial_state(plant, ctrl, B, jax.random.key(8))
    _, r3 = run_segmented(
        params, sol, s3, 0.002, segment_steps=15, n_segments=1,
        dtype=jnp.float64,
    )
    assert not np.array_equal(r1.y_sys, r3.y_sys)


def test_admm_segmented_matches_unsegmented(tmp_path):
    """CONVEX-slack (ADMM) runs must not cold-start at segment
    boundaries: the warm-start state is carried through SegmentState
    (and checkpoints), so segmented == uninterrupted bit-for-bit."""
    from direct_data_driven_mpc_jax.parallel.batch import (
        batched_closed_loop,
        draw_noise_batch,
    )
    from direct_data_driven_mpc_jax.qp.spec import (
        SlackVarConstraintTypes,
    )

    plant, ctrl, _ = _make_setup(
        slack=SlackVarConstraintTypes.CONVEX, n_mpc_step=1
    )
    params = plant.as_params()
    solver = ctrl.admm_solver(dtype=jnp.float64)
    B = 2
    key = jax.random.key(3)
    s0 = _initial_state(plant, ctrl, B, key)

    # Uninterrupted 30 steps, noise drawn the segmented way (3 folds of
    # 10) so the two runs see identical noise.
    W = jnp.concatenate(
        [
            draw_noise_batch(
                jax.random.fold_in(key, i), B, 10, 2, 0.002,
                dtype=jnp.float64,
            )
            for i in range(3)
        ],
        axis=1,
    )
    full = batched_closed_loop(
        params, solver, s0.x, s0.u_past, s0.y_past, W,
        n_steps=30, admm_iters=30,
    )
    assert full.solver_state is not None

    # Segmented: 1 segment + checkpoint + resume + 2 segments.
    ckpt = str(tmp_path / "admm.npz")
    mid, part1 = run_segmented(
        params, solver, s0, eps_max=0.002, segment_steps=10,
        n_segments=1, admm_iters=30, checkpoint_path=ckpt,
        dtype=jnp.float64,
    )
    assert mid.solver_state is not None
    template = SegmentState(
        x=s0.x, u_past=s0.u_past, y_past=s0.y_past, segment=0, key=key,
        solver_state=jax.tree.map(jnp.zeros_like, mid.solver_state),
    )
    restored = resume_from_checkpoint(ckpt, template)
    _, part2 = run_segmented(
        params, solver, restored, eps_max=0.002, segment_steps=10,
        n_segments=2, admm_iters=30, dtype=jnp.float64,
    )
    resumed_u = np.concatenate([part1.u_sys, part2.u_sys], axis=1)
    resumed_y = np.concatenate([part1.y_sys, part2.y_sys], axis=1)
    np.testing.assert_array_equal(resumed_u, np.asarray(full.u_sys))
    np.testing.assert_array_equal(resumed_y, np.asarray(full.y_sys))


def test_checkpoint_shape_validation(tmp_path):
    state = {"a": np.zeros((3, 2)), "b": np.ones(4)}
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, state, metadata={"note": "x"})
    loaded, meta = load_checkpoint(path, state)
    np.testing.assert_array_equal(loaded["a"], state["a"])
    assert meta["note"] == "x"

    bad_template = {"a": np.zeros((3, 3)), "b": np.ones(4)}
    import pytest

    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(path, bad_template)


def test_profiler_trace_writes_artifacts(tmp_path):
    """jax.profiler tracing hook produces an XPlane artifact."""
    import jax.numpy as jnp

    from direct_data_driven_mpc_jax.utils.profiling import Timer, trace

    with trace(str(tmp_path)):
        x = jnp.ones((64, 64)) @ jnp.ones((64, 64))
        x.block_until_ready()
    import glob

    files = glob.glob(str(tmp_path / "**" / "*.xplane.pb"), recursive=True)
    assert files, "no trace artifact written"

    t = Timer()
    out = t.timeit(lambda: jnp.ones(4) + 1, iters=3, warmup=1)
    assert out.shape == (4,)
    s = t.summary()
    assert s["n"] == 3 and s["p50_s"] >= 0


def test_resume_then_checkpoint_again(tmp_path):
    """Regression: a loaded segment index (numpy scalar) must be
    JSON-serializable when the resumed run writes its own checkpoints."""
    plant, ctrl, _ = _make_setup(n_mpc_step=1)
    params = plant.as_params()
    sol = ctrl.solution_map(dtype=jnp.float64)
    key = jax.random.key(11)
    ckpt = str(tmp_path / "state.npz")
    s0 = _initial_state(plant, ctrl, 2, key)
    mid, _ = run_segmented(
        params, sol, s0, 0.002, segment_steps=5, n_segments=1,
        checkpoint_path=ckpt, dtype=jnp.float64,
    )
    restored = resume_from_checkpoint(ckpt, _initial_state(plant, ctrl, 2, key))
    # This second checkpointing run previously crashed with
    # "Object of type int64 is not JSON serializable".
    final, _ = run_segmented(
        params, sol, restored, 0.002, segment_steps=5, n_segments=1,
        checkpoint_path=ckpt, dtype=jnp.float64,
    )
    assert int(np.asarray(final.segment)) == 2


def test_structure_mismatch_rejected(tmp_path):
    """The stored treedef is actually compared against the template."""
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"a": np.zeros(2), "b": np.zeros(2)})
    import pytest

    with pytest.raises(ValueError, match="structure"):
        load_checkpoint(path, {"a": np.zeros(2), "c": np.zeros(2)})

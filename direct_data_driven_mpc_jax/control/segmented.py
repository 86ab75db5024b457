"""Segmented, checkpointable closed-loop execution.

Splits a long rollout into fixed-length segments. Between segments the
full rollout state (plant state, measurement windows, iterative-solver
warm start, segment index, base PRNG key) is a small pytree that can
be checkpointed and resumed
deterministically: segment ``i``'s noise is drawn from
``jax.random.fold_in(base_key, i)``, so a run producing segments
0..k then resuming from a checkpoint at k produces BIT-IDENTICAL
trajectories to an uninterrupted run (asserted in
tests/test_checkpoint.py). This supplies the checkpoint/resume
capability the reference lacks (SURVEY.md section 5).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from direct_data_driven_mpc_jax.control.loop import ClosedLoopResult
from direct_data_driven_mpc_jax.ops.lti import LTIParams
from direct_data_driven_mpc_jax.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)


@dataclasses.dataclass
class SegmentState:
    """Resumable rollout state (a pytree via dataclass fields)."""

    x: jax.Array  # (B, ns) plant states
    u_past: jax.Array  # (B, n, m)
    y_past: jax.Array  # (B, n, p)
    segment: int  # next segment index to run (scalar leaf so it
    # round-trips through checkpoints)
    key: jax.Array  # base PRNG key (never advanced; folded per segment)
    solver_state: object = None  # batched iterative-solver warm start
    # (ADMMState with (B, nbox) leaves for CONVEX-slack solvers; None
    # for exact affine solvers). Carried so segment boundaries do NOT
    # cold-start ADMM: a segmented run is trajectory-identical to an
    # uninterrupted one. When resuming an ADMM run from a checkpoint,
    # the template passed to resume_from_checkpoint must carry a
    # zero-filled ADMMState of the right shape (the pytree structure
    # must match the saved state).


jax.tree_util.register_dataclass(
    SegmentState,
    data_fields=["x", "u_past", "y_past", "segment", "key",
                 "solver_state"],
    meta_fields=[],
)


def run_segmented(
    plant: LTIParams,
    solver,
    state: SegmentState,
    eps_max: float,
    segment_steps: int,
    n_segments: int,
    n_mpc_step: int = 1,
    admm_iters: int = 100,
    checkpoint_path: Optional[str] = None,
    dtype=jnp.float32,
) -> Tuple[SegmentState, ClosedLoopResult]:
    """Run ``n_segments`` segments from ``state``, checkpointing after
    each when ``checkpoint_path`` is given. Returns the advanced state
    and the concatenated results of the segments run here."""
    # Imported lazily: parallel.batch itself imports control.loop,
    # whose package import pulls this module -- a top-level import here
    # closes that cycle (import-order dependent failures).
    from direct_data_driven_mpc_jax.parallel.batch import (
        batched_closed_loop,
        draw_noise_batch,
    )

    if segment_steps % n_mpc_step:
        # The engines advance the plant through padded steps of a
        # trailing partial solve block (outputs are trimmed, but the
        # carried state is post-padding), so resumable segments must
        # align with the solve cadence.
        raise ValueError(
            f"segment_steps={segment_steps} must be a multiple of "
            f"n_mpc_step={n_mpc_step} for exact resume semantics."
        )
    B, _, p = state.y_past.shape
    u_parts: List[np.ndarray] = []
    y_parts: List[np.ndarray] = []
    cost_parts: List[np.ndarray] = []
    conv_parts: List[np.ndarray] = []

    for _ in range(n_segments):
        seg_key = jax.random.fold_in(state.key, state.segment)
        W = draw_noise_batch(
            seg_key, B, segment_steps, p, eps_max, dtype=dtype
        )
        result = batched_closed_loop(
            plant,
            solver,
            state.x,
            state.u_past,
            state.y_past,
            W,
            n_steps=segment_steps,
            n_mpc_step=n_mpc_step,
            admm_iters=admm_iters,
            solver_state0=state.solver_state,
        )
        state = SegmentState(
            x=result.x_final,
            u_past=result.u_past,
            y_past=result.y_past,
            segment=state.segment + 1,
            key=state.key,
            solver_state=result.solver_state,
        )
        u_parts.append(np.asarray(result.u_sys))
        y_parts.append(np.asarray(result.y_sys))
        cost_parts.append(np.asarray(result.costs))
        conv_parts.append(np.asarray(result.converged))
        if checkpoint_path is not None:
            save_checkpoint(
                checkpoint_path,
                state,
                metadata={"segment": state.segment},
            )

    combined = ClosedLoopResult(
        u_sys=np.concatenate(u_parts, axis=1),
        y_sys=np.concatenate(y_parts, axis=1),
        costs=np.concatenate(cost_parts, axis=1),
        converged=np.concatenate(conv_parts, axis=1),
        x_final=state.x,
        u_past=state.u_past,
        y_past=state.y_past,
        solver_state=state.solver_state,
    )
    return state, combined


def resume_from_checkpoint(
    checkpoint_path: str, template: SegmentState
) -> SegmentState:
    """Load a :class:`SegmentState` checkpoint (template supplies the
    pytree structure / shapes)."""
    state, _ = load_checkpoint(checkpoint_path, template)
    return state

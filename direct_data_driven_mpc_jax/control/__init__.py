"""Closed-loop control: fused scan engine + parity controller class."""

from direct_data_driven_mpc_jax.control.controller import (
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_jax.control.loop import (
    ClosedLoopResult,
    build_closed_loop,
    closed_loop_rollout,
)
from direct_data_driven_mpc_jax.control.linear_engine import (
    AffineBlockMap,
    build_affine_block_map,
    build_linear_engine,
    build_tracking_engine,
    closed_loop_spectrum,
    linear_closed_loop_rollout,
    make_linear_batched_rollout,
    time_parallel_rollout,
)
from direct_data_driven_mpc_jax.control.segmented import (
    SegmentState,
    resume_from_checkpoint,
    run_segmented,
)
from direct_data_driven_mpc_jax.control.tuning import (
    differentiable_solution_map,
    make_closed_loop_objective,
    tune_regularization,
)

__all__ = [
    "DirectDataDrivenMPCController",
    "ClosedLoopResult",
    "build_closed_loop",
    "closed_loop_rollout",
    "AffineBlockMap",
    "build_affine_block_map",
    "build_linear_engine",
    "build_tracking_engine",
    "closed_loop_spectrum",
    "linear_closed_loop_rollout",
    "make_linear_batched_rollout",
    "time_parallel_rollout",
    "SegmentState",
    "resume_from_checkpoint",
    "run_segmented",
    "differentiable_solution_map",
    "make_closed_loop_objective",
    "tune_regularization",
]

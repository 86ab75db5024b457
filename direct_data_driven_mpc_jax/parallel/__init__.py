"""Scenario batching (vmap) and device-mesh sharding (shard_map)."""

from direct_data_driven_mpc_jax.parallel.batch import (
    batched_closed_loop,
    draw_noise_batch,
    heterogeneous_closed_loop,
    make_batched_rollout,
    stack_plants,
    stack_solution_maps,
)
from direct_data_driven_mpc_jax.parallel.mesh import (
    make_mesh_rollout,
    make_scenario_mesh,
)

__all__ = [
    "batched_closed_loop",
    "draw_noise_batch",
    "heterogeneous_closed_loop",
    "make_batched_rollout",
    "stack_plants",
    "stack_solution_maps",
    "make_mesh_rollout",
    "make_scenario_mesh",
]

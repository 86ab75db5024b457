"""Multi-host pod scaling (BASELINE config 5: 64k scenarios, N hosts).

Design (see docs/SCALING.md): the scenario axis is embarrassingly
parallel, so scenarios stay HOST-LOCAL -- each host simulates its own
shard with zero hot-loop communication -- and only scalar aggregate
metrics cross hosts, reduced by ``psum``. Determinism is preserved across
any host count: scenario ``i``'s noise key is ``fold_in(base_key, i)``
with ``i`` a GLOBAL index, so re-partitioning the batch over a
different number of hosts reproduces identical per-scenario
trajectories.

The module is exercised on the virtual CPU mesh (tests) and by
``__graft_entry__.dryrun_multichip``; ``initialize_distributed`` is the
standard jax.distributed entry point for a real multi-host launch.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize JAX's multi-host runtime.

    Explicit arguments take precedence (manual launches). With no
    arguments, initializes with auto-detection when the environment
    names a coordinator; otherwise it is a no-op so single-process runs
    and tests are unaffected.
    """
    import os

    if num_processes is not None:
        if num_processes > 1:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
        return
    multiproc_env = any(
        os.environ.get(var)
        for var in (
            "JAX_COORDINATOR_ADDRESS",
            "COORDINATOR_ADDRESS",
        )
    )
    if coordinator_address is not None or multiproc_env:
        jax.distributed.initialize(
            coordinator_address=coordinator_address
        )


def global_scenario_keys(
    base_key: jax.Array, global_batch: int
) -> jax.Array:
    """Per-scenario PRNG keys for THIS process's shard of a global
    batch, derived from global indices (host-count invariant)."""
    n_proc = jax.process_count()
    pid = jax.process_index()
    if global_batch % n_proc:
        raise ValueError(
            f"global_batch={global_batch} must divide over "
            f"{n_proc} processes."
        )
    local = global_batch // n_proc
    idx = np.arange(pid * local, (pid + 1) * local)
    return jax.vmap(lambda i: jax.random.fold_in(base_key, i))(
        jax.numpy.asarray(idx)
    )


def make_global_mesh(n_model: int = 1):
    """A ``(data, model)`` mesh spanning ALL devices of all processes
    (for jit-with-sharding use on pods); falls back to the local-device
    mesh in single-process runs."""
    from direct_data_driven_mpc_jax.parallel.mesh import (
        make_scenario_mesh,
    )

    if jax.process_count() == 1:
        return make_scenario_mesh(n_model=n_model)
    from jax.sharding import Mesh

    devices = np.array(jax.devices())
    n_data = devices.size // n_model
    return Mesh(
        devices[: n_data * n_model].reshape(n_data, n_model),
        axis_names=("data", "model"),
    )

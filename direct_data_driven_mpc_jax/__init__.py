"""Direct data-driven MPC framework for accelerators, in JAX.

A from-scratch JAX/XLA implementation of the Nominal and Robust
Direct Data-Driven MPC schemes of Berberich, Koehler, Mueller, Allgoewer,
"Data-Driven Model Predictive Control With Stability and Robustness
Guarantees", IEEE TAC 66(4), 2021 (arXiv:1906.04679).

Capability parity target: pavelacamposp/direct_data_driven_mpc (the
reference implementation; see SURVEY.md). The architecture here is
accelerator-first and shares no code with the reference:

- The per-step QP is never re-canonicalized. For equality-constrained
  variants (slack ``NONE``) the KKT system is factorized once at
  controller construction and each closed-loop step reduces to an exact
  affine map ``z*(t) = z0 + M @ [u_past; y_past]`` -- a single small
  matmul (see ``qp/solution_map.py``).
- The CONVEX slack variant runs a fixed-iteration ADMM whose KKT matrix
  is also factorized once (see ``qp/admm.py``).
- The closed loop (plant step + measurement-window shift + QP solve) is
  a single fused ``lax.scan`` (see ``control/loop.py``), ``vmap``-able
  over scenario batches and shardable over a ``jax.sharding.Mesh``
  (see ``parallel/``).
"""

from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)
from direct_data_driven_mpc_jax.ops.hankel import (
    hankel_matrix,
    evaluate_persistent_excitation,
)

__version__ = "0.1.0"

__all__ = [
    "DataDrivenMPCType",
    "SlackVarConstraintTypes",
    "DirectDataDrivenMPCController",
    "hankel_matrix",
    "evaluate_persistent_excitation",
]


def __getattr__(name):
    # Lazy import: keeps `import direct_data_driven_mpc_jax` light and
    # avoids pulling the full control stack for ops-only users.
    if name == "DirectDataDrivenMPCController":
        from direct_data_driven_mpc_jax.control.controller import (
            DirectDataDrivenMPCController,
        )

        return DirectDataDrivenMPCController
    raise AttributeError(name)

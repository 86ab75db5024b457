"""QP assembly and solvers for the data-driven MPC formulations."""

from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
    QPSpec,
)
from direct_data_driven_mpc_jax.qp.assembly import build_qp_spec
from direct_data_driven_mpc_jax.qp.solution_map import (
    SolutionMap,
    TrackingMap,
    compute_solution_map,
    compute_tracking_map,
)
from direct_data_driven_mpc_jax.qp.admm import (
    ADMMSolver,
    compute_admm_solver,
)
from direct_data_driven_mpc_jax.qp.distributed import (
    make_distributed_kkt_solver,
)
from direct_data_driven_mpc_jax.qp.nonconvex import (
    NonConvexADMMSolver,
    compute_nonconvex_admm_solver,
    nonconvex_admm_solve,
)

__all__ = [
    "NonConvexADMMSolver",
    "compute_nonconvex_admm_solver",
    "nonconvex_admm_solve",
    "DataDrivenMPCType",
    "SlackVarConstraintTypes",
    "QPSpec",
    "build_qp_spec",
    "SolutionMap",
    "TrackingMap",
    "compute_solution_map",
    "compute_tracking_map",
    "ADMMSolver",
    "compute_admm_solver",
    "make_distributed_kkt_solver",
]

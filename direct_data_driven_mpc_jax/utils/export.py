"""Controller export for the standalone C deployment runtime.

MPC controllers ultimately run on embedded / real-time hosts with no
Python. The JAX framework does all the expensive work at design time
(Hankel construction, KKT factorization, ADMM pre-factorization --
``qp/solution_map.py`` / ``qp/admm.py``); what deployment needs is only
the resulting *condensed per-step operator* plus the measurement
window. :func:`export_controller` serializes exactly that to a compact
binary blob which ``native/ddmpc_runtime.c`` (pure C99, zero
dependencies) loads and runs: one ``ddmpc_solve`` + ``ddmpc_observe``
pair per control step, microseconds per step.

The reference has no deployment story at all (it needs CVXPY + NumPy at
every step: /root/reference/direct_data_driven_mpc/
direct_data_driven_mpc_controller.py:389-407); this module is a
capability the condensed-operator design makes possible.

Blob layout (little-endian, fixed order; see ddmpc_runtime.c):

    magic   8 bytes   b"DDMPCRT1"
    u32 x10           kind (0 affine / 1 admm), n, m, p, L,
                      n_mpc_step, ns (0 = no plant block), nbox,
                      admm_iters, reserved
    f64 x6            cost_r, bound, rho, alpha, tol, eps_max
    f64 arrays        u_past (n*m), y_past (n*p)
      kind 0:         u_base (L*m), U_gain (L*m, nt), cost_P (nt, nt),
                      cost_q (nt)                     [nt = n*(m+p)]
      kind 1:         v_c (nbox), V_theta (nbox, nt), V_s (nbox, nbox),
                      u_c (L*m), U_theta (L*m, nt), U_s (L*m, nbox),
                      cost_P (nt+nbox, nt+nbox), cost_q (nt+nbox)
      if ns > 0:      A (ns, ns), B (ns, m), C (p, ns), D (p, m),
                      x0 (ns)
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"DDMPCRT1"


def export_controller(
    controller,
    path: str,
    plant=None,
    x0: np.ndarray | None = None,
    tol: float = 1e-8,
) -> None:
    """Serialize ``controller``'s condensed per-step operator (and
    optionally a plant model for closed-loop simulation/testing) into
    the C runtime's blob format.

    Args:
        controller: a constructed
            :class:`~direct_data_driven_mpc_jax.control.controller.DirectDataDrivenMPCController`
            (slack NONE -> affine operator; slack CONVEX -> ADMM
            operator). The controller's CURRENT measurement window is
            exported, so the C runtime resumes exactly where the Python
            controller stands.
        path: output file path.
        plant: optional
            :class:`~direct_data_driven_mpc_jax.models.lti_model.LTIModel`
            whose (A, B, C, D, eps_max) are embedded so the C demo can
            run a full closed loop; omit for real deployments (the
            physical system is the plant).
        x0: initial plant state to embed (defaults to the plant's
            current state).
        tol: ADMM exit tolerance baked into the blob (kind 1 only).
    """
    op = controller._op
    use_admm = controller._use_admm
    n, m, p, L = controller.n, controller.m, controller.p, controller.L
    nt = n * (m + p)
    nbox = int(op["v_c"].shape[0]) if use_admm else 0

    ns = 0
    plant_arrays: list[np.ndarray] = []
    eps_max = 0.0
    if plant is not None:
        A = np.asarray(plant.A, dtype=np.float64)
        ns = A.shape[0]
        x0_arr = np.asarray(
            plant.get_state() if x0 is None else x0, dtype=np.float64
        ).reshape(ns)
        eps_max = float(plant.get_eps_max())
        plant_arrays = [
            A,
            np.asarray(plant.B, dtype=np.float64).reshape(ns, m),
            np.asarray(plant.C, dtype=np.float64).reshape(p, ns),
            np.asarray(plant.D, dtype=np.float64).reshape(p, m),
            x0_arr,
        ]

    header = MAGIC + struct.pack(
        "<10I",
        1 if use_admm else 0,
        n, m, p, L,
        controller.n_mpc_step,
        ns,
        nbox,
        int(controller.admm_iters) if use_admm else 0,
        0,
    )
    scalars = struct.pack(
        "<6d",
        float(op["cost_r"]),
        float(op["bound"]) if use_admm else 0.0,
        float(op["rho"]) if use_admm else 0.0,
        float(op.get("alpha", 1.0)) if use_admm else 0.0,
        float(tol),
        eps_max,
    )

    arrays = [
        np.asarray(controller.u_past, dtype=np.float64).reshape(n * m),
        np.asarray(controller.y_past, dtype=np.float64).reshape(n * p),
    ]
    if use_admm:
        arrays += [
            op["v_c"].reshape(nbox),
            op["V_theta"].reshape(nbox, nt),
            op["V_s"].reshape(nbox, nbox),
            op["u_c"].reshape(L * m),
            op["U_theta"].reshape(L * m, nt),
            op["U_s"].reshape(L * m, nbox),
            op["cost_P"].reshape(nt + nbox, nt + nbox),
            op["cost_q"].reshape(nt + nbox),
        ]
    else:
        arrays += [
            op["u_base"].reshape(L * m),
            op["U_gain"].reshape(L * m, nt),
            op["cost_P"].reshape(nt, nt),
            op["cost_q"].reshape(nt),
        ]
    arrays += plant_arrays

    with open(path, "wb") as f:
        f.write(header)
        f.write(scalars)
        for a in arrays:
            f.write(
                np.ascontiguousarray(a, dtype="<f8").tobytes()
            )

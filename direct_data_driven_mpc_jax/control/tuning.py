"""Differentiable closed-loop tuning of the robust MPC regularization.

The paper's robust scheme has two hyperparameters that trade tracking
performance against noise robustness: the ridge products
``lambda_alpha * eps_max`` (the YAML key is literally
``lambda_alpha_epsilon_bar``) and ``lambda_sigma`` (reference cost at
``direct_data_driven_mpc_controller.py:713-716``; config mapping at
``utilities/controller/controller_creation.py:131-141``). The reference
can only grid-search them: every candidate requires a full CVXPY
re-canonicalization and a Python closed-loop re-run.

Here the ENTIRE pipeline -- KKT solve as a function of the ridge
weights, affine solution operator, fused closed-loop scan, Monte-Carlo
scenario batch -- is differentiable JAX code, so the regularization can
be tuned by GRADIENT DESCENT on the actual closed-loop objective
(expected tracking error under measurement noise). This is a
capability the reference's architecture cannot express at all.

How it works: for ROBUST slack-``NONE`` controllers the QP Hessian
depends on the ridge weights as

    H(a, s) = H_stage + 2*a*I_alpha + 2*s*I_sigma,
    a = lambda_alpha * eps_max,   s = lambda_sigma,

with everything else (A, b, S, g) constant. The KKT matrix is therefore
a differentiable function of ``(a, s)``; solving it with
``jnp.linalg.solve`` inside the computation graph makes the solution
operator -- and every closed-loop trajectory that uses it --
differentiable w.r.t. the regularization via the implicit-function
theorem (exactly the d(solve)/d(params) VJP JAX already implements for
``linalg.solve``).

Gradients flow end-to-end: tests/test_tuning.py checks them against
finite differences and runs a short optimization that measurably
improves the closed-loop objective. Runs in float64 on CPU (init-time
work, like the host factorization in qp/solution_map.py).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from direct_data_driven_mpc_jax.control.loop import closed_loop_rollout
from direct_data_driven_mpc_jax.ops.lti import LTIParams
from direct_data_driven_mpc_jax.qp.solution_map import SolutionMap
from direct_data_driven_mpc_jax.qp.spec import (
    DataDrivenMPCType,
    QPSpec,
    SlackVarConstraintTypes,
)


def _static_pieces(spec: QPSpec):
    """Host-side constants of the lambda-parametric KKT system.

    Returns ``(H_stage, e_alpha, e_sigma)`` -- the Hessian with the
    ridge blocks REMOVED plus the alpha/sigma diagonal indicator
    vectors: in the assembled spec the
    alpha block is exactly ``2*lamb_alpha*eps_max*I`` and the sigma
    block exactly ``2*lamb_sigma*I`` (qp/assembly.py:193-197), so
    zeroing those diagonals recovers the stage-cost-only Hessian
    without needing the original lambda values.
    """
    if spec.controller_type != DataDrivenMPCType.ROBUST:
        raise ValueError(
            "differentiable tuning requires a ROBUST controller (the "
            "NOMINAL KKT system is singular; its solution operator is "
            "not a differentiable function of ridge weights it does "
            "not have)."
        )
    if spec.slack_var_constraint_type != SlackVarConstraintTypes.NONE:
        raise ValueError(
            "differentiable tuning supports the slack-NONE variant "
            "(the exact affine solution path); CONVEX/NON_CONVEX "
            "solves are iterative."
        )
    nz = spec.nz
    H_stage = np.array(spec.H, dtype=np.float64)
    e_alpha = np.zeros(nz)
    e_alpha[spec.alpha_slice] = 1.0
    e_sigma = np.zeros(nz)
    e_sigma[spec.sigma_slice] = 1.0
    H_stage[np.diag_indices(nz)] -= (
        H_stage[np.diag_indices(nz)] * (e_alpha + e_sigma)
    )
    return H_stage, e_alpha, e_sigma


def differentiable_solution_map(
    spec: QPSpec,
    alpha_reg: jax.Array,
    sigma_reg: jax.Array,
    dtype=jnp.float64,
) -> SolutionMap:
    """Affine solution operator as a differentiable function of the
    ridge products ``alpha_reg = lambda_alpha * eps_max`` and
    ``sigma_reg = lambda_sigma``.

    Mirrors ``compute_solution_operator_np`` (same KKT system, same
    operator fields -- parity asserted in tests/test_tuning.py) but in
    JAX, so ``jax.grad`` flows through the returned operator and any
    closed-loop rollout built from it.

    Unlike the host path (which residual-checks and falls back to the
    pseudoinverse), ``jnp.linalg.solve`` under jit cannot raise on a
    singular KKT matrix -- it yields NaNs. ROBUST controllers with
    persistently-exciting data are nonsingular by construction;
    :func:`tune_regularization` probes the initial objective eagerly
    and fails fast otherwise.
    """
    from direct_data_driven_mpc_jax.qp.solution_map import (
        _check_dtype_supported,
    )

    _check_dtype_supported(dtype)
    H_stage, e_alpha, e_sigma = _static_pieces(spec)
    nz, nc = spec.nz, spec.nc
    n_theta = spec.S.shape[1]

    H_stage = jnp.asarray(H_stage, dtype)
    A = jnp.asarray(spec.A, dtype)
    g = jnp.asarray(spec.g, dtype)
    b_const = jnp.asarray(spec.b_const, dtype)
    Ssel = jnp.asarray(spec.S, dtype)
    ridge = (
        2.0 * alpha_reg * jnp.asarray(e_alpha, dtype)
        + 2.0 * sigma_reg * jnp.asarray(e_sigma, dtype)
    )
    H = H_stage + jnp.diag(ridge)

    K = jnp.zeros((nz + nc, nz + nc), dtype)
    K = K.at[:nz, :nz].set(H)
    K = K.at[:nz, nz:].set(A.T)
    K = K.at[nz:, :nz].set(A)
    RHS = jnp.zeros((nz + nc, 1 + n_theta), dtype)
    RHS = RHS.at[:nz, 0].set(-g)
    RHS = RHS.at[nz:, 0].set(b_const)
    RHS = RHS.at[nz:, 1:].set(Ssel)
    X = jnp.linalg.solve(K, RHS)
    z_base = X[:nz, 0]
    Z = X[:nz, 1:]

    Hz = H @ Z
    cost_P = 0.5 * (Z.T @ Hz)
    cost_P = 0.5 * (cost_P + cost_P.T)
    cost_q = Z.T @ (H @ z_base + g)
    cost_r = 0.5 * z_base @ (H @ z_base) + g @ z_base + spec.r0

    u_sl = spec.u_pred_slice
    return SolutionMap(
        z_base=z_base,
        Z=Z,
        u_base=z_base[u_sl],
        U_gain=Z[u_sl],
        cost_P=cost_P,
        cost_q=cost_q,
        cost_r=cost_r,
    )


def make_closed_loop_objective(
    spec: QPSpec,
    plant: LTIParams,
    x0s: jax.Array,  # (B, ns)
    u_pasts: jax.Array,  # (B, n, m)
    y_pasts: jax.Array,  # (B, n, p)
    Ws: jax.Array,  # (B, n_steps, p)
    n_steps: int,
    n_mpc_step: int = 1,
    u_weight: float = 0.0,
) -> Callable[[jax.Array], jax.Array]:
    """Build ``loss(log_regs) -> scalar``: the Monte-Carlo mean squared
    closed-loop tracking error (plus ``u_weight`` times the input
    deviation) over a batch of noise realizations, as a function of
    ``log_regs = [log alpha_reg, log sigma_reg]`` (log-space keeps the
    ridge weights positive under unconstrained gradient steps).

    The returned function is differentiable and jittable; pair it with
    ``jax.value_and_grad`` + any optax optimizer, or use
    :func:`tune_regularization`.
    """
    y_s = jnp.asarray(spec.y_s, jnp.float64)
    u_s = jnp.asarray(spec.u_s, jnp.float64)

    def loss(log_regs: jax.Array) -> jax.Array:
        sol = differentiable_solution_map(
            spec, jnp.exp(log_regs[0]), jnp.exp(log_regs[1])
        )

        def one(x0, up, yp, W):
            res = closed_loop_rollout(
                plant, sol, x0, up, yp, W,
                n_steps=n_steps, n_mpc_step=n_mpc_step,
            )
            track = jnp.mean((res.y_sys - y_s[None, :]) ** 2)
            effort = jnp.mean((res.u_sys - u_s[None, :]) ** 2)
            return track + u_weight * effort

        return jnp.mean(
            jax.vmap(one)(
                jnp.asarray(x0s, jnp.float64),
                jnp.asarray(u_pasts, jnp.float64),
                jnp.asarray(y_pasts, jnp.float64),
                jnp.asarray(Ws, jnp.float64),
            )
        )

    return loss


def tune_regularization(
    loss: Callable[[jax.Array], jax.Array],
    alpha_reg0: float,
    sigma_reg0: float,
    steps: int = 50,
    learning_rate: float = 0.3,
    verbose: bool = False,
    optimizer: Optional[object] = None,
) -> dict:
    """Gradient-descent the ridge weights against a closed-loop
    objective from :func:`make_closed_loop_objective`.

    Uses optax adam in log-space. Returns a dict with the tuned
    ``alpha_reg``/``sigma_reg``, the loss trajectory, and the
    initial/final losses.
    """
    import optax

    opt = optimizer or optax.adam(learning_rate)
    params = jnp.log(jnp.asarray([alpha_reg0, sigma_reg0], jnp.float64))
    opt_state = opt.init(params)
    vg = jax.jit(jax.value_and_grad(loss))

    # Fail fast on a singular KKT system (rank-deficient data): inside
    # the jitted objective jnp.linalg.solve cannot raise, it silently
    # yields NaN -- so probe the initial loss eagerly here.
    v0, _ = vg(params)
    if not bool(jnp.isfinite(v0)):
        raise ValueError(
            "closed-loop objective is non-finite at the initial ridge "
            "weights -- the KKT system is likely singular (check "
            "persistent excitation of the data; NOMINAL controllers "
            "are rejected for this reason)."
        )

    history = []
    best = (jnp.inf, params)
    for i in range(steps):
        value, grad = vg(params)
        history.append(float(value))
        if float(value) < float(best[0]):
            best = (value, params)
        if verbose:
            print(
                f"  step {i:3d}: loss {float(value):.6e}  "
                f"alpha_reg {float(jnp.exp(params[0])):.4e}  "
                f"sigma_reg {float(jnp.exp(params[1])):.4e}",
                flush=True,
            )
        updates, opt_state = opt.update(grad, opt_state, params)
        params = optax.apply_updates(params, updates)
    final = float(vg(params)[0])  # reuse the jitted objective
    if final < float(best[0]):
        best = (final, params)
    history.append(final)
    return {
        "alpha_reg": float(jnp.exp(best[1][0])),
        "sigma_reg": float(jnp.exp(best[1][1])),
        "loss_history": history,
        "initial_loss": history[0],
        "final_loss": float(best[0]),
    }

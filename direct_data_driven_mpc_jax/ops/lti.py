"""LTI plant simulation as pure, scannable JAX functions.

Capability parity with the reference's ``utilities/model_simulation.py``
(LTIModel.simulate_step at :70-98, LTIModel.simulate at :100-131),
re-designed for XLA: the rollout is a single ``lax.scan`` (one compiled
loop, no Python-level stepping) and every function is pure -- plant
state is carried explicitly so the whole closed loop can live inside
``jit``/``vmap``/``shard_map``.

Semantics (discrete-time state space, output computed BEFORE the state
update, exactly as the reference does at model_simulation.py:94-96)::

    y(k) = C x(k) + D u(k) + w(k)
    x(k+1) = A x(k) + B u(k)
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax


class LTIParams(NamedTuple):
    """State-space matrices of a discrete-time LTI plant (a pytree leaf
    bundle: usable directly as a scan/vmap carry constant)."""

    A: jax.Array  # (n, n)
    B: jax.Array  # (n, m)
    C: jax.Array  # (p, n)
    D: jax.Array  # (p, m)


def lti_step(
    params: LTIParams, x: jax.Array, u: jax.Array, w: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """One plant step. Returns ``(x_next, y)``.

    ``x``: ``(n,)`` state, ``u``: ``(m,)`` input, ``w``: ``(p,)``
    additive measurement noise on the output. Matmul precision is
    pinned to full f32 (reduced-precision passes, e.g. TF32, drift long
    rollouts).
    """
    with jax.default_matmul_precision("highest"):
        y = params.C @ x + params.D @ u + w
        x_next = params.A @ x + params.B @ u
    return x_next, y


def lti_rollout(
    params: LTIParams, x0: jax.Array, U: jax.Array, W: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Roll the plant over ``U.shape[0]`` steps with one ``lax.scan``.

    Args:
        params: plant matrices.
        x0: ``(n,)`` initial state.
        U: ``(T, m)`` inputs.
        W: ``(T, p)`` measurement noise.

    Returns:
        ``(x_final, Y)`` with ``Y`` of shape ``(T, p)``.
    """

    def step(x, uw):
        u, w = uw
        x_next, y = lti_step(params, x, u, w)
        return x_next, y

    x_final, Y = jax.lax.scan(step, x0, (U, W))
    return x_final, Y

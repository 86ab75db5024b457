"""Hankel-matrix construction and persistent-excitation checks.

Capability parity with the reference's
``direct_data_driven_mpc/utilities/hankel_matrix.py`` (hankel_matrix at
:5-53, evaluate_persistent_excitation at :55-86), re-designed for XLA:
the reference builds columns in a Python loop; here the whole matrix is
a single vectorized gather + reshape, so it traces to one XLA op and is
``vmap``-able over batches of trajectories.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def hankel_matrix(X: jax.Array, L: int) -> jax.Array:
    """Build the block-Hankel matrix of window length ``L`` from ``X``.

    ``X`` has shape ``(N, n)``: a sequence of ``N`` elements of length
    ``n``. The result has shape ``(L * n, N - L + 1)``; column ``i`` is
    ``X[i : i + L, :]`` flattened row-major, matching the data-driven
    system characterization H_L(x) of Willems' fundamental lemma
    (reference semantics: hankel_matrix.py:40-53).

    Args:
        X: ``(N, n)`` data matrix.
        L: window length (static Python int).

    Returns:
        ``(L * n, N - L + 1)`` Hankel matrix, same dtype as ``X``.

    Raises:
        ValueError: if ``N < L`` (window exceeds data length).
    """
    X = jnp.asarray(X)
    if X.ndim != 2:
        raise ValueError(f"X must be 2-D (N, n); got shape {X.shape}.")
    N, n = X.shape
    L = int(L)
    if N < L:
        raise ValueError("N must be greater than or equal to L.")
    n_cols = N - L + 1
    # windows[l, i, j] = X[i + l, j]; one gather, no Python loop.
    starts = jnp.arange(L)[:, None] + jnp.arange(n_cols)[None, :]
    windows = X[starts]  # (L, n_cols, n)
    # Column i must be X[i:i+L].flatten() = [X[i,0..n-1], X[i+1,0..n-1], ...]
    return windows.transpose(0, 2, 1).reshape(L * n, n_cols)


def matrix_rank(M: jax.Array, tol: float | None = None) -> jax.Array:
    """Numerical rank via SVD with the NumPy default threshold.

    Threshold matches ``np.linalg.matrix_rank``:
    ``tol = S.max() * max(M.shape) * eps(dtype)`` (the reference relies
    on that default at hankel_matrix.py:81).
    """
    M = jnp.asarray(M)
    s = jnp.linalg.svd(M, compute_uv=False)
    if tol is None:
        eps = jnp.finfo(M.dtype).eps
        tol_val = s.max() * max(M.shape) * eps
    else:
        tol_val = jnp.asarray(tol, dtype=s.dtype)
    return jnp.sum(s > tol_val)


def evaluate_persistent_excitation(
    X: jax.Array, order: int, tol: float | None = None
) -> Tuple[int, bool]:
    """Check persistent excitation of ``X`` of a given ``order``.

    ``X`` (shape ``(N, n)``) is persistently exciting of order ``order``
    iff ``rank(H_order(X)) == n * order`` (Definition 1 of the paper;
    reference semantics: hankel_matrix.py:55-86).

    This is an init-time check (never inside the hot loop); the rank is
    computed via SVD and returned as concrete host values.

    Returns:
        ``(rank, is_persistently_exciting)``.
    """
    # Delegates to the float64 host twin: routing through JAX with x64
    # off would cast the data to float32, whose ~1e-7 relative
    # perturbation dwarfs the float64 rank threshold and makes
    # rank-deficient data look persistently exciting.
    X_np = np.asarray(X, dtype=np.float64)
    if X_np.ndim != 2:
        raise ValueError(f"X must be 2-D (N, n); got shape {X_np.shape}.")
    from direct_data_driven_mpc_jax.ops.host import (
        evaluate_persistent_excitation_np,
    )

    return evaluate_persistent_excitation_np(X_np, order, tol=tol)

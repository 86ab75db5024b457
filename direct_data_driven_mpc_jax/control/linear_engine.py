"""Condensed linear closed-loop engine.

For slack-``NONE`` controllers the per-step QP solution is an exact
affine map of the past window (qp/solution_map.py), and the plant is
linear -- so the ENTIRE closed-loop system (plant state + measurement
window under MPC feedback) is an affine time-invariant recursion:

    s_{t+1} = M s_t + c + N w_t,        s = [x; u_past; y_past]
    [u_t; y_t] = O_s s_t + o_c + O_w w_t

with ``s`` only ``ns + n(m+p)`` numbers (20 for the four-tank
benchmark). ``build_affine_block_map`` composes this symbolically in
float64 on the host, over one Algorithm-2 solve block (``n_mpc_step``
plant steps per QP solve) times ``solves_per_block`` solves. The device
rollout is then a ``lax.scan`` whose per-iteration work is ONE batched
matmul ``(B, S + K nw) @ (S + K nw, S + outputs)`` covering K solves at
once -- sequential-step overhead amortizes K-fold and the matmul shapes
grow to GEMM sizes (K=64, p=2 -> 128-wide operands). This is the mathematical speed-of-light formulation for
this problem class: the QP is pre-solved into the recursion.

Per-solve optimal costs are NOT computed inside the sequential loop
(they are quadratic forms, awkward to batch there); instead the state
at every solve time is emitted and the costs are evaluated afterwards
in one vectorized quadratic-form pass over all (B x n_solves) states.

This engine is an exact algebraic condensation of
``control/loop.py::closed_loop_rollout`` (identical trajectories up to
float rounding; asserted in tests/test_linear_engine.py). The generic
engine remains the reference path and the only path for the ADMM
(CONVEX slack) variant, whose clip nonlinearity does not condense.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from direct_data_driven_mpc_jax.control.loop import ClosedLoopResult
from direct_data_driven_mpc_jax.ops.lti import LTIParams


class AffineBlockMap(NamedTuple):
    """Device-resident condensed multi-solve block map (a JAX pytree).

    Row convention (batch leads):
        s'      = s @ M_T   + c    + w @ N_T
        u_block = s @ OuS_T + ou_c + w @ OuW_T   (K * nb * m outputs)
        y_block = s @ OyS_T + oy_c + w @ OyW_T   (K * nb * p outputs)
        s_stack = s @ OsS_T + os_c + w @ OsW_T   (K * S: state at each
                                                  solve time)
    with w the flattened noise of the whole block (K * nb * p).
    Cost of one solve at state s: theta = s[ns:],
        cost = theta P theta + q . theta + r  (P,q,r in theta space).
    """

    M_T: jax.Array
    c: jax.Array
    N_T: jax.Array
    OuS_T: jax.Array
    ou_c: jax.Array
    OuW_T: jax.Array
    OyS_T: jax.Array
    oy_c: jax.Array
    OyW_T: jax.Array
    OsS_T: jax.Array
    os_c: jax.Array
    OsW_T: jax.Array
    cost_P: jax.Array  # (n_theta [+ n_r], n_theta [+ n_r])
    cost_q: jax.Array  # (n_theta [+ n_r],)
    cost_r: jax.Array  # ()
    s_star: jax.Array  # (S,) center point (zeros when center=False)
    #: Setpoint-channel width (static). 0 = plain map. When > 0 the
    #: LAST ``n_r`` rows of every ``*W_T`` operator act on the
    #: setpoint DELTA ``dr = [u_s; y_s] - r_bar`` (one dr per block,
    #: appended to the flattened block noise), and the cost quadratic
    #: is joint in ``[theta; dr]``. Built by ``tracking_op=`` below.
    n_r: int = 0
    r_bar: Optional[jax.Array] = None  # (m+p,) center setpoints


def build_affine_block_map(
    plant: LTIParams,
    solution_op: dict,
    n: int,
    m: int,
    p: int,
    n_mpc_step: int = 1,
    solves_per_block: int = 1,
    center: bool = True,
    dtype=jnp.float32,
    tracking_op: Optional[dict] = None,
) -> AffineBlockMap:
    """Compose ``solves_per_block`` Algorithm-1/2 solve blocks into one
    affine map (host, float64).

    Args:
        plant: LTI plant matrices (the simulated true system; its state
            dimension may differ from the controller's model order).
        solution_op: the float64 operator dict from
            ``compute_solution_operator_np`` (slack-NONE controllers).
        n, m, p: controller model order / input / output dimensions.
        n_mpc_step: plant steps per QP solve (Algorithm 2).
        solves_per_block: QP solves composed per scan iteration.
        dtype: device dtype of the emitted operator.
        tracking_op: optional float64 dict from
            ``compute_tracking_operator_np`` (qp/solution_map.py).
            When given, the map gains a SETPOINT input channel: the
            last ``n_r = m + p`` rows of every ``*W_T`` operator act on
            the block's setpoint delta ``dr = [u_s; y_s] - r_bar``
            (``r_bar`` = the spec's baked setpoints), the cost
            quadratic becomes joint in ``[theta; dr]``, and the fused
            engines accept a per-block setpoint schedule. ``dr = 0``
            reduces exactly to the plain map (asserted at build time
            in float64).
    """
    from direct_data_driven_mpc_jax.qp.solution_map import (
        _check_dtype_supported,
    )

    _check_dtype_supported(dtype)
    A = np.asarray(plant.A, dtype=np.float64)
    B = np.asarray(plant.B, dtype=np.float64)
    C = np.asarray(plant.C, dtype=np.float64)
    Dm = np.asarray(plant.D, dtype=np.float64)
    ns = A.shape[0]
    n_theta = n * (m + p)
    S = ns + n_theta
    nb = n_mpc_step
    K = solves_per_block
    nw = K * nb * p
    n_r = (m + p) if tracking_op is not None else 0
    # Homogeneous coordinates [s; 1; w_block; dr]: the setpoint delta
    # enters as extra input lanes appended to the block noise, so the
    # whole composition below is oblivious to it.
    Dfull = S + 1 + nw + n_r

    # Row-operator representation: each tracked quantity is a matrix
    # acting on [s; 1; w].
    X = np.zeros((ns, Dfull))
    X[:, :ns] = np.eye(ns)
    TH = np.zeros((n_theta, Dfull))
    TH[:, ns : ns + n_theta] = np.eye(n_theta)
    ONE = np.zeros(Dfull)
    ONE[S] = 1.0

    # First nb*m rows of the affine QP solution (lazy evaluation --
    # unused tail rows of the gain never touch the hot path).
    if nb * m > solution_op["U_gain"].shape[0]:
        raise ValueError(
            f"n_mpc_step ({nb}) exceeds the optimized horizon "
            f"(L = {solution_op['U_gain'].shape[0] // m})."
        )
    U_gain = solution_op["U_gain"][: nb * m]  # (nb*m, n_theta)
    u_base = solution_op["u_base"][: nb * m]
    if tracking_op is not None:
        U_r = np.asarray(tracking_op["U_r"], np.float64)[: nb * m]
        r_bar = np.concatenate(
            [
                np.asarray(tracking_op["u_s"], np.float64),
                np.asarray(tracking_op["y_s"], np.float64),
            ]
        )
        # Consistency: the baked affine solve IS the tracking solve at
        # r_bar (the tracking operator has no constant term).
        u_base_chk = (
            np.asarray(tracking_op["U_r"], np.float64) @ r_bar
        )[: nb * m]
        if not np.allclose(u_base_chk, u_base, atol=1e-9):
            raise AssertionError(
                "tracking operator is inconsistent with the baked "
                "solution operator at the spec's own setpoints"
            )
        DR = np.zeros((n_r, Dfull))
        DR[:, S + 1 + nw :] = np.eye(n_r)

    out_u = np.zeros((K * nb * m, Dfull))
    out_y = np.zeros((K * nb * p, Dfull))
    out_s = np.zeros((K * S, Dfull))
    for k in range(K):
        # State at this solve time (pre-solve), for post-hoc costs.
        out_s[k * S : (k + 1) * S] = np.concatenate([X, TH], axis=0)
        USEQ = U_gain @ TH + np.outer(u_base, ONE)
        if tracking_op is not None:
            USEQ = USEQ + U_r @ DR
        for j in range(nb):
            t = k * nb + j
            Uj = USEQ[j * m : (j + 1) * m]  # (m, Dfull)
            Wj = np.zeros((p, Dfull))
            Wj[:, S + 1 + t * p : S + 1 + (t + 1) * p] = np.eye(p)
            Yj = C @ X + Dm @ Uj + Wj
            X = A @ X + B @ Uj
            # Shift the measurement window: drop oldest, append current.
            TH = np.concatenate(
                [TH[m : n * m], Uj, TH[n * m + p :], Yj], axis=0
            )
            out_u[t * m : (t + 1) * m] = Uj
            out_y[t * p : (t + 1) * p] = Yj

    SP = np.concatenate([X, TH], axis=0)  # (S, Dfull)

    def split(Mrows):
        return Mrows[:, :S], Mrows[:, S], Mrows[:, S + 1 :]

    M_, c_, N_ = split(SP)
    OuS, ou_c, OuW = split(out_u)
    OyS, oy_c, OyW = split(out_y)
    OsS, os_c, OsW = split(out_s)

    if center:
        # Re-center on the closed-loop fixed point s* = M s* + c (for a
        # stabilizing loop I - M is invertible). Rolling the DEVIATION
        # e = s - s* removes the large-magnitude constant from every
        # f32 add: e decays toward the noise floor instead of
        # cancelling against O(setpoint)-sized coordinates, which
        # measurably tightens float32 steady-state accuracy. The
        # constants fold into the output offsets exactly (float64).
        #
        # Robustness guard: with a closed-loop eigenvalue near 1 (e.g.
        # an uncontrolled integrator mode, or the UCON scheme) I - M is
        # (near-)singular and the fixed-point solve produces a huge or
        # non-finite s* -- then the f32 deviation rollout LOSES exactly
        # the accuracy centering was meant to buy (e = s - s* is a
        # catastrophic cancellation of two huge numbers). Detect that
        # and fall back to the uncentered map with a warning.
        IM = np.eye(S) - M_
        cond_IM = np.linalg.cond(IM)
        if np.isfinite(cond_IM) and cond_IM < 1e8:
            s_star = np.linalg.solve(IM, c_)
        else:
            s_star = np.full(S, np.nan)
        # Scale guard: even a moderately conditioned solve can return
        # an s* so large that f32 deviations underflow the signal.
        s_scale = 1.0 + float(np.abs(c_).max(initial=0.0))
        if not (
            np.all(np.isfinite(s_star))
            and float(np.abs(s_star).max(initial=0.0)) < 1e6 * s_scale
        ):
            import warnings

            warnings.warn(
                "closed-loop fixed point is ill-conditioned "
                f"(cond(I - M) = {cond_IM:.2e}); centering disabled -- "
                "the loop has an eigenvalue at/near 1 (marginally "
                "stable or unstable scheme). Rolling absolute "
                "coordinates instead.",
                RuntimeWarning,
                stacklevel=2,
            )
            s_star = np.zeros(S)
        ou_c = ou_c + OuS @ s_star
        oy_c = oy_c + OyS @ s_star
        os_c = os_c + OsS @ s_star
        c_ = c_ - (s_star - M_ @ s_star)
    else:
        s_star = np.zeros(S)

    if tracking_op is not None:
        # Joint cost in zeta = [theta; dr]: with xi = [theta; r_bar+dr]
        # and cost(xi) = xi' P xi, cost(zeta) = zeta' P zeta +
        # (2 P e).zeta + e'Pe, e = [0_theta; r_bar]. At dr = 0 this is
        # exactly the baked theta-space cost (asserted).
        P_j = np.asarray(tracking_op["cost_P"], np.float64)
        e = np.concatenate([np.zeros(n_theta), r_bar])
        q_j = 2.0 * (P_j @ e)
        r_j = float(e @ P_j @ e)
        if not (
            np.allclose(
                P_j[:n_theta, :n_theta], solution_op["cost_P"],
                atol=1e-9,
            )
            and np.allclose(
                q_j[:n_theta], solution_op["cost_q"], atol=1e-9
            )
            and abs(r_j - float(solution_op["cost_r"])) < 1e-7
        ):
            raise AssertionError(
                "joint tracking cost does not reduce to the baked "
                "theta-space cost at dr = 0"
            )
        cost_P, cost_q, cost_r = P_j, q_j, np.float64(r_j)
    else:
        r_bar = None
        cost_P = solution_op["cost_P"]
        cost_q = solution_op["cost_q"]
        cost_r = solution_op["cost_r"]

    cast = lambda a: jnp.asarray(a, dtype=dtype)
    return AffineBlockMap(
        M_T=cast(M_.T),
        c=cast(c_),
        N_T=cast(N_.T),
        OuS_T=cast(OuS.T),
        ou_c=cast(ou_c),
        OuW_T=cast(OuW.T),
        OyS_T=cast(OyS.T),
        oy_c=cast(oy_c),
        OyW_T=cast(OyW.T),
        OsS_T=cast(OsS.T),
        os_c=cast(os_c),
        OsW_T=cast(OsW.T),
        cost_P=cast(cost_P),
        cost_q=cast(cost_q),
        cost_r=cast(cost_r),
        s_star=cast(s_star),
        n_r=n_r,
        r_bar=None if r_bar is None else cast(r_bar),
    )


def build_linear_engine(
    controller,
    plant: LTIParams,
    n_mpc_step: Optional[int] = None,
    solves_per_block: int = 1,
    center: bool = True,
    dtype=jnp.float32,
) -> AffineBlockMap:
    """Public condensed-engine entry: block map straight from a
    :class:`~direct_data_driven_mpc_jax.control.controller.\
DirectDataDrivenMPCController` (slack-NONE variants).

    Dimensions and the solve cadence default to the controller's own;
    the float64 solution operator comes from
    ``controller.solution_operator()`` -- no private attributes.
    """
    if n_mpc_step is None:
        n_mpc_step = controller.n_mpc_step
    return build_affine_block_map(
        plant,
        controller.solution_operator(),
        n=controller.n,
        m=controller.m,
        p=controller.p,
        n_mpc_step=n_mpc_step,
        solves_per_block=solves_per_block,
        center=center,
        dtype=dtype,
    )


def build_tracking_engine(
    controller,
    plant: LTIParams,
    n_mpc_step: Optional[int] = None,
    solves_per_block: int = 1,
    center: bool = True,
    dtype=jnp.float32,
) -> AffineBlockMap:
    """Condensed engine WITH a setpoint input channel: time-varying
    reference tracking through the fused engines at full throughput.

    The returned map's ``n_r = m + p`` and the fused rollouts accept a
    ``setpoints`` schedule (one ``[u_s; y_s]`` row per outer block of
    ``solves_per_block * n_mpc_step`` plant steps; per-scenario
    schedules batch on a leading axis). For per-SOLVE granularity use
    the generic loop with ``controller.tracking_map()``. The reference
    retargets only by re-running its entire init pipeline per setpoint
    change (ref direct_data_driven_mpc_controller.py:945-982).
    """
    if n_mpc_step is None:
        n_mpc_step = controller.n_mpc_step
    return build_affine_block_map(
        plant,
        controller.solution_operator(),
        n=controller.n,
        m=controller.m,
        p=controller.p,
        n_mpc_step=n_mpc_step,
        solves_per_block=solves_per_block,
        center=center,
        dtype=dtype,
        tracking_op=controller.tracking_operator(),
    )


def closed_loop_spectrum(block_map: AffineBlockMap) -> dict:
    """Eigen-analysis of the condensed closed-loop transition matrix.

    Because the controller+plant loop condenses to ``s' = M s + c +
    N w``, closed-loop stability is DECIDABLE at construction time:
    ``spectral_radius < 1`` iff the loop is asymptotically stable (per
    solve block). The reference can only observe divergence empirically
    at run time (its README warns the UCON scheme "is unstable and
    diverges" for most seeds, robust_data_driven_mpc_reproduction.py:
    21-28); here that is a one-line certificate
    (tests/test_stability.py proves TEC stable and UCON unstable for
    the four-tank benchmark).

    Returns ``{"spectral_radius", "stable", "eigenvalues"}`` (host
    float64 numpy).
    """
    M = np.asarray(block_map.M_T, dtype=np.float64).T
    eigs = np.linalg.eigvals(M)
    radius = float(np.abs(eigs).max())
    return {
        "spectral_radius": radius,
        "stable": bool(radius < 1.0),
        "eigenvalues": eigs,
    }


def _block_meta(block_map: AffineBlockMap, m: int, p: int):
    """Returns (S, K, nb): state dim, solves per block, steps per
    solve -- all recovered from operator shapes."""
    S = block_map.M_T.shape[0]
    total_p = block_map.oy_c.shape[0]
    K = block_map.os_c.shape[0] // S
    nb = total_p // (K * p)
    return S, K, nb


def _setpoint_deltas(
    block_map: AffineBlockMap,
    setpoints,
    n_outer: int,
    dtype,
    where: str,
) -> jax.Array:
    """Validate a setpoint schedule against the map's tracking channel
    and return the per-outer-block deltas ``dr = r - r_bar``.

    Plain maps (``n_r == 0``) return a zero-width ``(n_outer, 0)``
    array (inert lanes); tracking maps require ``setpoints`` as a
    constant ``(n_r,)`` vector or an ``(n_outer, n_r)`` per-block
    schedule of absolute setpoints ``[u_s; y_s]``.
    """
    n_r = getattr(block_map, "n_r", 0) or 0
    if n_r == 0:
        if setpoints is not None:
            raise ValueError(
                f"{where}: `setpoints` schedules require a tracking "
                "block map (build with tracking_op=... / "
                "build_tracking_engine)."
            )
        return jnp.zeros((n_outer, 0), dtype=dtype)
    if setpoints is None:
        raise ValueError(
            f"{where}: tracking block map (n_r > 0) requires a "
            f"`setpoints` schedule: ({n_r},) constant or "
            f"({n_outer}, {n_r}) per outer block."
        )
    R = jnp.asarray(setpoints, dtype=dtype)
    if R.ndim == 1:
        R = jnp.broadcast_to(R[None], (n_outer, n_r))
    if R.shape != (n_outer, n_r):
        raise ValueError(
            f"{where}: setpoints must have shape ({n_r},) or "
            f"({n_outer}, {n_r}); got {jnp.asarray(setpoints).shape}"
        )
    return R - jnp.asarray(block_map.r_bar, dtype=dtype)[None]


def linear_closed_loop_rollout(
    block_map: AffineBlockMap,
    x0: jax.Array,
    u_past: jax.Array,
    y_past: jax.Array,
    W: Optional[jax.Array] = None,
    n_steps: int = 0,
    n_mpc_step: int = 1,
    noise_key: Optional[jax.Array] = None,
    eps_max: float = 0.0,
    emit_trajectories: bool = True,
    precision: str = "highest",
    setpoints: Optional[jax.Array] = None,
) -> ClosedLoopResult:
    """Rollout via the condensed affine recursion (single scenario; wrap
    in ``vmap`` for batches). Interface-compatible with
    ``closed_loop_rollout``: returns per-step ``u_sys``/``y_sys`` and
    per-solve ``costs`` trimmed to ``n_steps``.

    Noise: pass either ``W`` (an explicit ``(n_steps, p)`` array, used
    for parity tests) or ``noise_key`` + ``eps_max`` -- then bounded
    uniform noise is drawn INSIDE the scan from
    ``fold_in(noise_key, block_index)``, so the noise tensor is never
    materialized in HBM (essential at the 64k-scenario scale, where
    explicit noise would be ~100 GB).

    ``emit_trajectories=False`` skips the per-step ``u_sys``/``y_sys``
    outputs (returned empty) and emits only per-solve costs + final
    state -- the Monte-Carlo aggregate mode.

    ``setpoints`` (tracking maps, ``block_map.n_r > 0``): absolute
    ``[u_s; y_s]`` schedule, constant ``(n_r,)`` or per-outer-block
    ``(n_outer, n_r)``; the centered delta rides the last ``n_r``
    input lanes and the per-solve cost is the joint ``[theta; dr]``
    quadratic (same semantics as the fused engines).
    """
    m = u_past.shape[1]
    p = y_past.shape[1]
    dtype = block_map.M_T.dtype
    S, K, nb = _block_meta(block_map, m, p)
    ns = S - u_past.size - y_past.size
    assert nb == n_mpc_step, (
        f"block map built for n_mpc_step={nb}, called with {n_mpc_step}"
    )
    steps_per_outer = K * n_mpc_step

    n_solves = math.ceil(n_steps / n_mpc_step)
    n_outer = math.ceil(n_steps / steps_per_outer)
    pad = n_outer * steps_per_outer - n_steps

    DR = _setpoint_deltas(
        block_map, setpoints, n_outer, dtype,
        "linear_closed_loop_rollout",
    )

    if W is not None:
        W_pad = jnp.concatenate(
            [
                jnp.asarray(W, dtype=dtype),
                jnp.zeros((pad, p), dtype=dtype),
            ],
            axis=0,
        ).reshape(n_outer, steps_per_outer * p)
        xs = (W_pad, DR)
    else:
        if noise_key is None:
            raise ValueError("Provide either W or noise_key.")
        xs = (jnp.arange(n_outer), DR)

    # Roll the deviation e = s - s_star (s_star is zero when the map
    # was built uncentered); emitted outputs are absolute either way.
    s0 = (
        jnp.concatenate(
            [
                jnp.asarray(x0, dtype=dtype).reshape(-1),
                jnp.asarray(u_past, dtype=dtype).reshape(-1),
                jnp.asarray(y_past, dtype=dtype).reshape(-1),
            ]
        )
        - block_map.s_star
    )

    def block(s, x):
        x_w, dr = x
        if W is not None:
            w = x_w
        else:
            w = eps_max * jax.random.uniform(
                jax.random.fold_in(noise_key, x_w),
                (steps_per_outer * p,),
                minval=-1.0,
                maxval=1.0,
                dtype=dtype,
            )
        # Tracking maps: the setpoint delta rides the LAST n_r input
        # lanes of the W channel (inert zero-width concat otherwise).
        w = jnp.concatenate([w, dr])
        # Full-f32 matmul precision by default: a reduced-precision
        # pass (TF32, one bf16 pass) visibly drifts 400-step
        # recursions. "highest" is the parity-safe default; "high" is
        # an opt-in speed knob -- only use it with a measured deviation
        # budget.
        with jax.default_matmul_precision(precision):
            st = (
                s @ block_map.OsS_T + block_map.os_c + w @ block_map.OsW_T
            )
            # Per-solve costs computed in-block from the theta rows of
            # the solve-time states (keeps the emitted outputs small).
            # Tracking maps: joint [theta; dr] quadratic (dr is shared
            # by every solve of the block).
            thetas = st.reshape(K, S)[:, ns:]
            xi = jnp.concatenate(
                [thetas, jnp.tile(dr[None], (K, 1))], axis=1
            )
            costs_k = (
                jnp.einsum("ti,ij,tj->t", xi, block_map.cost_P, xi)
                + xi @ block_map.cost_q
                + block_map.cost_r
            )
            s_next = s @ block_map.M_T + block_map.c + w @ block_map.N_T
            if emit_trajectories:
                u = (
                    s @ block_map.OuS_T
                    + block_map.ou_c
                    + w @ block_map.OuW_T
                )
                y = (
                    s @ block_map.OyS_T
                    + block_map.oy_c
                    + w @ block_map.OyW_T
                )
                return s_next, (u, y, costs_k)
        return s_next, costs_k

    s_fin, emitted = jax.lax.scan(block, s0, xs)
    s_fin = s_fin + block_map.s_star

    if emit_trajectories:
        u_blocks, y_blocks, cost_blocks = emitted
        u_sys = u_blocks.reshape(-1, m)[:n_steps]
        y_sys = y_blocks.reshape(-1, p)[:n_steps]
    else:
        cost_blocks = emitted
        u_sys = jnp.zeros((0, m), dtype=dtype)
        y_sys = jnp.zeros((0, p), dtype=dtype)

    costs = cost_blocks.reshape(-1)[:n_solves]
    ok = jnp.isfinite(costs)
    return ClosedLoopResult(
        u_sys=u_sys,
        y_sys=y_sys,
        costs=costs,
        converged=ok,
        x_final=s_fin[:ns],
        u_past=s_fin[ns : ns + u_past.size].reshape(u_past.shape),
        y_past=s_fin[ns + u_past.size :].reshape(y_past.shape),
    )


def time_parallel_rollout(
    block_map: AffineBlockMap,
    x0: jax.Array,
    u_past: jax.Array,
    y_past: jax.Array,
    W: jax.Array,
    n_steps: int,
    n_mpc_step: int = 1,
    setpoints: Optional[jax.Array] = None,
) -> ClosedLoopResult:
    """Whole-trajectory rollout in O(log T) depth via associative scan.

    The condensed recursion ``s' = M s + (c + N w_t)`` is an affine map
    per solve block; affine maps compose associatively:
    ``(A2, b2) o (A1, b1) = (A2 A1, A2 b1 + b2)``. A
    ``lax.associative_scan`` over the per-block maps therefore yields
    the state at EVERY solve time in ~log2(T) parallel rounds instead
    of T sequential steps -- the sequential-dependency wall that caps
    per-step MPC solvers (SURVEY.md section 7.4) disappears for the
    condensed engine. This is the latency-optimal path for a single
    scenario: the whole closed-loop trajectory materializes in a few
    microseconds of depth.

    Cost: O(T S^3) FLOPs instead of O(T S^2) -- an S-fold FLOP premium
    (S = 20 for the four-tank benchmark) traded for a T/log2(T)-fold
    depth reduction. Exact same trajectories as the sequential engine
    (tests/test_time_parallel.py).

    ``setpoints``: tracking-map schedule, same contract as
    :func:`linear_closed_loop_rollout` -- the setpoint deltas are just
    more input lanes, so the associative-scan condensation is
    oblivious to them.
    """
    m = u_past.shape[1]
    p = y_past.shape[1]
    dtype = block_map.M_T.dtype
    S, K, nb = _block_meta(block_map, m, p)
    ns = S - u_past.size - y_past.size
    assert nb == n_mpc_step
    steps_per_outer = K * n_mpc_step
    n_solves = math.ceil(n_steps / n_mpc_step)
    n_outer = math.ceil(n_steps / steps_per_outer)
    pad = n_outer * steps_per_outer - n_steps

    DR = _setpoint_deltas(
        block_map, setpoints, n_outer, dtype, "time_parallel_rollout"
    )
    W_pad = jnp.concatenate(
        [
            jnp.concatenate(
                [jnp.asarray(W, dtype=dtype),
                 jnp.zeros((pad, p), dtype=dtype)],
                axis=0,
            ).reshape(n_outer, steps_per_outer * p),
            DR,
        ],
        axis=1,
    )

    s0 = (
        jnp.concatenate(
            [
                jnp.asarray(x0, dtype=dtype).reshape(-1),
                jnp.asarray(u_past, dtype=dtype).reshape(-1),
                jnp.asarray(y_past, dtype=dtype).reshape(-1),
            ]
        )
        - block_map.s_star
    )

    with jax.default_matmul_precision("highest"):
        # Per-block offsets b_t = c + N w_t; transition matrix M is
        # shared, so element t of the scan is the pair (M, b_t).
        b = block_map.c[None, :] + W_pad @ block_map.N_T  # (n_outer, S)
        M_T = block_map.M_T
        A0 = jnp.broadcast_to(M_T[None], (n_outer, S, S))

        def compose(left, right):
            # Row convention: s' = s @ A_T + b. Composing left-then-
            # right: s'' = (s @ Al + bl) @ Ar + br.
            Al, bl = left
            Ar, br = right
            return (
                jnp.einsum("...ij,...jk->...ik", Al, Ar),
                jnp.einsum("...j,...jk->...k", bl, Ar) + br,
            )

        # prefix[t] maps s0 to the state AFTER block t.
        A_pref, b_pref = jax.lax.associative_scan(compose, (A0, b))
        s_after = s0 @ A_pref + b_pref  # (n_outer, S)
        # State BEFORE each block (s0 for t=0, after-block otherwise).
        s_before = jnp.concatenate([s0[None], s_after[:-1]], axis=0)

        # Per-block outputs from the pre-block states + block noise.
        u_blocks = (
            s_before @ block_map.OuS_T
            + block_map.ou_c
            + W_pad @ block_map.OuW_T
        )
        y_blocks = (
            s_before @ block_map.OyS_T
            + block_map.oy_c
            + W_pad @ block_map.OyW_T
        )
        st = (
            s_before @ block_map.OsS_T
            + block_map.os_c
            + W_pad @ block_map.OsW_T
        )
        thetas = st.reshape(n_outer * K, S)[:n_solves, ns:]
        # Joint [theta; dr] per solve (dr shared within an outer block;
        # zero-width for plain maps).
        xi = jnp.concatenate(
            [thetas, jnp.repeat(DR, K, axis=0)[:n_solves]], axis=1
        )
        costs = (
            jnp.einsum("ti,ij,tj->t", xi, block_map.cost_P, xi)
            + xi @ block_map.cost_q
            + block_map.cost_r
        )

    s_fin = s_after[-1] + block_map.s_star
    return ClosedLoopResult(
        u_sys=u_blocks.reshape(-1, m)[:n_steps],
        y_sys=y_blocks.reshape(-1, p)[:n_steps],
        costs=costs,
        converged=jnp.isfinite(costs),
        x_final=s_fin[:ns],
        u_past=s_fin[ns : ns + u_past.size].reshape(u_past.shape),
        y_past=s_fin[ns + u_past.size :].reshape(y_past.shape),
    )


def make_linear_batched_rollout(
    block_map: AffineBlockMap,
    n_steps: int,
    n_mpc_step: int = 1,
    use_rng_noise: bool = False,
    eps_max: float = 0.0,
    emit_trajectories: bool = True,
    precision: str = "highest",
    setpoints: Optional[jax.Array] = None,
):
    """Jitted batched rollout.

    With ``use_rng_noise=False`` (default): call as
    ``run(x0s, u_pasts, y_pasts, Ws)``. With ``use_rng_noise=True``:
    call as ``run(x0s, u_pasts, y_pasts, keys)`` where ``keys`` is a
    ``(B,)`` array of per-scenario PRNG keys; noise is drawn in-scan.

    The batch dimension rides the leading axis of every matmul, so each
    scan iteration is one ``(B, S + K nw)``-by-``(S + K nw, outputs)``
    matmul covering K solves.

    ``setpoints`` (tracking maps): ``(n_r,)`` constant,
    ``(n_outer, n_r)`` shared per-block schedule, or a per-scenario
    ``(B, n_outer, n_r)`` schedule (vmapped with the batch).
    """
    per_scenario_sched = (
        setpoints is not None and jnp.ndim(setpoints) == 3
    )

    def run(x0s, u_pasts, y_pasts, noise):
        def one(x0, up, yp, nz, sp):
            kw = dict(
                n_steps=n_steps, n_mpc_step=n_mpc_step,
                emit_trajectories=emit_trajectories,
                precision=precision, setpoints=sp,
            )
            if use_rng_noise:
                return linear_closed_loop_rollout(
                    block_map, x0, up, yp,
                    noise_key=nz, eps_max=eps_max, **kw,
                )
            return linear_closed_loop_rollout(
                block_map, x0, up, yp, W=nz, **kw,
            )

        if per_scenario_sched:
            return jax.vmap(one)(
                x0s, u_pasts, y_pasts, noise, jnp.asarray(setpoints)
            )
        return jax.vmap(one, in_axes=(0, 0, 0, 0, None))(
            x0s, u_pasts, y_pasts, noise, setpoints
        )

    return jax.jit(run)

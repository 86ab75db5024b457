"""Fused condensed closed-loop rollout (plain JAX, one ``lax.scan``).

Runs the multi-block closed-loop recursion of the condensed linear
engine (control/linear_engine.py) with every per-block product fused
into ONE matmul: per outer block of K solves the scan body computes
``[w | s] @ G + bias`` and slices the column segments
``[s_next | u | y | Z | q-part]``.

1. **Fused operand.** The recursion needs ``s @ Os + w @ Ow`` for four
   output groups. Concatenating ``sw = [w | s]`` once per block and
   stacking the operators row-wise turns every output group into a
   single matmul, and all output groups stack column-wise into one
   operator ``G``: each scan step is one ``(B, nw+S) @ (nw+S, Wtot)``
   GEMM.

2. **In-scan per-solve costs.** Instead of emitting the solve-time
   theta stack (``K * n_theta`` lanes, the widest output by far) and
   evaluating the cost quadratic in a separate pass, the cost
   ``theta^T P theta + q . theta + r`` is factored on the host:
   ``P = L L^T`` (P is PSD -- it is the optimal value of a convex QP),
   ``L`` is folded into the theta operator so the scan computes
   ``Z_k = L^T theta_k`` directly, then ``cost_k = ||Z_k||^2 +
   q . theta_k + r`` via an elementwise square and one segment-sum
   matmul against a constant 0/1 matrix. The scan emits ``(B, K)``
   costs instead of ``(B, K*n_theta)`` thetas.

3. **Mixed-precision cost channel** (``cost_precision="high"``, the
   default). The cost-feature columns (``Z`` + ``q``-part) feed only
   the per-solve cost diagnostic, not the <1e-4 u-deviation budget, so
   they run as an explicit 3-pass bf16 decomposition, while the
   parity-bound columns (state carry, u, y) stay at
   ``Precision.HIGHEST`` -- bit-identical to the all-HIGHEST path. The
   segment sum runs as two bf16 passes that are exact (0/1 matrix).

All column segments of ``G`` are zero-padded to 128-column boundaries
so every slice starts aligned.

The rollout computes the same trajectories as
``linear_closed_loop_rollout`` (asserted in
tests/test_pallas_rollout.py; costs agree to the tolerance of the
factored quadratic form).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from direct_data_driven_mpc_jax.control.linear_engine import AffineBlockMap


def _ceil128(x: int) -> int:
    return ((x + 127) // 128) * 128


def build_theta_operator(block_map: AffineBlockMap, ns: int):
    """Extract the solve-time THETA rows from the full state-stack
    operator (rows are ordered k-major: [x_k; theta_k] per solve)."""
    import numpy as np

    S = block_map.M_T.shape[0]
    K = block_map.os_c.shape[0] // S
    idx = np.concatenate(
        [np.arange(k * S + ns, (k + 1) * S) for k in range(K)]
    )
    OtS_T = block_map.OsS_T[:, idx]
    otc = block_map.os_c[idx]
    OtW_T = block_map.OsW_T[:, idx]
    return OtS_T, otc, OtW_T, K


def suggest_solves_per_block(
    ns: int, n: int, m: int, p: int, n_mpc_step: int = 1,
    n_steps: int | None = None, n_r: int = 0,
) -> int:
    """Largest ``solves_per_block`` whose fused operand ``[w | s]``
    stays within a 128-wide contraction (``K*nb*p + n_r + S <= 128``;
    ``n_r = m + p`` for tracking maps, whose setpoint delta rides the
    input lanes), preferring a K that divides the rollout's outer block
    count evenly (no padded time steps). The rollout is correct for any
    K; this is only the default block shape."""
    S = ns + n * (m + p)
    K = max((128 - S - n_r) // (n_mpc_step * p), 1)
    if n_steps:
        spb = n_mpc_step * p  # noise lanes per solve
        for cand in range(K, 0, -1):
            n_outer = -(-n_steps // (cand * n_mpc_step))
            if n_outer * cand * n_mpc_step == n_steps:
                # accept up to ~6% padded lanes to kill time padding
                if (K - cand) * spb <= 8:
                    return cand
        return K
    return K


def _build_fused_operator(block_map: AffineBlockMap,
                          include_cost: bool = True,
                          cost_rank_rtol: float = 0.0):
    """Host-side (float64) assembly of the fused operator.

    Returns ``(G, bias, Seg, dims)`` where per scan step the rollout
    computes ``out = [w | s] @ G + bias`` and slices the 128-aligned
    column segments ``[s_next | u | y | Z | q-part]``; per-solve costs
    are ``(Z*Z) @ Seg + q-part`` (``r`` is folded into the q-part
    bias). ``Seg[k*n_theta+d, k] = 1`` sums each solve's squared
    factored-cost coordinates.

    ``include_cost=False`` drops the Z / q-part column groups entirely
    (widths [S, Ku, Kp] only) -- the ``cost_mode="post"`` path, where
    per-solve costs are reconstructed afterwards from the emitted
    trajectories (:func:`_make_post_cost_fn`). For large-state configs
    the cost features (``K * n_theta`` columns) dominate the operator.
    """
    import numpy as np

    f64 = np.float64
    M_T = np.asarray(block_map.M_T, f64)
    N_T = np.asarray(block_map.N_T, f64)
    S = M_T.shape[0]
    nw = N_T.shape[0]  # noise lanes (+ n_r setpoint-delta lanes)
    n_r = getattr(block_map, "n_r", 0) or 0
    n_theta = block_map.cost_P.shape[0] - n_r
    ns = S - n_theta
    OtS_T, otc, OtW_T, K = build_theta_operator(block_map, ns)
    OtS_T = np.asarray(OtS_T, f64)
    otc = np.asarray(otc, f64)
    OtW_T = np.asarray(OtW_T, f64)
    Ku = block_map.ou_c.shape[0]
    Kp = block_map.oy_c.shape[0]

    # Cost-feature coordinates per solve: xi_k = [theta_k] for plain
    # maps, xi_k = [theta_k; dr] for tracking maps -- the dr lanes are
    # the LAST n_r rows of the W channel (linear_engine.py).
    nxi = n_theta + n_r
    Kt = K * nxi
    if n_r:
        def expand(Ot, rows):
            Oxi = np.zeros((rows, Kt))
            view = Oxi.reshape(rows, K, nxi)
            view[:, :, :n_theta] = Ot.reshape(rows, K, n_theta)
            return Oxi

        OxiS_T = expand(OtS_T, S)
        OxiW_T = expand(OtW_T, nw)
        OxiW_T.reshape(nw, K, nxi)[nw - n_r :, :, n_theta:] = np.eye(
            n_r
        )[:, None, :]
        xic = np.zeros(Kt)
        xic.reshape(K, nxi)[:, :n_theta] = otc.reshape(K, n_theta)
    else:
        OxiS_T, OxiW_T, xic = OtS_T, OtW_T, otc

    # Factor the PSD cost quadratic form: P = L L^T (clip tiny negative
    # eigenvalues from float rounding). ``cost_rank_rtol > 0``
    # truncates the factor's eigen-tail (relative eigenvalue mass) --
    # exact to that tolerance; for the large-plant config the spectrum
    # drops 8 orders of magnitude after ~half its rank, so rtol=1e-6
    # halves the cost-column width.
    P = np.asarray(block_map.cost_P, f64)
    evals, V = np.linalg.eigh(P)
    if cost_rank_rtol > 0.0:
        keep = evals > cost_rank_rtol * max(float(evals.max()), 1e-300)
        V = V[:, keep]
        evals = evals[keep]
    L = V * np.sqrt(np.clip(evals, 0.0, None))
    rank = L.shape[1]
    Kt = K * rank
    q = np.asarray(block_map.cost_q, f64)
    r = float(block_map.cost_r)

    # Z operator: xi_k -> L^T xi_k, i.e. columns of the xi operator
    # transformed per-solve-block by L.
    def blockwise_L(Ot):  # (rows, K*nxi) -> (rows, Kt)
        rows = Ot.shape[0]
        return (Ot.reshape(rows, K, nxi) @ L).reshape(rows, Kt)

    OzS_T = blockwise_L(OxiS_T)
    OzW_T = blockwise_L(OxiW_T)
    zc = (xic.reshape(K, nxi) @ L).reshape(Kt)

    # Linear cost part per solve: q . xi_k (+ r folded into bias).
    OqS_T = OxiS_T.reshape(S, K, nxi) @ q  # (S, K)
    OqW_T = OxiW_T.reshape(nw, K, nxi) @ q  # (nw, K)
    qc = xic.reshape(K, nxi) @ q + r

    widths = [_ceil128(S), _ceil128(Ku), _ceil128(Kp)]
    if include_cost:
        widths += [_ceil128(Kt), _ceil128(K)]

    def padc(a, w):  # zero-pad columns of (rows, cols) to w
        out = np.zeros((a.shape[0], w))
        out[:, : a.shape[1]] = a
        return out

    def padv(v, w):
        out = np.zeros(w)
        out[: v.shape[0]] = v
        return out

    # Row order [w-rows; s-rows] matches the scan's sw = [w | s].
    segs = [
        (np.concatenate([N_T, M_T], axis=0), np.asarray(block_map.c, f64)),
        (
            np.concatenate(
                [np.asarray(block_map.OuW_T, f64),
                 np.asarray(block_map.OuS_T, f64)], axis=0
            ),
            np.asarray(block_map.ou_c, f64),
        ),
        (
            np.concatenate(
                [np.asarray(block_map.OyW_T, f64),
                 np.asarray(block_map.OyS_T, f64)], axis=0
            ),
            np.asarray(block_map.oy_c, f64),
        ),
    ]
    if include_cost:
        segs += [
            (np.concatenate([OzW_T, OzS_T], axis=0), zc),
            (np.concatenate([OqW_T, OqS_T], axis=0), qc),
        ]
    G = np.concatenate(
        [padc(mat, w) for (mat, _), w in zip(segs, widths)], axis=1
    )
    bias = np.concatenate(
        [padv(vec, w) for (_, vec), w in zip(segs, widths)]
    )
    if include_cost:
        Seg = np.zeros((widths[3], widths[4]))
        for k in range(K):
            Seg[k * rank : (k + 1) * rank, k] = 1.0
    else:
        Seg = np.zeros((0, 0))

    dims = {
        "S": S, "nw": nw, "Ku": Ku, "Kp": Kp, "K": K,
        "n_theta": n_theta, "ns": ns, "widths": widths,
        "include_cost": include_cost,
    }
    return (
        jnp.asarray(G, jnp.float32),
        jnp.asarray(bias, jnp.float32),
        jnp.asarray(Seg, jnp.float32),
        dims,
    )


#: Precision of the COST-FEATURE columns (``Z = L^T theta`` and the
#: linear ``q``-part) of the fused matmul. The parity-bound outputs
#: (state carry, u, y) ALWAYS run at ``Precision.HIGHEST``: the carry's
#: error compounds over the recursion and the u/y columns feed the
#: <1e-4 control-input budget directly (the condensed operator's
#: cancellation makes sum|a||b| >> |result|, so even a one-shot
#: 3-pass u emission misses the budget). The cost channel is a
#: per-solve DIAGNOSTIC, so ``"high"`` runs it as an explicit 3-pass
#: bf16 scheme: ``a @ b ~= a_hi@b_hi + a_hi@b_lo + a_lo@b_hi`` with
#: ``x_hi = bf16(x)``, ``x_lo = bf16(x - x_hi)`` (the dropped
#: ``a_lo@b_lo`` term is O(2^-16) relative). The cost segment sum runs
#: as TWO bf16 passes that are EXACT: the 0/1 matrix ``Seg`` is
#: exactly representable in bf16, so ``zz @ Seg == zz_hi@Seg +
#: zz_lo@Seg`` up to f32 accumulation.
_COST_PRECISIONS = ("highest", "high")


def _check_cost_precision(name: str) -> None:
    if name not in _COST_PRECISIONS:
        raise ValueError(
            f"cost_precision must be one of {sorted(_COST_PRECISIONS)}, "
            f"got {name!r}"
        )


def _bf16_split(x):
    """(hi, lo) bf16 pair with ``hi + lo ~= x`` (error O(2^-18) rel).

    Implemented by BIT-MASKING the low 16 mantissa bits (truncation
    split) instead of the naive ``lo = bf16(x - f32(bf16(x)))``: a
    jitted compiler may simplify the naive subtraction into bf16, and
    ``lo`` then silently becomes EXACTLY ZERO, degrading every "3-pass"
    matmul to single-pass accuracy. The masked ``hi`` is exactly
    bf16-representable and ``x - hi`` is exact in f32, so nothing here
    is foldable.
    """
    xi = jax.lax.bitcast_convert_type(x, jnp.int32)
    hi32 = jax.lax.bitcast_convert_type(
        xi & jnp.int32(-65536), jnp.float32  # 0xFFFF0000
    )
    hi = hi32.astype(jnp.bfloat16)  # exact (low mantissa bits zero)
    lo = (x - hi32).astype(jnp.bfloat16)  # x - hi32 exact in f32
    return hi, lo


def _bf16_split3(x):
    """(hi, mid, lo) bf16 triple with ``hi + mid + lo == x`` (error
    O(2^-24) rel): bit-level ROUND-TO-NEAREST splits (add 0x8000 to
    the raw bits, then mask), the same elision-proof construction as
    :func:`_bf16_split`. Rounding (vs truncation) matters here: with
    truncated chunks the 6-pass product's dropped ml/lm terms are
    O(2^-21) -- measurably below ``Precision.HIGHEST`` over a 400-step
    recursion -- while rounded chunks put them at O(2^-26). Each
    rounded chunk is exactly bf16-representable (the +0x8000 carry
    propagates into the exponent field, never the sign, for finite x)
    and each f32 residual subtraction is exact (Sterbenz)."""
    half = jnp.int32(32768)  # 0x8000
    mask = jnp.int32(-65536)  # 0xFFFF0000
    xi = jax.lax.bitcast_convert_type(x, jnp.int32)
    hi32 = jax.lax.bitcast_convert_type((xi + half) & mask, jnp.float32)
    r = x - hi32
    ri = jax.lax.bitcast_convert_type(r, jnp.int32)
    mid32 = jax.lax.bitcast_convert_type(
        (ri + half) & mask, jnp.float32
    )
    lo = (r - mid32).astype(jnp.bfloat16)
    return hi32.astype(jnp.bfloat16), mid32.astype(jnp.bfloat16), lo


def _stack6(b_f32):
    """Operator-side prep for :func:`_dot6s`: the 6-pass (f32-grade)
    decomposition stacked into ONE contraction
    ``[b_hi; b_mid; b_hi; b_lo; b_mid; b_hi]`` (bf16). Pairs with the
    operand stack ``[a_hi | a_hi | a_mid | a_hi | a_mid | a_lo]`` to
    give the six leading cross terms hh + hm + mh + hl + mm + lh --
    the dropped ml/lm/ll terms are O(2^-32) relative, i.e. the same
    accuracy class as ``Precision.HIGHEST``, in one dot."""
    b_hi, b_mid, b_lo = _bf16_split3(jnp.asarray(b_f32, jnp.float32))
    return jnp.concatenate(
        [b_hi, b_mid, b_hi, b_lo, b_mid, b_hi], axis=0
    )


def _dot6s(a_f32, b6):
    """f32-grade 6-pass decomposition as ONE bf16 dot (see
    :func:`_stack6`)."""
    a_hi, a_mid, a_lo = _bf16_split3(a_f32)
    a6 = jnp.concatenate(
        [a_hi, a_hi, a_mid, a_hi, a_mid, a_lo], axis=1
    )
    return jax.lax.dot_general(
        a6, b6,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def _make_rollout_from_fused(
    fused, n_outer: int, cost_precision: str = "high"
):
    """Scan maker from a prebuilt fused operator (trace-safe: no host
    numpy -- callable from inside an enclosing jit).

    Returns ``run(s0_batch, W_packed) -> (U, Y, C, s_fin)`` with
    ``s0_batch`` of shape ``(B, S)`` (already centered: ``s - s_star``)
    and ``W_packed`` of shape ``(n_outer, B, nw)``. The body of the
    ``lax.scan`` is one batched matmul -- two when
    ``cost_precision="high"`` splits the cost-feature columns out at
    explicit bf16_3x. ``C`` is the per-solve optimal cost, shape
    ``(n_outer, B, K)`` (None without the cost columns).
    """
    G, bias, Seg, dims = fused
    S, Ku, Kp, K = dims["S"], dims["Ku"], dims["Kp"], dims["K"]
    include_cost = dims.get("include_cost", True)
    if include_cost:
        W0, W1, W2, W3, W4 = dims["widths"]
    else:
        W0, W1, W2 = dims["widths"]
        W3 = W4 = 0
    OFF1, OFF2 = W0, W0 + W1
    OFF3, OFF4 = W0 + W1 + W2, W0 + W1 + W2 + W3
    _check_cost_precision(cost_precision)
    split = include_cost and cost_precision != "highest"
    HI = jax.lax.Precision.HIGHEST
    if split:
        G_par = G[:, :OFF3]
        Z_hi, Z_lo = _bf16_split(G[:, OFF3:])
        # The 3 bf16 passes are ONE stacked dot: XLA's algebraic
        # simplifier may merge dots sharing an operand
        # (dot(a,b1)+dot(a,b2) -> dot(a,b1+b2)), and the bf16 sum
        # would round the low term away. Same for the 2-pass segment
        # sum.
        Z3 = jnp.concatenate([Z_hi, Z_hi, Z_lo], axis=0)
        Seg_bf = Seg.astype(jnp.bfloat16)
        Seg2 = jnp.concatenate([Seg_bf, Seg_bf], axis=0)

    def mm1(a, b):  # one native bf16 pass, f32 accumulation
        return jax.lax.dot_general(
            a, b, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )

    def run(s0_batch, W_packed):
        def step(s, w):
            sw = jnp.concatenate([w, s], axis=1)
            if not include_cost:
                out = jnp.matmul(sw, G, precision=HI) + bias
                return out[:, :S], (
                    out[:, OFF1 : OFF1 + Ku],
                    out[:, OFF2 : OFF2 + Kp],
                )
            if split:
                # Parity-bound columns (carry, u, y) at HIGHEST, cost
                # features via bf16_3x as ONE stacked dot (see Z3
                # above), exact 2-pass segment sum.
                out = jnp.matmul(sw, G_par, precision=HI) + bias[:OFF3]
                sw_hi, sw_lo = _bf16_split(sw)
                zq = (
                    mm1(
                        jnp.concatenate([sw_hi, sw_lo, sw_hi], axis=1),
                        Z3,
                    )
                    + bias[OFF3:]
                )
                z = zq[:, :W3]
                zz_hi, zz_lo = _bf16_split(z * z)
                seg_sum = mm1(
                    jnp.concatenate([zz_hi, zz_lo], axis=1), Seg2
                )
                qpart = zq[:, W3 : W3 + W4]
            else:
                out = jnp.matmul(sw, G, precision=HI) + bias
                z = out[:, OFF3 : OFF3 + W3]
                seg_sum = jnp.matmul(z * z, Seg, precision=HI)
                qpart = out[:, OFF4 : OFF4 + W4]
            C = (seg_sum + qpart)[:, :K]
            return out[:, :S], (
                out[:, OFF1 : OFF1 + Ku],
                out[:, OFF2 : OFF2 + Kp],
                C,
            )

        if include_cost:
            s_fin, (U, Y, C) = jax.lax.scan(step, s0_batch, W_packed)
        else:
            s_fin, (U, Y) = jax.lax.scan(step, s0_batch, W_packed)
            C = None
        return U, Y, C, s_fin

    return run


def _make_post_cost_fn(block_map: AffineBlockMap, n_mpc_step: int,
                       rank_rtol: float = 1e-6):
    """Post-pass per-solve cost evaluation for ``cost_mode="post"``.

    Reconstructs each solve's past window theta from the emitted
    trajectories (the initial window prepended to u_sys/y_sys -- the
    trajectory DETERMINES every window) and evaluates the cost
    quadratic as ``||theta @ L||^2 + q.theta + r`` with the PSD factor
    truncated at ``rank_rtol`` relative eigenvalue mass (exact to that
    tolerance; the large-plant config's spectrum drops 8 orders of
    magnitude after ~half its rank, so truncation roughly halves the
    post-pass FLOPs for free). Runs at ``Precision.HIGHEST``.

    Returns ``cost_fn(u_past, y_past, u_sys, y_sys) -> (B, n_solves)``
    for time-leading ``(B, T, m/p)`` trajectories.
    """
    import numpy as np

    if getattr(block_map, "n_r", 0):
        raise NotImplementedError(
            "cost_mode='post' does not support tracking maps yet; use "
            "cost_mode='inkernel' (the dr lanes ride the fused scan)."
        )
    P = np.asarray(block_map.cost_P, np.float64)
    q = jnp.asarray(block_map.cost_q, jnp.float32)
    r = jnp.asarray(block_map.cost_r, jnp.float32)
    evals, V = np.linalg.eigh(0.5 * (P + P.T))
    keep = evals > rank_rtol * max(evals.max(), 1e-300)
    L = (V[:, keep] * np.sqrt(np.clip(evals[keep], 0.0, None)))
    Lf = jnp.asarray(L, jnp.float32)  # (n_theta, rank)
    nb = n_mpc_step

    def cost_fn(u_past, y_past, u_sys, y_sys):
        B, n_hist, m = u_past.shape
        p = y_past.shape[2]
        n_steps = u_sys.shape[1]
        n_solves = -(-n_steps // nb)
        rank = Lf.shape[1]
        # The window quadratic IS a 1-D convolution over time: window
        # offset j of solve k is time index k*nb + j of the
        # past-prepended trajectory, so z_k = sum_j x[k*nb+j] @ L_j --
        # a length-n_hist stride-nb conv with an (n_hist, m+p, rank)
        # kernel; a materialized (B, n_solves, n_theta) window gather
        # would not fit at the large-plant shape. Chunked over batch
        # to bound the (cb, n_solves, rank) transient.
        # Materialization barrier: the trajectories typically arrive
        # as transposed views of the scan outputs; keep that relayout
        # out of the conv's input fusion.
        u_sys, y_sys = jax.lax.optimization_barrier((u_sys, y_sys))
        x = jnp.concatenate([u_past, u_sys], axis=1)
        yf = jnp.concatenate([y_past, y_sys], axis=1)
        x = jnp.concatenate([x, yf], axis=2)  # (B, n_hist+T, m+p)
        # Conv kernel from the window-major rows of [Lf | q]: the
        # linear term rides as ONE extra output channel of the same
        # conv.
        Lq = jnp.concatenate([Lf, q[:, None]], axis=1)
        Ku = Lq[: n_hist * m].reshape(n_hist, m, rank + 1)
        Ky = Lq[n_hist * m :].reshape(n_hist, p, rank + 1)
        Kz = jnp.concatenate([Ku, Ky], axis=1)  # (n_hist, m+p, rank+1)
        # Trim so VALID conv emits exactly n_solves windows.
        t_need = (n_solves - 1) * nb + n_hist
        x = x[:, :t_need]

        cb = B
        while cb > 8 and cb * n_solves * rank * 4 > 1e9:
            cb //= 2
        while B % cb:
            cb -= 1

        def chunk_cost(c):
            xb = jax.lax.dynamic_slice_in_dim(x, c * cb, cb, 0)
            z = jax.lax.conv_general_dilated(
                xb, Kz, window_strides=(nb,), padding="VALID",
                dimension_numbers=("NHC", "HIO", "NHC"),
                precision=jax.lax.Precision.HIGHEST,
            )  # (cb, n_solves, rank + 1)
            return (
                jnp.sum(z[..., :rank] * z[..., :rank], axis=2)
                + z[..., rank]
                + r
            )  # (cb, n_solves)

        if cb == B:
            return chunk_cost(0)
        costs = jax.lax.map(chunk_cost, jnp.arange(B // cb))
        return costs.reshape(B, n_solves)

    return cost_fn


def _center_and_pack(block_map, x0s, u_pasts, y_pasts, Ws, n_outer,
                     steps_per_outer, pad, setpoints=None):
    """Shared input prep: centered initial state stack and the
    (n_outer, B, nw)-packed noise.

    For tracking maps (``block_map.n_r > 0``) a ``setpoints`` schedule
    is required: ``(n_r,)`` constant, ``(n_outer, n_r)`` per-block, or
    ``(B, n_outer, n_r)`` per-scenario-per-block absolute setpoints
    ``[u_s; y_s]``; the centered delta ``dr = r - r_bar`` is appended
    to each block's noise lanes.
    """
    B = x0s.shape[0]
    p = y_pasts.shape[2]
    n_r = getattr(block_map, "n_r", 0) or 0
    s0 = (
        jnp.concatenate(
            [
                x0s.reshape(B, -1),
                u_pasts.reshape(B, -1),
                y_pasts.reshape(B, -1),
            ],
            axis=1,
        ).astype(jnp.float32)
        - block_map.s_star[None, :]
    )
    W_pad = jnp.concatenate(
        [
            Ws.astype(jnp.float32),
            jnp.zeros((B, pad, p), dtype=jnp.float32),
        ],
        axis=1,
    )
    W_packed = W_pad.reshape(B, n_outer, steps_per_outer * p).transpose(
        1, 0, 2
    )
    if n_r == 0:
        if setpoints is not None:
            raise ValueError(
                "`setpoints` requires a tracking block map (build with "
                "tracking_op=... / build_tracking_engine)."
            )
        return s0, W_packed
    if setpoints is None:
        raise ValueError(
            "tracking block map (n_r > 0) requires a `setpoints` "
            "schedule: (n_r,), (n_outer, n_r) or (B, n_outer, n_r)."
        )
    R = jnp.asarray(setpoints, jnp.float32)
    if R.ndim == 1:
        R = jnp.broadcast_to(R[None, None], (n_outer, B, n_r))
    elif R.ndim == 2:
        R = jnp.broadcast_to(R[:, None, :], (n_outer, B, n_r))
    elif R.ndim == 3:
        R = R.transpose(1, 0, 2)
    if R.shape != (n_outer, B, n_r):
        raise ValueError(
            f"setpoints must broadcast to (n_outer={n_outer}, B={B}, "
            f"n_r={n_r}); got {jnp.asarray(setpoints).shape}"
        )
    dr = R - block_map.r_bar[None, None, :]
    return s0, jnp.concatenate([W_packed, dr], axis=2)


def make_fused_batched_rollout(
    block_map: AffineBlockMap,
    n_steps: int,
    n_mpc_step: int = 1,
    cost_precision: str = "high",
    cost_mode: str = "inkernel",
    cost_rank_rtol: float = 0.0,
):
    """Build a trace-safe batched fused rollout.

    Host-side operator assembly happens HERE; the returned
    ``run(x0s, u_pasts, y_pasts, Ws) -> ClosedLoopResult`` contains no
    host numpy and is safe to call inside ``jit``/``shard_map``
    (parallel/mesh.py wraps it per data shard). ``cost_precision``
    ("high" default, "highest" opt-out) sets the matmul precision of
    the per-solve COST channel only (explicit bf16_3x); the state
    carry and the u/y trajectories always run at HIGHEST and are
    bit-identical across the two modes (see the module constant
    ``_COST_PRECISIONS``).

    For tracking maps (``build_tracking_engine``) call the returned
    function as ``run(x0s, u_pasts, y_pasts, Ws, setpoints)`` with a
    per-outer-block setpoint schedule (see :func:`_center_and_pack`);
    the setpoint delta is ~``m+p`` extra input lanes.

    ``cost_mode="inkernel"`` evaluates the per-solve costs inside the
    scan; ``cost_mode="post"`` drops the cost-feature columns from the
    fused operator and reconstructs per-solve costs from the emitted
    trajectories afterwards (:func:`_make_post_cost_fn`): for
    large-state configs the ``K * n_theta`` cost columns dominate the
    operator. Plain (non-tracking) maps only."""
    import math

    from direct_data_driven_mpc_jax.control.loop import ClosedLoopResult

    if cost_mode not in ("inkernel", "post"):
        raise ValueError(
            f"cost_mode must be 'inkernel' or 'post', got {cost_mode!r}"
        )
    include_cost = cost_mode == "inkernel"
    S = block_map.M_T.shape[0]
    n_theta = block_map.cost_P.shape[0] - (
        getattr(block_map, "n_r", 0) or 0
    )
    ns = S - n_theta
    K = block_map.os_c.shape[0] // S
    steps_per_outer = K * n_mpc_step
    n_outer = math.ceil(n_steps / steps_per_outer)
    n_solves = math.ceil(n_steps / n_mpc_step)
    pad = n_outer * steps_per_outer - n_steps
    fused = _build_fused_operator(
        block_map, include_cost=include_cost,
        cost_rank_rtol=cost_rank_rtol,
    )
    post_cost = (
        None if include_cost
        else _make_post_cost_fn(block_map, n_mpc_step)
    )
    rollout = _make_rollout_from_fused(
        fused, n_outer, cost_precision=cost_precision
    )

    def run(x0s, u_pasts, y_pasts, Ws, setpoints=None):
        B = x0s.shape[0]
        m = u_pasts.shape[2]
        p = y_pasts.shape[2]
        s0, W_packed = _center_and_pack(
            block_map, x0s, u_pasts, y_pasts, Ws, n_outer,
            steps_per_outer, pad, setpoints=setpoints,
        )
        U, Y, C, s_fin = rollout(s0, W_packed)
        s_fin = s_fin + block_map.s_star[None, :]

        u_sys = U.transpose(1, 0, 2).reshape(B, -1, m)[:, :n_steps]
        y_sys = Y.transpose(1, 0, 2).reshape(B, -1, p)[:, :n_steps]
        if include_cost:
            costs = C.transpose(1, 0, 2).reshape(B, -1)[:, :n_solves]
        else:
            costs = post_cost(
                jnp.asarray(u_pasts, jnp.float32),
                jnp.asarray(y_pasts, jnp.float32),
                u_sys, y_sys,
            )[:, :n_solves]
        return ClosedLoopResult(
            u_sys=u_sys,
            y_sys=y_sys,
            costs=costs,
            converged=jnp.isfinite(costs),
            x_final=s_fin[:, :ns],
            u_past=s_fin[:, ns : ns + u_pasts.shape[1] * m].reshape(
                u_pasts.shape
            ),
            y_past=s_fin[:, ns + u_pasts.shape[1] * m :].reshape(
                y_pasts.shape
            ),
        )

    return run


def fused_batched_rollout(
    block_map: AffineBlockMap,
    x0s: jax.Array,  # (B, ns)
    u_pasts: jax.Array,  # (B, n, m)
    y_pasts: jax.Array,  # (B, n, p)
    Ws: jax.Array,  # (B, n_steps, p)
    n_steps: int,
    n_mpc_step: int = 1,
    cost_precision: str = "high",
    cost_mode: str = "inkernel",
    setpoints: jax.Array | None = None,
):
    """Convenience wrapper matching ``make_linear_batched_rollout``\'s
    result contract (returns a ClosedLoopResult). ``setpoints``:
    per-block schedule for tracking maps (see :func:`_center_and_pack`).
    ``cost_mode``: see :func:`make_fused_batched_rollout`."""
    return make_fused_batched_rollout(
        block_map, n_steps, n_mpc_step=n_mpc_step,
        cost_precision=cost_precision, cost_mode=cost_mode,
    )(x0s, u_pasts, y_pasts, Ws, setpoints=setpoints)


def make_amortized_fused_run(
    block_map: AffineBlockMap,
    n_steps: int,
    n_mpc_step: int = 1,
    cost_precision: str = "high",
    cost_mode: str = "inkernel",
    cost_rank_rtol: float = 0.0,
    setpoints: jax.Array | None = None,
):
    """Amortized-throughput harness for the fused rollout (same
    contract as ``bench.make_amortized_linear_run``): one jitted call
    runs ``R`` back-to-back rollouts, R a traced fori_loop trip count.
    ``setpoints``: per-block schedule for tracking maps (fixed across
    repetitions; the rolled noise already varies the work).

    Repetition ``i`` rolls the packed noise by ``i`` outer blocks
    (realizations distinct modulo ``n_outer`` -- with R > n_outer the
    rotations cycle, but the fori_loop still executes every rep's full
    device work; nothing is CSE-able because the checksum carries
    across reps) and every repetition's outputs -- applied inputs,
    measured outputs, per-solve costs, final states -- fold into a
    carried checksum so nothing is dead-code-eliminated.

    Returns jitted ``run(x0s, u_pasts, y_pasts, Ws, R) ->
    (checksum, ok)``.
    """
    import math

    S = block_map.M_T.shape[0]
    K = block_map.os_c.shape[0] // S
    steps_per_outer = K * n_mpc_step
    n_outer = math.ceil(n_steps / steps_per_outer)
    pad = n_outer * steps_per_outer - n_steps
    # Host prep happens HERE (outside the jit below): numpy on closure
    # constants inside a traced function would see tracers.
    include_cost = cost_mode == "inkernel"
    fused = _build_fused_operator(
        block_map, include_cost=include_cost,
        cost_rank_rtol=cost_rank_rtol,
    )
    post_cost = (
        None if include_cost
        else _make_post_cost_fn(block_map, n_mpc_step)
    )
    rollout = _make_rollout_from_fused(
        fused, n_outer, cost_precision=cost_precision
    )

    def run(x0s, u_pasts, y_pasts, Ws, R):
        B = x0s.shape[0]
        m = u_pasts.shape[2]
        p = y_pasts.shape[2]
        s0, W_packed = _center_and_pack(
            block_map, x0s, u_pasts, y_pasts, Ws, n_outer,
            steps_per_outer, pad, setpoints=setpoints,
        )

        def one_rep(i, carry):
            checksum, ok = carry
            U, Y, C, s_fin = rollout(s0, jnp.roll(W_packed, i, axis=0))
            if not include_cost:
                # The cost post-pass is part of the timed work (it is
                # part of what a "solve" produces).
                u_sys = U.transpose(1, 0, 2).reshape(B, -1, m)
                y_sys = Y.transpose(1, 0, 2).reshape(B, -1, p)
                C = post_cost(
                    jnp.asarray(u_pasts, jnp.float32),
                    jnp.asarray(y_pasts, jnp.float32),
                    u_sys[:, :n_steps], y_sys[:, :n_steps],
                )[None]
            checksum = (
                checksum
                + jnp.sum(C[-1])
                + jnp.sum(s_fin)
                + jnp.sum(U)
                + jnp.sum(Y)
            )
            ok = ok & jnp.isfinite(checksum)
            return (checksum, ok)

        return jax.lax.fori_loop(
            0, R, one_rep, (jnp.float32(0.0), jnp.bool_(True))
        )

    return jax.jit(run)

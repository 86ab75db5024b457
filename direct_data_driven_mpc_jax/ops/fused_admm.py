"""Fused batched ADMM closed-loop engine (plain JAX, one ``lax.scan``).

The ITERATIVE solver variants -- the CONVEX slack box (reference
direct_data_driven_mpc_controller.py:658-675, paper Remark 3) and the
general input/output box (qp/box.py, beyond the reference) -- get the
fusion treatment of the slack-NONE condensed engine
(ops/fused_rollout.py). The generic ``lax.scan`` engine
(control/loop.py) runs them as one vmapped ``(nbox,) @ (nbox, nbox)``
matvec per ADMM iteration; this engine restructures the whole solve:

1. **Batch-packed iteration matmuls.** The iteration operator is only
   ``nbox x nbox`` (60 x 60 four-tank). Packing ``q = 128 // seg``
   scenarios per row at a fixed ``seg``-lane stride (block-diagonal
   ``q x`` operator) turns the per-scenario matvecs into one
   ``(B/q, 128) @ (128, 128)`` matmul per iteration. The packing is
   exact -- block-diagonal operators never mix slots.
2. **Per-column-group precision.** The warm-started fixed-point
   iterations self-correct, so they run as explicit bf16 passes
   (1-pass early / 3-pass mid / f32-grade polish -- configurable
   ``iters=(n1, n3, n6)``); the plant carry, applied input, and
   measured output stay f32-grade (the <1e-4 parity-bound outputs);
   the per-solve cost channel (factored quadratic
   ``||L^T [theta; t]||^2``) runs at bf16_3x.
3. **One matmul per plant step.** One scan step = one closed-loop
   solve: the ADMM warm start ``(s, w)``, the plant window state, and
   the pre-computed theta-side maps are the scan carry. The plant step
   and the NEXT solve's theta-side maps (``vc``, ``u_theta``,
   ``z_theta``, ``q_theta``) are ONE fused matmul on
   ``[s | u_applied | w_noise]``.
4. **Exact reference-parity semantics.** Same over-relaxed iteration
   as qp/admm.py / qp/box.py, warm-started across solves, residual
   lanes (r_prim, r_dual) emitted per solve; convergence flags instead
   of exceptions. Cold start runs ``cold_iters`` extra iterations
   before the scan so the per-solve count only needs to cover the
   warm-started steady state.

Parity with the generic engine and the independent active-set golden
fixtures is asserted in tests/test_fused_admm.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from direct_data_driven_mpc_jax.ops.lti import LTIParams
from direct_data_driven_mpc_jax.ops.fused_rollout import (
    _bf16_split,
    _bf16_split3,
    _ceil128,
    _dot6s,
    _stack6,
)


def _dot1(a_bf16, b_bf16):
    """One native bf16 pass, f32 accumulation."""
    return jax.lax.dot_general(
        a_bf16, b_bf16,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def _stack3(b_f32):
    """Operator-side prep for :func:`_dot3`: the 3-pass decomposition
    stacked into ONE contraction ``[b_hi; b_hi; b_lo]`` (bf16).

    One stacked dot instead of three summed dots: one dispatch per
    3-pass matmul, and nothing for XLA's algebraic simplifier to merge
    (see the bit-masked split in ops/fused_rollout.py).
    """
    b_hi, b_lo = _bf16_split(jnp.asarray(b_f32, jnp.float32))
    return jnp.concatenate([b_hi, b_hi, b_lo], axis=0)


def _dot3(a_f32, b3):
    """3-pass bf16 decomposition as ONE dot: ``a @ b ~= [a_hi | a_lo |
    a_hi] @ [b_hi; b_hi; b_lo]`` -- same MACs as three passes, one
    dispatch."""
    a_hi, a_lo = _bf16_split(a_f32)
    a3 = jnp.concatenate([a_hi, a_lo, a_hi], axis=1)
    return _dot1(a3, b3)


def _normalize_admm_op(op: dict) -> dict:
    """Accept both qp/admm.py (CONVEX slack) and single-rung qp/box.py
    operator dicts; return a uniform float64 dict."""
    import numpy as np

    out = {}
    if np.asarray(op["V_s"]).ndim == 3:  # box ladder: require one rung
        if op["V_s"].shape[0] != 1:
            raise ValueError(
                "the fused ADMM engine needs a SINGLE-rung operator "
                "(build the box solver with a fixed rho; the adaptive "
                "ladder's per-lane rung indexing does not batch-pack)."
            )
        for k in ("v_c", "V_theta", "V_s", "u_c", "U_theta", "U_s",
                  "cost_P", "cost_q", "cost_r"):
            out[k] = np.asarray(op[k], np.float64)[0]
        out["lo"] = np.asarray(op["lo"], np.float64)
        out["hi"] = np.asarray(op["hi"], np.float64)
        out["u_lo"] = np.asarray(op["u_lo"], np.float64)
        out["u_hi"] = np.asarray(op["u_hi"], np.float64)
        out["rho"] = float(np.asarray(op["rhos"]).ravel()[0])
    else:
        for k in ("v_c", "V_theta", "V_s", "u_c", "U_theta", "U_s",
                  "cost_P", "cost_q", "cost_r"):
            out[k] = np.asarray(op[k], np.float64)
        # Optional setpoint-delta channels (return_setpoint_maps=True).
        for k in ("V_r", "U_r", "cost_P_ext", "cost_q_ext", "r_bar"):
            if k in op:
                out[k] = np.asarray(op[k], np.float64)
        nbox = out["v_c"].shape[0]
        b = float(op["bound"])
        out["lo"] = np.full(nbox, -b)
        out["hi"] = np.full(nbox, b)
        nu = out["u_c"].shape[0]
        out["u_lo"] = np.full(nu, -np.inf)
        out["u_hi"] = np.full(nu, np.inf)
        out["rho"] = float(op["rho"])
    out["alpha"] = float(op["alpha"])
    return out


def _openloop_block_rows(plant: LTIParams, n: int, m: int, p: int,
                         nb: int):
    """Open-loop Algorithm-2 solve block as row operators on the
    homogeneous vector ``[s; 1; u_blk; w_blk]`` (float64 host):
    ``nb`` plant steps with the applied input as an INPUT channel
    (unlike linear_engine.py's closed-loop composition, where u comes
    from the baked gain). Returns ``(SP, OutY)``: the next condensed
    state ``s' = [x'; u_past'; y_past']`` and the measured outputs."""
    import numpy as np

    A = np.asarray(plant.A, np.float64)
    B = np.asarray(plant.B, np.float64)
    C = np.asarray(plant.C, np.float64)
    D = np.asarray(plant.D, np.float64)
    ns = A.shape[0]
    n_theta = n * (m + p)
    S = ns + n_theta
    Dfull = S + 1 + nb * m + nb * p
    X = np.zeros((ns, Dfull))
    X[:, :ns] = np.eye(ns)
    TH = np.zeros((n_theta, Dfull))
    TH[:, ns:S] = np.eye(n_theta)
    out_y = np.zeros((nb * p, Dfull))
    for j in range(nb):
        Uj = np.zeros((m, Dfull))
        Uj[:, S + 1 + j * m : S + 1 + (j + 1) * m] = np.eye(m)
        Wj = np.zeros((p, Dfull))
        off = S + 1 + nb * m + j * p
        Wj[:, off : off + p] = np.eye(p)
        Yj = C @ X + D @ Uj + Wj
        X = A @ X + B @ Uj
        TH = np.concatenate(
            [TH[m : n * m], Uj, TH[n * m + p :], Yj], axis=0
        )
        out_y[j * p : (j + 1) * p] = Yj
    SP = np.concatenate([X, TH], axis=0)
    return SP, out_y


def pick_pack_factor(nbox: int) -> int:
    """Largest q in {4, 2, 1} whose per-slot stride ``128 // q`` still
    holds the ``nbox`` ADMM lanes -- q independent scenarios share one
    128-wide row of the iteration matmul."""
    for q in (4, 2):
        if 128 // q >= nbox:
            return q
    return 1


class FusedADMMDims(NamedTuple):
    ns: int
    n: int
    m: int
    p: int
    nb: int
    S: int
    n_theta: int
    nbox: int
    nxi: int
    q: int
    seg: int
    Wb: int
    Mw: int
    Wz: int
    rho: float
    alpha: float


def build_fused_admm_operator(
    plant: LTIParams,
    admm_op: dict,
    n: int,
    m: int,
    p: int,
    n_mpc_step: int = 1,
    q: Optional[int] = None,
    track: bool = False,
):
    """Host float64 assembly of the fused-engine operators.

    Returns ``(ops, dims)``: ``ops`` is a dict of device arrays (f32 /
    bf16 hi-lo pairs), ``dims`` a :class:`FusedADMMDims`. Layouts:

    - ADMM-lane space (``Wb = q * seg`` lanes): slot j occupies lanes
      ``[j*seg, j*seg + nbox)``; iteration state (s, w), ``vc``, and
      the box bounds live here.
    - Slot-contiguous spaces: the condensed state (``q*S``), applied
      inputs (``q*nb*m``), outputs (``q*nb*p``), and cost features
      (``q*nxi``) pack slot-contiguously (slot j at ``j*width``).

    ``track=True`` (requires an ``admm_op`` built with
    ``return_setpoint_maps=True``): the cost-feature space extends to
    ``[theta; t; dr]`` (``nxi += m + p``) so a per-block setpoint
    delta enters the scan as three ADDITIVE channels on the carried
    maps -- ``vc += V_r dr``, ``pre += [U_r dr | q_dr . dr]``,
    ``zth += Lc_dr' dr`` -- computed once per schedule on the host;
    the iteration operator ``V_s`` is setpoint-independent.
    """
    import numpy as np

    op = _normalize_admm_op(admm_op)
    ns = np.asarray(plant.A).shape[0]
    nb = n_mpc_step
    n_theta = n * (m + p)
    S = ns + n_theta
    nbox = op["v_c"].shape[0]
    mp = m + p
    nxi = n_theta + nbox + (mp if track else 0)
    if op["V_theta"].shape[1] != n_theta:
        raise ValueError(
            f"operator theta width {op['V_theta'].shape[1]} != "
            f"n*(m+p) = {n_theta}"
        )
    if nb * m > op["u_c"].shape[0]:
        raise ValueError(
            f"n_mpc_step ({nb}) exceeds the optimized horizon."
        )
    if track and "V_r" not in op:
        raise ValueError(
            "setpoint tracking needs the dr channels: build the "
            "operator with compute_admm_operator_np("
            "return_setpoint_maps=True)."
        )
    if q is None:
        q = pick_pack_factor(nbox)
    seg = (128 // q) if q > 1 else max(_ceil128(nbox), 128)
    if q * seg < q * nbox:
        raise ValueError(f"pack factor q={q} does not fit nbox={nbox}")
    Wb = q * seg
    Mw = q * nb * m + q
    Wz = q * nxi

    f64 = np.float64
    V_theta, V_s, v_c = op["V_theta"], op["V_s"], op["v_c"]
    U_theta, U_s, u_c = op["U_theta"], op["U_s"], op["u_c"]
    if track:
        cost_P, cost_q = op["cost_P_ext"], op["cost_q_ext"]
    else:
        cost_P, cost_q = op["cost_P"], op["cost_q"]
    cost_r = op["cost_r"]
    # PSD factor of the joint cost quadratic: P = Lc Lc^T.
    evals, V = np.linalg.eigh(0.5 * (cost_P + cost_P.T))
    Lc = V * np.sqrt(np.clip(evals, 0.0, None))  # (nxi, nxi)
    Lc_th = Lc[:n_theta]  # theta rows
    Lc_t = Lc[n_theta : n_theta + nbox]  # t rows
    q_th = cost_q[:n_theta]
    q_t = cost_q[n_theta : n_theta + nbox]

    # --- theta-side maps shared by G_pre (t=0) and M2 (in-scan
    # next-solve): given affine theta rows (n_theta, Din) + theta bias.
    def theta_blocks(Trows, t_bias):
        Din = Trows.shape[1]
        uth = U_theta[: nb * m] @ Trows  # (nb*m, Din)
        uth_b = u_c[: nb * m] + U_theta[: nb * m] @ t_bias
        qth = q_th @ Trows  # (Din,)
        qth_b = float(q_th @ t_bias + cost_r)
        vc = V_theta @ Trows  # (nbox, Din)
        vc_b = v_c + V_theta @ t_bias
        zth = Lc_th.T @ Trows  # (nxi, Din)
        zth_b = Lc_th.T @ t_bias
        return (uth, uth_b), (qth, qth_b), (vc, vc_b), (zth, zth_b)

    # --- G_pre: s-packed (q*S) -> [pre misc (Mw) | vc (Wb) | zth (Wz)]
    TH0 = np.zeros((n_theta, S))
    TH0[:, ns:] = np.eye(n_theta)
    (uth0, uth0_b), (qth0, qth0_b), (vc0, vc0_b), (zth0, zth0_b) = (
        theta_blocks(TH0, np.zeros(n_theta))
    )
    Gpre = np.zeros((q * S, Mw + Wb + Wz))
    bpre = np.zeros(Mw + Wb + Wz)
    for j in range(q):
        r = slice(j * S, (j + 1) * S)
        Gpre[r, j * nb * m : (j + 1) * nb * m] = uth0.T
        Gpre[r, q * nb * m + j] = qth0
        Gpre[r, Mw + j * seg : Mw + j * seg + nbox] = vc0.T
        Gpre[r, Mw + Wb + j * nxi : Mw + Wb + (j + 1) * nxi] = zth0.T
        bpre[j * nb * m : (j + 1) * nb * m] = uth0_b
        bpre[q * nb * m + j] = qth0_b
        bpre[Mw + j * seg : Mw + j * seg + nbox] = vc0_b
        bpre[Mw + Wb + j * nxi : Mw + Wb + (j + 1) * nxi] = zth0_b

    # --- V_op: ADMM-lane iteration operator, block-diagonal q x V_s^T.
    Vop = np.zeros((Wb, Wb))
    for j in range(q):
        r = slice(j * seg, j * seg + nbox)
        Vop[r, r] = V_s.T
    lo_vec = np.zeros(Wb)
    hi_vec = np.zeros(Wb)
    for j in range(q):
        lo_vec[j * seg : j * seg + nbox] = op["lo"]
        hi_vec[j * seg : j * seg + nbox] = op["hi"]

    # --- M1: t (ADMM lanes, Wb) -> [u_add + qt (Mw) | z_t (Wz)],
    # all at bf16_3x (t is the slack/box contribution; the golden
    # parity tests bound its error).
    M1 = np.zeros((Wb, Mw + Wz))
    for j in range(q):
        r = slice(j * seg, j * seg + nbox)
        M1[r, j * nb * m : (j + 1) * nb * m] = U_s[: nb * m].T
        M1[r, q * nb * m + j] = q_t
        M1[r, Mw + j * nxi : Mw + (j + 1) * nxi] = Lc_t

    # --- M2: [s (q*S) | u_app (q*nb*m) | w (q*nb*p)] ->
    #   HIGHEST:  [s_next (q*S) | uth' (q*nb*m) | y (q*nb*p) | qth' (q)]
    #   bf16_3x:  [vc' (Wb) | zth' (Wz)]
    SP, OutY = _openloop_block_rows(plant, n, m, p, nb)
    th_rows = SP[ns:]  # theta after the block, rows on [s;1;u;w]
    (uthn, uthn_b0), (qthn, qthn_b0), (vcn, vcn_b0), (zthn, zthn_b0) = (
        theta_blocks(th_rows[:, : th_rows.shape[1]],
                     np.zeros(n_theta))
    )
    Din2 = q * (S + nb * m + nb * p)
    Whi = q * S + q * nb * m + q * nb * p + q
    OFF_UTH = q * S
    OFF_Y = OFF_UTH + q * nb * m
    OFF_QTH = OFF_Y + q * nb * p
    M2_hi = np.zeros((Din2, Whi))
    b2_hi = np.zeros(Whi)
    M2_lo = np.zeros((Din2, Wb + Wz))
    b2_lo = np.zeros(Wb + Wz)

    def scatter(rows, bias_extra=0.0):
        """Split affine rows on [s;1;u;w] into per-slot input-lane
        columns (Din2) + bias."""
        k = rows.shape[0]
        cols = np.zeros((Din2, q * k))
        bias = np.zeros(q * k)
        st = rows[:, :S]
        one = rows[:, S]
        uu = rows[:, S + 1 : S + 1 + nb * m]
        ww = rows[:, S + 1 + nb * m :]
        for j in range(q):
            c = slice(j * k, (j + 1) * k)
            cols[j * S : (j + 1) * S, c] = st.T
            off_u = q * S + j * nb * m
            cols[off_u : off_u + nb * m, c] = uu.T
            off_w = q * S + q * nb * m + j * nb * p
            cols[off_w : off_w + nb * p, c] = ww.T
            bias[c] = one + bias_extra
        return cols, bias

    # theta-affine helper: derived rows R @ th_rows are themselves rows
    # on [s;1;u;w]; constant vectors add to the ONE channel.
    def derived(mat, const):
        rows = mat @ th_rows
        rows = rows.copy()
        rows[:, S] += const
        return rows

    c_, b_ = scatter(SP)
    M2_hi[:, : q * S] = c_
    b2_hi[: q * S] = b_
    c_, b_ = scatter(derived(U_theta[: nb * m], u_c[: nb * m]))
    M2_hi[:, OFF_UTH : OFF_UTH + q * nb * m] = c_
    b2_hi[OFF_UTH : OFF_UTH + q * nb * m] = b_
    c_, b_ = scatter(OutY)
    M2_hi[:, OFF_Y : OFF_Y + q * nb * p] = c_
    b2_hi[OFF_Y : OFF_Y + q * nb * p] = b_
    c_, b_ = scatter(derived(q_th[None, :], np.array([float(cost_r)])))
    M2_hi[:, OFF_QTH:] = c_
    b2_hi[OFF_QTH:] = b_

    vcn_rows = derived(V_theta, v_c)
    zthn_rows = derived(Lc_th.T, np.zeros(nxi))
    c_, b_ = scatter(vcn_rows)
    bz_c, bz_b = scatter(zthn_rows)
    # vc lives in ADMM-lane layout: re-scatter the per-slot (nbox)
    # column groups to the seg-strided offsets.
    for j in range(q):
        src = slice(j * nbox, (j + 1) * nbox)
        dst = slice(j * seg, j * seg + nbox)
        M2_lo[:, dst] = c_[:, src]
        b2_lo[dst] = b_[src]
    M2_lo[:, Wb:] = bz_c
    b2_lo[Wb:] = bz_b

    # u clip bounds in applied-input layout (q*nb*m slot-contiguous).
    u_lo_out = np.tile(op["u_lo"][: nb * m], q)
    u_hi_out = np.tile(op["u_hi"][: nb * m], q)

    # Cost segment-sum: (Wz, q) 0/1 (exact in bf16).
    Seg = np.zeros((Wz, q))
    for j in range(q):
        Seg[j * nxi : (j + 1) * nxi, j] = 1.0

    dims = FusedADMMDims(
        ns=ns, n=n, m=m, p=p, nb=nb, S=S, n_theta=n_theta, nbox=nbox,
        nxi=nxi, q=q, seg=seg, Wb=Wb, Mw=Mw, Wz=Wz,
        rho=float(op["rho"]), alpha=float(op["alpha"]),
    )

    Seg_bf = jnp.asarray(Seg, jnp.bfloat16)
    ops = {
        "Gpre": jnp.asarray(Gpre, jnp.float32),
        "bpre": jnp.asarray(bpre, jnp.float32),
        "Vop_1": jnp.asarray(Vop, jnp.float32).astype(jnp.bfloat16),
        "Vop_3": _stack3(Vop),
        "Vop_6": _stack6(jnp.asarray(Vop, jnp.float32)),
        "lo_vec": jnp.asarray(lo_vec, jnp.float32),
        "hi_vec": jnp.asarray(hi_vec, jnp.float32),
        "M1_3": _stack3(M1),
        # Round 5: ONE merged plant/theta matmul. The HIGHEST columns
        # (s_next, u, y, qth) and the 3-pass columns (vc', zth') were
        # two dots on the same operand; the explicit 6-pass stack
        # expresses BOTH at f32-grade accuracy in a single dispatch
        # with a dense 6x-stacked contraction (fewer padded MACs than
        # the two separate dots -- see _stack6).
        "M2_6": _stack6(
            jnp.concatenate(
                [jnp.asarray(M2_hi, jnp.float32),
                 jnp.asarray(M2_lo, jnp.float32)], axis=1
            )
        ),
        "b2": jnp.concatenate(
            [jnp.asarray(b2_hi, jnp.float32),
             jnp.asarray(b2_lo, jnp.float32)]
        ),
        "u_lo_out": jnp.asarray(u_lo_out, jnp.float32),
        "u_hi_out": jnp.asarray(u_hi_out, jnp.float32),
        # 2-pass exact segment sum, same stacked-dot trick (the 0/1
        # matrix is exact in bf16).
        "Seg_2": jnp.concatenate([Seg_bf, Seg_bf], axis=0),
    }
    if track:
        # Host f64 dr-channel maps for compute_setpoint_adds (never
        # enter the scan; the adds they produce do).
        ops["_track"] = {
            "V_r": np.asarray(op["V_r"], f64),
            "U_r_nb": np.asarray(op["U_r"], f64)[: nb * m],
            "q_dr": np.asarray(cost_q[n_theta + nbox :], f64),
            "Lc_dr": np.asarray(Lc[n_theta + nbox :], f64),
            "r_bar": np.asarray(op["r_bar"], f64),
        }
    return ops, dims


def compute_setpoint_adds(ops, dims: FusedADMMDims, setpoints):
    """Per-block additive channels for a setpoint schedule (host f64
    -> device f32): row t is ``[pre_add (Mw) | vc_add (Wb) | zth_add
    (Wz)]`` for ``dr_t = r_t - r_bar``. The cross and pure dr terms of
    the cost ride the EXTENDED z features (``zth_add = Lc_dr' dr``)
    plus one scalar (``q_dr . dr``), so the in-scan cost stays the
    same factored quadratic."""
    import numpy as np

    tk = ops["_track"]
    q, seg, nbox, nxi = dims.q, dims.seg, dims.nbox, dims.nxi
    nb, m = dims.nb, dims.m
    Mw, Wb, Wz = dims.Mw, dims.Wb, dims.Wz
    sp = np.asarray(setpoints, np.float64)
    if sp.ndim == 1:
        sp = sp[None]
    dr = sp - tk["r_bar"]
    n_sp = dr.shape[0]
    u_add = dr @ tk["U_r_nb"].T  # (n_sp, nb*m)
    q_add = dr @ tk["q_dr"]  # (n_sp,)
    vc_add = dr @ tk["V_r"].T  # (n_sp, nbox)
    z_add = dr @ tk["Lc_dr"]  # (n_sp, nxi)
    adds = np.zeros((n_sp, Mw + Wb + Wz))
    for j in range(q):
        adds[:, j * nb * m : (j + 1) * nb * m] = u_add
        adds[:, q * nb * m + j] = q_add
        adds[:, Mw + j * seg : Mw + j * seg + nbox] = vc_add
        adds[:, Mw + Wb + j * nxi : Mw + Wb + (j + 1) * nxi] = z_add
    return jnp.asarray(adds, jnp.float32)


def _make_block_math(ops, dims: FusedADMMDims, iters: Tuple[int, int, int],
                     pipeline: int = 1):
    """Pure-jnp math of ONE solve block: ADMM iterations + extraction
    + plant step + next-solve theta maps (the scan body of the fused
    engine and of the ladder engine).

    ``pipeline``: split the block's rows into this many INDEPENDENT
    chains inside the iteration loop. Each chain's elementwise update
    (relax + clip + dual) serializes against its own matmul, but the
    chains have no cross dependencies, so a scheduler may overlap one
    chain's matmul with another's update. Row slicing does not change
    any row's math, but the backend may pick a different gemm
    accumulation order per shape (measured ~2e-9 drift on CPU), so
    cross-pipeline results agree to the parity budget rather than
    bitwise."""
    part1 = _make_iter_extract(ops, dims, iters, pipeline)
    part2 = _make_plant_step(ops, dims)
    Mw, Wb = dims.Mw, dims.Wb

    def block_math(s_flat, pre, vc, zth, sa, wa, w_tile, adds=None):
        if adds is not None:
            # Setpoint-delta channels: per-block additive adjustments
            # to the carried theta-side maps (broadcast over rows).
            pre = pre + adds[:Mw]
            vc = vc + adds[Mw : Mw + Wb]
            zth = zth + adds[Mw + Wb :]
        s, w, u_app, cost, rp, rd = part1(pre, vc, zth, sa, wa)
        s_next, y, new_pre, new_vc, new_zth = part2(
            s_flat, u_app, w_tile
        )
        # Single TRANSPOSED output tile (out_w, rows): the stacked
        # (n_blocks, out_w, Bq) buffer keeps the batch as its minor,
        # widest dimension.
        out_t = jnp.concatenate([u_app, y, cost, rp, rd], axis=1).T
        return (out_t, s_next, new_pre, new_vc, new_zth, s, w)

    return block_math


def _make_iter_extract(ops, dims: FusedADMMDims, iters, pipeline: int):
    """ADMM iterations + extraction (M1, cost, residual lanes) of one
    solve block. ``ops`` may carry a traced ``"rho"`` (the ladder's
    selected rung) overriding the static ``dims.rho``."""
    q, seg, nbox = dims.q, dims.seg, dims.nbox
    Mw, Wb = dims.Mw, dims.Wb
    alpha = dims.alpha
    rho = ops.get("rho", dims.rho)
    qnbm = q * dims.nb * dims.m
    n1, n3, n6 = iters

    lo_vec, hi_vec = ops["lo_vec"], ops["hi_vec"]

    def iter_extract(pre, vc, zth, sa, wa):
        rows = sa.shape[0]
        if rows % pipeline:
            raise ValueError(
                f"pipeline={pipeline} must divide the engine's row "
                f"count {rows} (the packed batch B / q)."
            )
        n_chain = pipeline
        rb = rows // n_chain

        def iter_body(prec):
            def body(_, carry):
                new = []
                # One tuple entry per chain; the chains' dots/updates
                # are mutually independent within a single loop body.
                for j, (s, w, _, _) in enumerate(carry):
                    d = s - w
                    if prec == 1:
                        v = _dot1(d.astype(jnp.bfloat16), ops["Vop_1"])
                    elif prec == 3:
                        v = _dot3(d, ops["Vop_3"])
                    else:
                        # f32-grade polish as ONE stacked bf16 dot.
                        v = _dot6s(d, ops["Vop_6"])
                    v = v + vc[j * rb : (j + 1) * rb]
                    vh = alpha * v + (1.0 - alpha) * s
                    s_new = jnp.clip(vh + w, lo_vec, hi_vec)
                    w_new = w + vh - s_new
                    # Residual inputs (v, s_prev) are CARRIED, not
                    # reduced: the |.| and per-slot maxes run once
                    # after the loop instead of every iteration.
                    new.append((s_new, w_new, v, s))
                return tuple(new)
            return body

        carry = tuple(
            (
                sa[j * rb : (j + 1) * rb],
                wa[j * rb : (j + 1) * rb],
                jnp.zeros((rb, Wb), sa.dtype),
                jnp.zeros((rb, Wb), sa.dtype),
            )
            for j in range(n_chain)
        )
        for prec, cnt in ((1, n1), (3, n3), (6, n6)):
            if cnt:
                carry = jax.lax.fori_loop(
                    0, cnt, iter_body(prec), carry
                )
        s = jnp.concatenate([c[0] for c in carry], axis=0)
        w = jnp.concatenate([c[1] for c in carry], axis=0)
        v_last = jnp.concatenate([c[2] for c in carry], axis=0)
        s_prev = jnp.concatenate([c[3] for c in carry], axis=0)
        rpv = jnp.abs(v_last - s)
        rdv = jnp.abs(s - s_prev)
        t_vec = s - w
        m1 = _dot3(t_vec, ops["M1_3"])
        u_raw = pre[:, :qnbm] + m1[:, :qnbm]
        u_app = jnp.clip(u_raw, ops["u_lo_out"], ops["u_hi_out"])
        qlin = pre[:, qnbm:Mw] + m1[:, qnbm:Mw]
        z = zth + m1[:, Mw:]
        zz_hi, zz_lo = _bf16_split(z * z)
        cost = (
            _dot1(
                jnp.concatenate([zz_hi, zz_lo], axis=1), ops["Seg_2"]
            )
            + qlin
        )
        rp = jnp.concatenate(
            [
                jnp.max(
                    rpv[:, j * seg : j * seg + nbox], axis=1,
                    keepdims=True,
                )
                for j in range(q)
            ],
            axis=1,
        )
        rd = rho * jnp.concatenate(
            [
                jnp.max(
                    rdv[:, j * seg : j * seg + nbox], axis=1,
                    keepdims=True,
                )
                for j in range(q)
            ],
            axis=1,
        )
        return s, w, u_app, cost, rp, rd

    return iter_extract


def _make_plant_step(ops, dims: FusedADMMDims):
    """The fused plant-step + next-solve theta-map matmul (M2)."""
    q, S = dims.q, dims.S
    qnbm = q * dims.nb * dims.m
    qnbp = q * dims.nb * dims.p
    OFF_UTH = q * S
    OFF_Y = OFF_UTH + qnbm
    OFF_QTH = OFF_Y + qnbp
    Whi = OFF_QTH + q
    Wb = dims.Wb

    def plant_step(s_flat, u_app, w_tile):
        in2 = jnp.concatenate([s_flat, u_app, w_tile], axis=1)
        hilo = _dot6s(in2, ops["M2_6"]) + ops["b2"]
        s_next = hilo[:, : q * S]
        y = hilo[:, OFF_Y : OFF_Y + qnbp]
        new_pre = jnp.concatenate(
            [hilo[:, OFF_UTH : OFF_UTH + qnbm],
             hilo[:, OFF_QTH:Whi]], axis=1
        )
        new_vc = hilo[:, Whi : Whi + Wb]
        new_zth = hilo[:, Whi + Wb :]
        return s_next, y, new_pre, new_vc, new_zth

    return plant_step


def _make_admm_scan(ops, dims: FusedADMMDims, iters, pipeline: int = 1):
    """The fused engine's ``lax.scan`` over solve blocks: one
    :func:`_make_block_math` step per solve. ``adds`` (tracking only)
    is the per-block setpoint-channel array, scanned with the noise."""
    block_math = _make_block_math(ops, dims, iters, pipeline=pipeline)

    def run(s0p, pre0, vc0, zth0, sa0, wa0, W_packed, adds=None):
        def step(carry, xs):
            w_tile_t, adds_t = xs
            s_flat, pre, vc, zth, sa, wa = carry
            (out_t, s_next, new_pre, new_vc, new_zth, s, w) = (
                block_math(s_flat, pre, vc, zth, sa, wa, w_tile_t.T,
                           adds=adds_t)
            )
            return (s_next, new_pre, new_vc, new_zth, s, w), out_t

        carry0 = (s0p, pre0, vc0, zth0, sa0, wa0)
        (s_fin, _, _, _, sa_fin, wa_fin), OUT = jax.lax.scan(
            step, carry0, (W_packed, adds)
        )
        return OUT, s_fin, sa_fin, wa_fin

    return run


def make_fused_admm_rollout(
    plant: LTIParams,
    admm_op: dict,
    n: int,
    m: int,
    p: int,
    n_steps: int,
    n_mpc_step: int = 1,
    iters: Tuple[int, int, int] = (0, 10, 2),
    cold_iters: int = 24,
    q: Optional[int] = None,
    tol: float = 1e-5,
    pipeline: int = 1,
    setpoints=None,
):
    """Build the fused batched ADMM closed-loop rollout.

    Args:
        plant: LTI plant matrices (simulated true system).
        admm_op: float64 operator dict from
            ``compute_admm_operator_np`` (CONVEX slack) or a
            single-rung ``compute_box_admm_operator_np`` (fixed rho).
        n, m, p: controller model order / input / output dims.
        n_steps: closed-loop length.
        n_mpc_step: plant steps per solve (Algorithm 2).
        iters: per-solve iteration schedule
            ``(bf16_1x, bf16_3x, f32-grade)`` -- the warm-started
            steady-state budget; convergence is REPORTED per solve
            (residual lanes), not assumed.
        cold_iters: extra bf16_3x iterations before the scan when no
            warm-start state is given (covers the cold start so the
            per-solve count stays steady-state sized).
        q: scenario pack factor (default: auto, fills a 128-wide
            row).
        tol: residual tolerance for the emitted ``converged`` lanes.
        pipeline: independent row chains inside the iteration loop
            (see :func:`_make_block_math`).
        setpoints: optional setpoint schedule for full-speed
            retargeting (requires ``admm_op`` built with
            ``return_setpoint_maps=True``): absolute ``[u_s; y_s]``
            rows, shape ``(n_blocks, m+p)`` (one per solve block) or
            ``(m+p,)`` (constant). Enters the scan as per-block
            ADDITIVE channels on the carried theta-side maps; the
            ADMM state warm-starts ACROSS setpoint changes (the
            residual lanes report any retarget transient honestly).
            The reference retargets only by re-running its whole init
            pipeline (direct_data_driven_mpc_controller.py:945-982).

    Returns ``run(x0s, u_pasts, y_pasts, Ws, solver_state0=None) ->
    ClosedLoopResult`` (jit-safe; pass ``solver_state0=(s, w)`` with
    shapes ``(B, nbox)`` to warm-start, e.g. segmented runs).
    """
    from direct_data_driven_mpc_jax.control.loop import ClosedLoopResult
    from direct_data_driven_mpc_jax.qp.admm import ADMMState

    track = setpoints is not None
    ops, dims = build_fused_admm_operator(
        plant, admm_op, n, m, p, n_mpc_step=n_mpc_step, q=q,
        track=track,
    )
    nb = dims.nb
    n_blocks = math.ceil(n_steps / nb)
    pad = n_blocks * nb - n_steps
    qq, seg, nbox = dims.q, dims.seg, dims.nbox
    S, ns = dims.S, dims.ns

    if track:
        import numpy as np

        sp = np.asarray(setpoints, np.float64)
        if sp.ndim == 1:
            sp = np.tile(sp[None], (n_blocks, 1))
        if sp.shape != (n_blocks, m + p):
            raise ValueError(
                f"setpoints shape {sp.shape} != ({n_blocks}, {m + p}) "
                f"(one [u_s; y_s] row per solve block)"
            )
        adds = compute_setpoint_adds(ops, dims, sp)
    else:
        adds = None

    engine = _make_admm_scan(ops, dims, iters, pipeline=pipeline)

    def run(x0s, u_pasts, y_pasts, Ws, solver_state0=None):
        B = x0s.shape[0]
        if B % qq:
            raise ValueError(f"B={B} must be a multiple of q={qq}")
        Bq = B // qq
        f32 = jnp.float32
        s0 = jnp.concatenate(
            [
                jnp.asarray(x0s, f32).reshape(B, -1),
                jnp.asarray(u_pasts, f32).reshape(B, -1),
                jnp.asarray(y_pasts, f32).reshape(B, -1),
            ],
            axis=1,
        )
        s0p = s0.reshape(Bq, qq * S)
        # theta-side maps for solve 0 (one batched matmul, HIGHEST).
        pre_all = (
            jnp.matmul(s0p, ops["Gpre"],
                       precision=jax.lax.Precision.HIGHEST)
            + ops["bpre"]
        )
        pre0 = pre_all[:, : dims.Mw]
        vc0 = pre_all[:, dims.Mw : dims.Mw + dims.Wb]
        zth0 = pre_all[:, dims.Mw + dims.Wb :]

        def pack_admm(x):
            x = jnp.asarray(x, f32)
            padl = jnp.zeros((B, seg - nbox), f32)
            return jnp.concatenate([x, padl], axis=1).reshape(
                Bq, qq * seg
            )

        # Cold start / solve-0 maps honor the first block's setpoint
        # (the engine re-applies the add per block, so vc0 passes
        # through unmodified).
        vc0_eff = (
            vc0 + adds[0, dims.Mw : dims.Mw + dims.Wb] if track
            else vc0
        )
        if solver_state0 is None:
            sa0 = jnp.zeros((Bq, dims.Wb), f32)
            wa0 = jnp.zeros((Bq, dims.Wb), f32)
            if cold_iters:
                # Cold start before the scan: same packed iteration
                # at bf16_3x.
                alpha = dims.alpha

                def cold_body(_, carry):
                    s, w = carry
                    d = s - w
                    v = vc0_eff + _dot3(d, ops["Vop_3"])
                    vh = alpha * v + (1.0 - alpha) * s
                    s_new = jnp.clip(
                        vh + w, ops["lo_vec"], ops["hi_vec"]
                    )
                    return (s_new, w + vh - s_new)

                sa0, wa0 = jax.lax.fori_loop(
                    0, cold_iters, cold_body, (sa0, wa0)
                )
        else:
            sa0 = pack_admm(solver_state0[0])
            wa0 = pack_admm(solver_state0[1])

        W_pad = jnp.concatenate(
            [
                jnp.asarray(Ws, f32),
                jnp.zeros((B, pad, dims.p), f32),
            ],
            axis=1,
        )  # (B, n_blocks*nb, p)
        # Batch-minor layout (n_blocks, q*nb*p, Bq), matching the
        # transposed output tile of _make_block_math.
        W_packed = (
            W_pad.reshape(Bq, qq, n_blocks, nb * dims.p)
            .transpose(2, 1, 3, 0)
            .reshape(n_blocks, qq * nb * dims.p, Bq)
        )

        OUT, s_fin, sa_fin, wa_fin = engine(
            s0p, pre0, vc0, zth0, sa0, wa0, W_packed, adds
        )
        qnbm = qq * nb * dims.m
        qnbp = qq * nb * dims.p

        def unpack_t(x, width):  # (n_blocks, q*width, Bq) -> (B, T, w)
            return (
                x.reshape(n_blocks, qq, width, Bq)
                .transpose(3, 1, 0, 2)
                .reshape(B, n_blocks, width)
            )

        u_sys = unpack_t(OUT[:, :qnbm], nb * dims.m).reshape(
            B, -1, dims.m
        )[:, :n_steps]
        y_sys = unpack_t(
            OUT[:, qnbm : qnbm + qnbp], nb * dims.p
        ).reshape(B, -1, dims.p)[:, :n_steps]

        def unpack_scalar(x):  # (n_blocks, q, Bq) -> (B, n_blocks)
            return x.transpose(2, 1, 0).reshape(B, n_blocks)

        off = qnbm + qnbp
        costs = unpack_scalar(OUT[:, off : off + qq])
        rp = unpack_scalar(OUT[:, off + qq : off + 2 * qq])
        rd = unpack_scalar(OUT[:, off + 2 * qq :])
        converged = (rp <= tol) & (rd <= tol)
        s_fin_b = s_fin.reshape(B, S)
        sa_b = sa_fin.reshape(B, seg)[:, :nbox]
        wa_b = wa_fin.reshape(B, seg)[:, :nbox]
        return ClosedLoopResult(
            u_sys=u_sys,
            y_sys=y_sys,
            costs=costs,
            converged=converged,
            x_final=s_fin_b[:, :ns],
            u_past=s_fin_b[:, ns : ns + dims.n * dims.m].reshape(
                B, dims.n, dims.m
            ),
            y_past=s_fin_b[:, ns + dims.n * dims.m :].reshape(
                B, dims.n, dims.p
            ),
            solver_state=ADMMState(s=sa_b, w=wa_b),
        )

    return run


# ---------------------------------------------------------------------------
# Adaptive penalty-ladder fused engine (round 5)
# ---------------------------------------------------------------------------

_LADDER_STACKED = ("Vop_1", "Vop_3", "Vop_6", "M1_3", "M2_6", "b2")


def build_fused_ladder_operator(
    plant: LTIParams,
    ladder_op: dict,
    n: int,
    m: int,
    p: int,
    n_mpc_step: int = 1,
    q: Optional[int] = None,
):
    """Fused-engine operators for the FULL penalty ladder: one
    single-rung build per rung (reusing :func:`build_fused_admm_operator`
    verbatim), rung-dependent operators stacked on a leading R axis.
    The whole stack is small (7 x the single-rung operators ~ 5 MB at
    the four-tank shape) -- the scan selects the current rung's
    operators by dynamic leading-dim indexing."""
    import numpy as np

    rhos = np.asarray(ladder_op["rhos"], np.float64)
    R = rhos.shape[0]
    stacked_keys = (
        "v_c", "V_theta", "V_s", "u_c", "U_theta", "U_s",
        "cost_P", "cost_q", "cost_r",
    )
    per_rung = []
    dims = None
    for r in range(R):
        op_r = {
            k: np.asarray(ladder_op[k], np.float64)[r : r + 1]
            for k in stacked_keys
        }
        for k in ("lo", "hi", "u_lo", "u_hi", "alpha"):
            op_r[k] = ladder_op[k]
        op_r["rhos"] = rhos[r : r + 1]
        ops_r, dims_r = build_fused_admm_operator(
            plant, op_r, n, m, p, n_mpc_step=n_mpc_step,
            q=q if dims is None else dims.q,
        )
        per_rung.append(ops_r)
        if dims is None:
            dims = dims_r
    # Only genuinely rung-INDEPENDENT operators go in the shared
    # group; Gpre/bpre bake a rung's theta maps and stay per-rung
    # (solve-0 selects the initial rung's).
    ops = {
        k: per_rung[0][k]
        for k in ("lo_vec", "hi_vec", "u_lo_out", "u_hi_out", "Seg_2")
    }
    ops["Gpre_all"] = [o["Gpre"] for o in per_rung]
    ops["bpre_all"] = [o["bpre"] for o in per_rung]
    ops["Vop_3_all_host"] = [o["Vop_3"] for o in per_rung]
    for k in _LADDER_STACKED:
        ops[k + "_all"] = jnp.stack([o[k] for o in per_rung])
    ops["rhos_list"] = tuple(float(x) for x in rhos)
    return ops, dims, R


def _make_ladder_step(ops, dims: FusedADMMDims, iters, pipeline: int,
                      R: int, ratio: float, rhos_list):
    """One ladder solve: iterations + extraction at the CURRENT rung,
    batch-aggregate relative residual balancing (qp/box.py semantics
    at whole-batch granularity: the rung is shared by every row; at a
    fixed point every rung yields the same optimum, so
    converged solves are exact regardless of the rung path -- the
    per-lane residual lanes stay honest), dual rescale on a rung
    change, then the plant-step matmul with the NEW rung's maps."""
    tiny = jnp.float32(1e-12)
    ratio_t = jnp.float32(ratio)

    def rho_at(ri):
        # Branch-free scalar select over the static ladder (R tiny).
        out = jnp.float32(0.0)
        for i, c in enumerate(rhos_list):
            out = out + jnp.float32(c) * (ri == i).astype(jnp.float32)
        return out

    def sel(ri):
        d = dict(ops)
        for k in _LADDER_STACKED:
            d[k] = ops[k + "_all"][ri]
        d["rho"] = rho_at(ri)
        return d

    def step(s_flat, pre, vc, zth, sa, wa, ri, w_tile):
        ops_i = sel(ri)
        it_ex = _make_iter_extract(ops_i, dims, iters, pipeline)
        s, w, u_app, cost, rp, rd = it_ex(pre, vc, zth, sa, wa)
        # OSQP-style RELATIVE balancing, block-aggregated.
        rho_i = rho_at(ri)
        rp_blk = jnp.max(rp)
        rd_blk = jnp.max(rd) / rho_i  # unscaled max|s_new - s|
        s_mag = jnp.max(jnp.abs(s))
        w_mag = jnp.max(jnp.abs(w))
        rp_rel = rp_blk / jnp.maximum(jnp.maximum(s_mag, w_mag), tiny)
        rd_rel = rd_blk / jnp.maximum(w_mag, tiny)
        up = (rp_rel > ratio_t * rd_rel) & (ri < R - 1)
        down = (rd_rel > ratio_t * rp_rel) & (ri > 0)
        ri_new = ri + up.astype(jnp.int32) - down.astype(jnp.int32)
        # Unscaled multiplier y = rho*w is rung-invariant.
        w = w * (rho_i / rho_at(ri_new))
        ops_n = sel(ri_new)
        s_next, y_out, new_pre, new_vc, new_zth = _make_plant_step(
            ops_n, dims
        )(s_flat, u_app, w_tile)
        # Emit the POST-balance rung: the carried (and returned) w is
        # already rescaled to it, and qp/box.py's warm-start contract
        # pairs rho_idx with the w scaled FOR that rung.
        rung = jnp.broadcast_to(
            ri_new.astype(jnp.float32), (sa.shape[0], dims.q)
        )
        out_t = jnp.concatenate(
            [u_app, y_out, cost, rp, rd, rung], axis=1
        ).T
        return (out_t, s_next, new_pre, new_vc, new_zth, s, w, ri_new)

    return step


def _make_ladder_scan(ops, dims, iters, pipeline, R, ratio, rung0: int):
    """The ladder engine's ``lax.scan`` over solve blocks; the rung is
    carried with the state and shared by the whole batch."""
    step_fn = _make_ladder_step(
        ops, dims, iters, pipeline, R, ratio, ops["rhos_list"]
    )

    def run(s0p, pre0, vc0, zth0, sa0, wa0, W_packed):
        def body(carry, w_tile_t):
            s_flat, pre, vc, zth, sa, wa, ri = carry
            (out_t, s_next, new_pre, new_vc, new_zth, s, w, ri_new) = (
                step_fn(s_flat, pre, vc, zth, sa, wa, ri, w_tile_t.T)
            )
            return (s_next, new_pre, new_vc, new_zth, s, w,
                    ri_new), out_t

        carry0 = (s0p, pre0, vc0, zth0, sa0, wa0,
                  jnp.int32(rung0))
        (s_fin, _, _, _, sa_fin, wa_fin, ri_fin), OUT = jax.lax.scan(
            body, carry0, W_packed
        )
        return OUT, s_fin, sa_fin, wa_fin

    return run


def make_fused_ladder_rollout(
    plant: LTIParams,
    ladder_op: dict,
    n: int,
    m: int,
    p: int,
    n_steps: int,
    n_mpc_step: int = 1,
    iters: Tuple[int, int, int] = (0, 14, 4),
    cold_iters: int = 60,
    q: Optional[int] = None,
    tol: float = 1e-5,
    pipeline: int = 1,
    balance_ratio: float = 10.0,
    init_rung: Optional[int] = None,
):
    """Fused batched closed-loop rollout with the ADAPTIVE penalty
    ladder (qp/box.py's default box solver) inside the scan.

    The single-rung fused engine (:func:`make_fused_admm_rollout`)
    requires a fixed rho; this engine carries the FULL ladder's
    pre-factorized operators (tiny: R x nbox^2-scale) and
    residual-balances the rung once per solve, one rung shared by the
    whole batch (every rung's fixed point is the same optimum --
    qp/box.py module docstring -- so converged solves are exact
    regardless of rung path, and the per-lane residual/converged lanes
    report any laggards honestly). The scaled dual rescales by
    rho_old/rho_new on a rung change.

    Same contract as :func:`make_fused_admm_rollout`; the returned
    ``solver_state`` is a :class:`~...qp.box.BoxADMMState` whose
    ``rho_idx`` is the batch-shared final rung (per row).

    Reference anchor: the reference supports no input/output
    constraints at all (its only inequality is the CONVEX slack box,
    direct_data_driven_mpc_controller.py:658-675); this engine is the
    throughput path for the beyond-reference general box.
    """
    from direct_data_driven_mpc_jax.control.loop import ClosedLoopResult
    from direct_data_driven_mpc_jax.qp.box import BoxADMMState

    ops, dims, R = build_fused_ladder_operator(
        plant, ladder_op, n, m, p, n_mpc_step=n_mpc_step, q=q
    )
    nb = dims.nb
    n_blocks = math.ceil(n_steps / nb)
    pad = n_blocks * nb - n_steps
    qq, seg, nbox = dims.q, dims.seg, dims.nbox
    S, ns = dims.S, dims.ns
    rung0 = R // 2 if init_rung is None else int(init_rung)
    if not 0 <= rung0 < R:
        raise ValueError(f"init_rung {rung0} outside ladder [0, {R})")
    # NOTE on warm restarts: the returned solver_state's w is scaled
    # for solver_state.rho_idx (batch-shared). A segmented restart must
    # resume AT that rung -- run() enforces it below.

    engine = _make_ladder_scan(
        ops, dims, iters, pipeline, R, balance_ratio, rung0
    )

    Gpre0 = ops["Gpre_all"][rung0]
    bpre0 = ops["bpre_all"][rung0]
    Vop3_0 = ops["Vop_3_all_host"][rung0]

    def run(x0s, u_pasts, y_pasts, Ws, solver_state0=None):
        B = x0s.shape[0]
        if B % qq:
            raise ValueError(f"B={B} must be a multiple of q={qq}")
        Bq = B // qq
        f32 = jnp.float32
        s0 = jnp.concatenate(
            [
                jnp.asarray(x0s, f32).reshape(B, -1),
                jnp.asarray(u_pasts, f32).reshape(B, -1),
                jnp.asarray(y_pasts, f32).reshape(B, -1),
            ],
            axis=1,
        )
        s0p = s0.reshape(Bq, qq * S)
        pre_all = (
            jnp.matmul(s0p, Gpre0,
                       precision=jax.lax.Precision.HIGHEST)
            + bpre0
        )
        pre0 = pre_all[:, : dims.Mw]
        vc0 = pre_all[:, dims.Mw : dims.Mw + dims.Wb]
        zth0 = pre_all[:, dims.Mw + dims.Wb :]

        def pack_admm(x):
            x = jnp.asarray(x, f32)
            padl = jnp.zeros((B, seg - nbox), f32)
            return jnp.concatenate([x, padl], axis=1).reshape(
                Bq, qq * seg
            )

        if solver_state0 is None:
            sa0 = jnp.zeros((Bq, dims.Wb), f32)
            wa0 = jnp.zeros((Bq, dims.Wb), f32)
            if cold_iters:
                alpha = dims.alpha

                def cold_body(_, carry):
                    s, w = carry
                    d = s - w
                    v = vc0 + _dot3(d, Vop3_0)
                    vh = alpha * v + (1.0 - alpha) * s
                    s_new = jnp.clip(
                        vh + w, ops["lo_vec"], ops["hi_vec"]
                    )
                    return (s_new, w + vh - s_new)

                sa0, wa0 = jax.lax.fori_loop(
                    0, cold_iters, cold_body, (sa0, wa0)
                )
        else:
            sa0 = pack_admm(solver_state0[0])
            wa0 = pack_admm(solver_state0[1])
            # The state's w is scaled for ITS rung: a BoxADMMState (or
            # (s, w, rho_idx) tuple) must resume at that rung -- the
            # engine's rung is baked statically, so require the caller
            # to pass init_rung matching the concrete state.
            state_idx = getattr(solver_state0, "rho_idx", None)
            if state_idx is None and len(solver_state0) > 2:
                state_idx = solver_state0[2]
            if state_idx is not None:
                import numpy as _np

                try:
                    idx0 = int(_np.asarray(state_idx).ravel()[0])
                except (TypeError, jax.errors.TracerArrayConversionError):
                    raise ValueError(
                        "solver_state0.rho_idx is traced; pass the "
                        "concrete rung via init_rung= instead."
                    ) from None
                if idx0 != rung0:
                    raise ValueError(
                        f"solver_state0 was produced at rung {idx0} "
                        f"(its w is scaled for that rung) but the "
                        f"engine was built with init_rung={rung0}; "
                        f"pass init_rung={idx0}."
                    )

        W_pad = jnp.concatenate(
            [
                jnp.asarray(Ws, f32),
                jnp.zeros((B, pad, dims.p), f32),
            ],
            axis=1,
        )
        W_packed = (
            W_pad.reshape(Bq, qq, n_blocks, nb * dims.p)
            .transpose(2, 1, 3, 0)
            .reshape(n_blocks, qq * nb * dims.p, Bq)
        )

        OUT, s_fin, sa_fin, wa_fin = engine(
            s0p, pre0, vc0, zth0, sa0, wa0, W_packed
        )
        qnbm = qq * nb * dims.m
        qnbp = qq * nb * dims.p

        def unpack_t(x, width):
            return (
                x.reshape(n_blocks, qq, width, Bq)
                .transpose(3, 1, 0, 2)
                .reshape(B, n_blocks, width)
            )

        u_sys = unpack_t(OUT[:, :qnbm], nb * dims.m).reshape(
            B, -1, dims.m
        )[:, :n_steps]
        y_sys = unpack_t(
            OUT[:, qnbm : qnbm + qnbp], nb * dims.p
        ).reshape(B, -1, dims.p)[:, :n_steps]

        def unpack_scalar(x):
            return x.transpose(2, 1, 0).reshape(B, n_blocks)

        off = qnbm + qnbp
        costs = unpack_scalar(OUT[:, off : off + qq])
        rp = unpack_scalar(OUT[:, off + qq : off + 2 * qq])
        rd = unpack_scalar(OUT[:, off + 2 * qq : off + 3 * qq])
        rung = unpack_scalar(OUT[:, off + 3 * qq :])
        converged = (rp <= tol) & (rd <= tol)
        s_fin_b = s_fin.reshape(B, S)
        sa_b = sa_fin.reshape(B, seg)[:, :nbox]
        wa_b = wa_fin.reshape(B, seg)[:, :nbox]
        return ClosedLoopResult(
            u_sys=u_sys,
            y_sys=y_sys,
            costs=costs,
            converged=converged,
            x_final=s_fin_b[:, :ns],
            u_past=s_fin_b[:, ns : ns + dims.n * dims.m].reshape(
                B, dims.n, dims.m
            ),
            y_past=s_fin_b[:, ns + dims.n * dims.m :].reshape(
                B, dims.n, dims.p
            ),
            solver_state=BoxADMMState(
                s=sa_b, w=wa_b,
                rho_idx=rung[:, -1].astype(jnp.int32),
            ),
        )

    return run

"""Woodbury solves: turn d x d normal equations into L x L ones.

Every exact solve in this framework has the structure

    A_u  = c0_u * I + c1_u * G + Vh_u^T diag(wt_u) Vh_u
    rhs_u = Vh_u^T r_u

where ``G`` is a *shared* d x d Gramian (V^T V or U^T diag(z) U; reference
ials.h:88-144, safer2.h:104-221) and ``Vh_u`` is the user's [L, d] history
slab. The reference — and our direct path — solves the d x d system per
row (O(d^3/3) each). For rows whose history L is smaller than d, one
shared eigendecomposition ``G = Q diag(lam) Q^T`` per sweep lets Woodbury
shrink the per-row solve to L x L:

    M_u      = c0_u I + c1_u G          (diagonal in the shared eigenbasis)
    M_u^-1   = Q diag(s_u) Q^T,  s_u = 1 / (c1_u * lam + c0_u)
    A_u      = M_u + Vt_u^T Vt_u,  Vt_u = diag(sqrt(wt_u)) Vh_u
    A_u^-1 b = M^-1 b - M^-1 Vt^T (I_L + Vt M^-1 Vt^T)^-1 Vt M^-1 b

The heavy ops become ONE plain [N*L, d] x [d, d] matmul into the
eigenbasis (a large dense matmul, unlike batched per-row d x d math) and
a batched L x L SPD solve. At dim 512 this cuts the per-row solve FLOPs
by up to (d/L)^3 / 3.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from safer2_recommender_tpu.ops import block_chol

HIGHEST = jax.lax.Precision.HIGHEST

# Use Woodbury only when the history width is at most dim/2 (below that
# the L x L path strictly dominates) and dim is large enough for the
# per-sweep eigh to amortize.
MIN_DIM = 128


class WideHist(NamedTuple):
    """Column-chunked history descriptor for very long rows (zipf-head
    items / users): the [N, L, d] slab is never materialized; assembly
    streams ``ops/assemble.py::wide_*`` scans instead. ``table`` is
    pre-cast to the compute dtype; ``row_coef`` ([N] or None) scales the
    accumulated history terms; ``extra_vec`` is a per-row scalar table
    gathered alongside (the dual weight on the item side)."""

    table: jax.Array
    bucket: object
    row_coef: Optional[jax.Array]
    extra_vec: Optional[jax.Array]


class SolveParams(NamedTuple):
    """Per-bucket ingredients of the normal equations (see module doc).

    ``emb`` is the masked [N, L, d] history slab (possibly bf16);
    ``wt``/``r`` are [N, L] (masked; ``wt`` >= 0); ``c0``/``c1`` are [N].
    When ``wide`` is set, emb/wt/r are None and the history terms stream
    through column chunks (always the direct d x d path: wide rows have
    width > dim).
    """

    emb: Optional[jax.Array]
    wt: Optional[jax.Array]
    r: Optional[jax.Array]
    c0: jax.Array
    c1: jax.Array
    wide: Optional[WideHist] = None


# Warm-started refresh: block size of the batched diagonal-block eighs
# and the minimum dim at which the refresh pays (below it one cold eigh
# is already sub-millisecond).
_REFRESH_BLOCK = 128
_REFRESH_MIN_DIM = 256


def refresh_eigh(gram: jax.Array, q_prev: jax.Array,
                 rel_tol: float) -> Tuple[jax.Array, jax.Array]:
    """Warm-started spectral decomposition Q diag(lam) Q^T ~= gram.

    A cold eigh of the shared Gramian can be the most expensive single
    op of a Woodbury-path epoch at large d. But the
    Gramian drifts slowly between ALS sweeps, and the solve does not
    need eigenPAIRS — only an orthogonal Q and diagonal lam whose
    reconstruction error stays in the noise class of the bf16
    normal-equation assembly (~1e-2; clustered directions may mix
    freely — measured NDCG parity at tol 3e-2, config.py). So: rotate
    the new Gramian into the previous basis (B = Q^T G Q, nearly block
    diagonal), eigh only the 128-wide DIAGONAL blocks (one cheap batched
    eigh), and keep the block-diagonalizing update Q <- Q blkdiag(Qk).
    The dropped off-diagonal-block coupling is measured every call;
    when accumulated drift pushes it past ``rel_tol * ||B||_F`` the full
    eigh runs instead (lax.cond — only one branch executes).
    """
    d = gram.shape[0]
    k = d // _REFRESH_BLOCK
    bs = _REFRESH_BLOCK
    b = jnp.matmul(q_prev.T, jnp.matmul(gram, q_prev,
                                        precision=HIGHEST),
                   precision=HIGHEST)
    b = 0.5 * (b + b.T)
    blocks = b.reshape(k, bs, k, bs).transpose(0, 2, 1, 3)   # [k, k, bs, bs]
    diag = blocks[jnp.arange(k), jnp.arange(k)]              # [k, bs, bs]
    total = jnp.linalg.norm(b)
    coupling = jnp.sqrt(jnp.maximum(
        jnp.square(total) - jnp.sum(jnp.square(diag)), 0.0))

    def warm(_):
        lam_b, qq = jnp.linalg.eigh(diag)                    # [k, bs] x2
        # q <- q_prev @ blockdiag(qq): batched [d, bs] x [bs, bs]
        qp = q_prev.reshape(d, k, bs).transpose(1, 0, 2)     # [k, d, bs]
        qn = jax.lax.dot_general(
            qp, qq, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            precision=HIGHEST)                               # [k, d, bs]
        return lam_b.reshape(-1), qn.transpose(1, 0, 2).reshape(d, d)

    def cold(_):
        lam, q = jnp.linalg.eigh(gram)
        return lam, q

    lam, q = jax.lax.cond(coupling <= rel_tol * total, warm, cold, None)
    return q, lam


def maybe_eigh(gram: jax.Array, dim: int, *, use_cg: bool,
               q_prev: Optional[jax.Array] = None,
               refresh_tol: float = 0.0,
               ) -> Optional[Tuple[jax.Array, jax.Array]]:
    """(Q, lam) of the shared Gramian when the Woodbury path is on.

    With ``q_prev`` (the previous sweep's basis, carried in model state)
    and ``refresh_tol > 0``, uses the warm-started ``refresh_eigh``."""
    if use_cg or dim < MIN_DIM:
        return None
    if (q_prev is not None and refresh_tol > 0.0
            and dim >= _REFRESH_MIN_DIM and dim % _REFRESH_BLOCK == 0):
        q, lam = refresh_eigh(gram, q_prev, refresh_tol)
    else:
        lam, q = jnp.linalg.eigh(gram)
    return q, jnp.maximum(lam, 0.0)


def applicable(width: int, dim: int) -> bool:
    return 2 * width <= dim


def _prep(emb: jax.Array, wt: jax.Array, c0: jax.Array, c1: jax.Array,
          q: jax.Array, lam: jax.Array):
    """Shared Woodbury ingredients: rotated history ``w`` [N, L, d]
    (compute dtype), rotated-basis M^-1 diagonal ``s`` [N, d], per-slot
    sqrt-weights ``sq`` [N, L] and the L x L capacitance
    ``K = Vt M^-1 Vt^T`` (its +I_L rides the solver's lazy shift).

    Dataflow (round 4): the rotation matmul emits ``w`` directly in the
    compute dtype (accumulation stays f32; an f32 slab plus two bf16
    convert passes would be pure dtype traffic), and the weighted slab
    ``wts`` is
    never materialized — the per-slot sqrt(wt) factors are rank-1 on
    (l, m), so they post-scale the [N, L, L] capacitance (<= L/d of the
    bytes) and fold into the small [N, L] operands in ``_finish``.
    """
    compute_dtype = emb.dtype
    # Rotate histories into the shared eigenbasis: ONE plain matmul.
    w = jax.lax.dot_general(
        emb, q.astype(compute_dtype),
        dimension_numbers=(((2,), (0,)), ((), ())),
        preferred_element_type=compute_dtype)                 # [N, L, d]
    s = 1.0 / (c1[:, None] * lam[None, :] + c0[:, None])      # [N, d]
    rs = jnp.sqrt(s)                                          # [N, d]
    # ws = diag(sqrt(wt)) W diag(sqrt(s)): ONE fused rank-1-weighted
    # elementwise pass; K = ws ws^T EXACTLY (sq_l sq_m sum_e w s w),
    # with no [N, L, L] post-scale pass over the capacitance.
    ws = w * (jnp.sqrt(wt)[:, :, None]
              * rs[:, None, :]).astype(compute_dtype)
    k = jnp.einsum("nle,nme->nlm", ws, ws,
                   preferred_element_type=jnp.float32)
    return w, s, rs, ws, k


def _finish(z: jax.Array, s: jax.Array, rs: jax.Array, ws: jax.Array,
            k: jax.Array, q: jax.Array) -> jax.Array:
    """x = Q (z - s Vt^T (K+I)^-1 Vt z) given the rotated M^-1 rhs z.

    With ``ws = diag(sq) W diag(rs)``: ``Vt z`` in the rotated basis is
    ``ws (z / rs)`` and ``Vt^T y`` is ``(ws^T y) / rs`` — the sqrt
    factors ride the small [N, d]/[N, L] vectors only."""
    # matvec-like contractions as multiply+reduce (a batched mat-vec
    # lowering can pay a fixed per-element cost that dominates at scale)
    u = jnp.sum(ws * (z / rs)[:, None, :], axis=2)
    y = block_chol.spd_solve(k, u, jnp.ones((k.shape[0],), k.dtype))
    wty = jnp.sum(ws * y[:, :, None], axis=1) / rs
    out = z - s * wty
    return jax.lax.dot_general(
        out.astype(jnp.float32), q,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)                   # [N, d]


def solve(p: SolveParams, q: jax.Array, lam: jax.Array) -> jax.Array:
    """Batched Woodbury solve of A x = Vh^T r -> new rows [N, d] (f32)."""
    w, s, rs, ws, k = _prep(p.emb, p.wt, p.c0, p.c1, q, lam)
    rv = jnp.sum(w * p.r[:, :, None], axis=1)                 # Q^T Vh^T r
    return _finish(s * rv, s, rs, ws, k, q)


def solve_rhs(emb: jax.Array, wt: jax.Array, c0: jax.Array, c1: jax.Array,
              b: jax.Array, q: jax.Array, lam: jax.Array) -> jax.Array:
    """Batched Woodbury solve of A x = b for an ARBITRARY rhs b [N, d]
    (the blockwise models' delta systems, whose rhs mixes residual,
    local-global-Gramian and regularizer pull-back terms — see
    models/common.py::block_sweep_frozen). Same A as ``solve``:
    A = c0 I + c1 G + emb^T diag(wt) emb with G = Q diag(lam) Q^T.
    """
    w, s, rs, ws, k = _prep(emb, wt, c0, c1, q, lam)
    del w
    bz = jax.lax.dot_general(b, q,
                             dimension_numbers=(((1,), (0,)), ((), ())),
                             preferred_element_type=jnp.float32)
    return _finish(s * bz, s, rs, ws, k, q)

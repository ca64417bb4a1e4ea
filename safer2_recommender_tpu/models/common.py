"""Shared batched building blocks for all six model families.

Each function maps a whole padded bucket of users/items to new embedding
rows in one device program — the batched replacement for the
reference's per-row ``Project*`` functions running inside thread pools
(reference ials.h:88-144, safer2.h:104-221, ialspp.h:85-145,
safer2pp.h:97-216).

Conventions:
  * ``table_other`` is the frozen side's embedding table (items when
    solving users and vice versa).
  * ``gramian`` is the *global* Gramian of the frozen side (possibly
    dual-weighted), computed once per step like reference ials.h:321.
  * All returned row blocks are [N, ...]; padded rows produce garbage that
    the out-of-bounds scatter drops.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import jax
import jax.numpy as jnp

from safer2_recommender_tpu.data.dataset import Bucket
from safer2_recommender_tpu.ops import assemble, solve, woodbury
from safer2_recommender_tpu.ops.woodbury import SolveParams
from safer2_recommender_tpu.parallel.mesh import memory_budget


def safe_len(bucket: Bucket) -> jax.Array:
    """History sizes as f32 with padded rows clamped to 1 (avoids 0-div)."""
    return jnp.maximum(bucket.length, 1).astype(jnp.float32)


# --------------------------------------------------------------------------
# Exact (full-dimension) solves
# --------------------------------------------------------------------------


# One solve group's live-slab budget on a 16 GiB device (scaled to the
# device's memory by ``mesh.memory_budget``).
SOLVE_GROUP_BYTES = 2 << 30


def _solve_groups(buckets, dim: int, budget_bytes: int = None,
                  gather_dim: int = None):
    """Greedily group buckets so one solve batch's live slabs — the
    [rows, d, d] systems (~2 solver copies) AND the gathered
    [rows, L, d] history slabs — stay under the memory budget. The
    gather term matters for zipf-head widths: several [200, 2048, d]
    slabs fit the d x d budget but their gathers alone exceeded memory at
    MSD scale before it was accounted. ``gather_dim`` overrides the
    gathered-slab width when it differs from the system size (blockwise
    sweeps solve [bs, bs] systems but gather full-width rows)."""
    g_dim = dim if gather_dim is None else gather_dim

    def cost(b):
        w_eff = min(b.width, assemble.WIDE_CHUNK) if (
            assemble.is_wide(b, g_dim)) else b.width
        return b.n_rows * (dim * dim * 4 + w_eff * (g_dim + 1) * 4)

    if budget_bytes is None:
        budget_bytes = memory_budget(SOLVE_GROUP_BYTES)
    floor = 64 * dim * dim * 4
    cap = max(budget_bytes, floor)
    groups, cur, used = [], [], 0
    for b in buckets:
        c = cost(b)
        if cur and used + c > cap:
            groups.append(cur)
            cur, used = [], 0
        cur.append(b)
        used += c
    if cur:
        groups.append(cur)
    return groups


@dataclasses.dataclass(frozen=True)
class BucketStack:
    """K same-shape buckets stacked for a ``lax.scan`` sweep.

    At MSD scale the memory budget splits each width bucket into O(100)
    identical-shape row chunks (data/dataset.py::_bucket_budgets); an
    unrolled per-chunk op chain makes dim-512 epochs take minutes to
    compile. Same-shape chunks instead run as ONE scan whose body holds
    the gather/assemble/solve graph once; the scan's carried table also
    serializes the chunks, bounding live [rows, L, d] slabs exactly like
    the token chain does for the unrolled path.
    """

    stack: Bucket   # every field with a leading [K] axis
    k: int
    n_rows: int
    width: int


def tie_bucket(b: Bucket, carry) -> Bucket:
    """Make a bucket's gather indices data-dependent on the sweep carry.

    Scan bodies read only the frozen table, so if XLA unrolls a short
    scan (it may for small trip counts), nothing orders one chunk's
    [N, L, d] gather after the previous chunk's solve and every slab
    goes live at once (out of memory at MSD scale).
    Adding an always-zero token derived from the carry restores the
    chain; inside a rolled loop it is free.
    """
    leaf = jax.tree_util.tree_leaves(carry)[0]
    return dataclasses.replace(b, col_ids=b.col_ids + zero_token(leaf)[0])


def zero_token(arr):
    """(int32, float32) zeros that XLA cannot constant-fold away, even
    when ``arr`` holds inf/NaN (a diverging run must stay a visibly
    diverging run, not silently corrupt gather indices): the isfinite
    guard pins non-finite values to 0 and a guaranteed-finite value
    times 0.0 is exactly 0, but XLA cannot prove the operand finite so
    the data dependency survives."""
    v = arr.ravel()[0].astype(jnp.float32)
    v = jnp.where(jnp.isfinite(v), v, 0.0)
    t = (v * 0.0).astype(jnp.int32)
    return t, t.astype(jnp.float32)


def group_same_shape(buckets):
    """Group buckets by (n_rows, width): singles stay ``Bucket``, repeats
    become ``BucketStack``. Order across groups is insertion order of
    first occurrence; per-sweep row sets are disjoint so reordering
    buckets never changes the result. The contiguity flag joins the key:
    it is static pytree metadata, so a contiguous bucket cannot stack
    with a scatter-path one (only the last bucket of a side can
    differ — pad overhang, data/dataset.py::_renumber_buckets)."""
    by_shape = {}
    for b in buckets:
        by_shape.setdefault((b.n_rows, b.width, b.contiguous),
                            []).append(b)
    out = []
    for (n, w, _), bs in by_shape.items():
        if len(bs) == 1:
            out.append(bs[0])
        else:
            stack = jax.tree_util.tree_map(
                lambda *xs: jnp.stack(xs), *bs)
            out.append(BucketStack(stack=stack, k=len(bs), n_rows=n,
                                   width=w))
    return out


def assemble_rotated(p: SolveParams, eig) -> Tuple[jax.Array, jax.Array,
                                                   jax.Array]:
    """Direct normal equations in the shared Gramian's eigenbasis.

    With G = Q diag(lam) Q^T (the decomposition the Woodbury path
    already computes once per sweep), rotating the gathered histories
    once (E_rot = E @ Q, one plain matmul over rows that would be
    assembled anyway) makes the whole c1*G term DIAGONAL:

        Q^T A Q = (E_rot)^T diag(wt) E_rot + diag(c0 + c1*lam)

    so it rides the solver's lazy diagonal shift as a [N, d] vector
    ridge instead of a full memory-bound broadcast-add pass over the
    [N, d, d] systems. Solve the rotated
    system, then rotate the solution back: x = y @ Q^T.

    Returns (a_rot, rhs_rot, ridge [N, d]).
    """
    q, lam = eig
    # The rotation matmul emits directly in the compute dtype (the
    # accumulation stays f32); an f32 output + astype was a full
    # convert pass over the largest slab in the program.
    emb_rot = jax.lax.dot_general(
        p.emb, q.astype(p.emb.dtype),
        dimension_numbers=(((2,), (0,)), ((), ())),
        preferred_element_type=p.emb.dtype)
    a = assemble.row_gramians(emb_rot, col_weight=p.wt)
    rhs = assemble.row_sums(emb_rot, col_weight=p.r)
    ridge = p.c0[:, None] + p.c1[:, None] * lam[None, :]
    return a, rhs, ridge


def assemble_from_params(p: SolveParams, gram: jax.Array
                         ) -> Tuple[jax.Array, jax.Array]:
    """Direct normal equations from the shared parameterization:

    A = c1*G + emb^T diag(wt) emb ;  rhs = emb^T r.

    The ridge c0*I is NOT added here: it rides the solver's ridge
    argument (``solve.solve(..., ridge=p.c0)``), so no extra slab-wide
    pass over the [N, d, d] systems adds it. On the wide
    (column-chunked) path the c1*G term seeds the streaming
    accumulator and the row coefficient folds into the chunk weights,
    so no post-pass over the [N, d, d] slab remains there either.
    """
    if p.wide is not None:
        wh = p.wide
        init_a = p.c1[:, None, None] * gram[None].astype(jnp.float32)
        a, rhs = assemble.wide_assemble(wh.table, wh.bucket,
                                        extra_vec=wh.extra_vec,
                                        row_coef=wh.row_coef,
                                        init_a=init_a)
        return a, rhs
    a = assemble.row_gramians(p.emb, col_weight=p.wt)
    rhs = assemble.row_sums(p.emb, col_weight=p.r)
    a = a + p.c1[:, None, None] * gram[None].astype(a.dtype)
    return a, rhs


def grad_from_params(p: SolveParams, gram: jax.Array,
                     x: jax.Array) -> jax.Array:
    """A @ x - rhs via matvecs (no [N, d, d] materialization) — the
    CVaR-MF subgradient (reference cvar_mf.h:133, :179)."""
    ax0 = p.c0[:, None] * x + p.c1[:, None] * (x @ gram)
    if p.wide is not None:
        wh = p.wide
        ax_h, rhs = assemble.wide_matvec(wh.table, wh.bucket, x,
                                         extra_vec=wh.extra_vec)
        if wh.row_coef is not None:
            ax_h = ax_h * wh.row_coef[:, None]
            rhs = rhs * wh.row_coef[:, None]
        return ax0 + ax_h - rhs
    vx = assemble.rowwise_dot(p.emb, x)
    ax = ax0 + assemble.row_sums(p.emb, col_weight=p.wt * vx)
    return ax - assemble.row_sums(p.emb, col_weight=p.r)


def solve_sweep(table: jax.Array, buckets, params_fn, gram, *,
                eig=None, use_cg: bool = False, cg_tol: float = 1e-10,
                cg_iters: int = 100, pre_list=None) -> jax.Array:
    """One full ALS sweep over all buckets; scatter the rows back.

    ``params_fn(bucket, pre=None) -> SolveParams`` (``pre`` is an
    optional pre-gathered ``(emb, mask)`` from ``gather_and_losses`` —
    the loss pass and the solve sweep then share ONE gather of the
    frozen table). Buckets whose history width is at most dim/2 take the
    Woodbury path when ``eig`` (the shared Gramian's eigendecomposition)
    is provided — an L x L solve instead of d x d (ops/woodbury.py). The
    rest assemble the d x d normal equations and use the direct batched
    block-Cholesky, concatenated in as few budget-capped groups as
    possible: the solver's op graph appears once per group (the
    per-bucket form replicated the ~200-op recursion 9x and host
    dispatch of it dominated small-dim epochs), and each group's work is
    data-dependent on the previous group's solution so XLA cannot
    schedule every [rows, L, d] gather / [rows, d, d] system slab live
    at once (out of memory at dim 512 otherwise): without ``pre`` the token
    ties the gather indices; with ``pre`` (slabs already live, gated by
    ``FUSE_BUDGET_BYTES``) it ties the ridge term instead.
    """
    if not buckets:
        return table
    dim = table.shape[1]
    token = jnp.int32(0)
    ftoken = jnp.float32(0.0)

    bump = zero_token

    groups = group_same_shape(buckets)
    if pre_list is None:
        pre_list = [None] * len(groups)
    assert len(pre_list) == len(groups)

    def make(b, pre):
        if pre is None:
            b = dataclasses.replace(b, col_ids=b.col_ids + token)
            return params_fn(b)
        p = params_fn(b, pre)
        # Tie the [N, L] weights (an einsum operand) so the [N, d, d]
        # system slab itself is data-dependent on the previous group —
        # the ridge no longer enters the assembly (it rides the solver),
        # so tying c0 alone would let XLA schedule every group's einsum
        # output live at once.
        return p._replace(wt=p.wt + ftoken, c0=p.c0 + ftoken)

    def is_wood(g) -> bool:
        return eig is not None and woodbury.applicable(g.width, dim)

    rotate = (eig is not None and not use_cg
              and not os.environ.get("FRT_NO_ROTATE"))

    def unrotate(y):
        return jax.lax.dot_general(
            y, eig[0], dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)

    def solve_one(b, pre):
        p = make(b, pre)
        if is_wood(b):
            return woodbury.solve(p, *eig)
        if rotate and p.wide is None:
            a, rhs, ridge = assemble_rotated(p, eig)
            return unrotate(solve.solve(a, rhs, ridge=ridge))
        a, rhs = assemble_from_params(p, gram)
        return solve.solve(a, rhs, use_cg=use_cg, tol=cg_tol,
                           max_iters=cg_iters, ridge=p.c0)

    # Same-shape stacks: one scan each (the scan carries the table, so
    # chunks serialize and the body's op graph appears once).
    singles = []
    for g, pre in zip(groups, pre_list):
        if isinstance(g, Bucket):
            singles.append((g, pre))
            continue

        if pre is None:
            def body(tbl, b):
                x = solve_one(tie_bucket(b, tbl), None)
                return assemble.scatter_bucket(tbl, b, x), None
            table = jax.lax.scan(body, table, g.stack)[0]
        else:
            def body(tbl, xs):
                b, p = xs
                x = solve_one(b, p)
                return assemble.scatter_bucket(tbl, b, x), None
            table = jax.lax.scan(body, table, (g.stack, pre))[0]
        token, ftoken = bump(table)

    # Remaining one-off buckets: Woodbury individually, direct solves
    # concatenated into as few budget-capped batches as possible.
    wood = [(b, p) for b, p in singles if is_wood(b)]
    direct = [(b, p) for b, p in singles if not is_wood(b)]

    # Woodbury buckets are the narrow ones; when their combined live
    # footprint fits the budget, skip the serialization token BETWEEN
    # them so XLA can overlap their gather/rotate/K-solve pipelines
    # (each alone underfills the chip). The per-row estimate counts the
    # path's peak concurrent slabs (woodbury.solve): the f32 rotated
    # slab + its weighted copy + two compute-dtype copies at the K
    # einsum (worst-case f32) ~= 16*dim, plus ~3 live [L, L] f32
    # systems in the K-solve ~= 12*width. The token then advances once
    # from the TABLE (which the scatter chain makes data-dependent on
    # every wood solve) so the big direct slabs stay ordered behind the
    # whole group.
    wood_bytes = sum(b.n_rows * b.width * (16 * dim + 12 * b.width)
                     for b, _ in wood)
    overlap = (wood_bytes <= FUSE_BUDGET_BYTES
               and not os.environ.get("FRT_NO_WOOD_OVERLAP"))
    for b, pre in wood:
        x = solve_one(b, pre)
        if not overlap:
            token, ftoken = bump(x)
        table = assemble.scatter_bucket(table, b, x)
    if overlap and wood:
        token, ftoken = bump(table)

    def cat(xs):
        return xs[0] if len(xs) == 1 else jnp.concatenate(xs, axis=0)

    pres = {id(b): p for b, p in direct}
    for group in _solve_groups([b for b, _ in direct], dim):
        ps = [make(b, pres[id(b)]) for b in group]
        g_rot = rotate and all(p.wide is None for p in ps)
        if g_rot:   # g_rot implies use_cg is False (see ``rotate``)
            systems = [assemble_rotated(p, eig) for p in ps]
            ridge = cat([s[2] for s in systems])
        else:
            systems = [assemble_from_params(p, gram) for p in ps]
            ridge = cat([p.c0 for p in ps])
        x = solve.solve(cat([s[0] for s in systems]),
                        cat([s[1] for s in systems]), use_cg=use_cg,
                        tol=cg_tol, max_iters=cg_iters, ridge=ridge)
        if g_rot:
            x = unrotate(x)
        token, ftoken = bump(x)
        ofs = 0
        for b in group:
            table = assemble.scatter_bucket(table, b,
                                            x[ofs:ofs + b.n_rows])
            ofs += b.n_rows
    return table


def _wide_hist(table_other, bucket, dtype, row_coef=None, extra_vec=None):
    t = table_other if dtype is None else table_other.astype(dtype)
    return woodbury.WideHist(table=t, bucket=bucket, row_coef=row_coef,
                             extra_vec=extra_vec)


def sweep_apply(buckets, pre_list, carry, body):
    """``body(carry, bucket, pre) -> carry`` over grouped buckets; stacked
    same-shape groups run as one ``lax.scan`` (see ``BucketStack``).
    ``pre_list`` aligns with ``group_same_shape(buckets)`` or is None."""
    groups = group_same_shape(buckets)
    if pre_list is None:
        pre_list = [None] * len(groups)
    for g, pre in zip(groups, pre_list):
        if isinstance(g, Bucket):
            carry = body(carry, g, pre)
        elif pre is None:
            carry = jax.lax.scan(
                lambda c, b: (body(c, tie_bucket(b, c), None), None),
                carry, g.stack)[0]
        else:
            carry = jax.lax.scan(
                lambda c, xs: (body(c, xs[0], xs[1]), None), carry,
                (g.stack, pre))[0]
    return carry


def params_ials(table_other: jax.Array, bucket: Bucket,
                reg_rows: jax.Array, uobs: float,
                dtype=None, pre=None) -> SolveParams:
    """iALS normal equations (reference ials.h:88-144):

    A = uobs * G + reg * I + sum_h v v^T ;  rhs = sum_h v.
    """
    c1 = jnp.full((bucket.n_rows,), uobs, jnp.float32)
    if pre is None and assemble.is_wide(bucket, table_other.shape[1]):
        return SolveParams(emb=None, wt=None, r=None, c0=reg_rows, c1=c1,
                           wide=_wide_hist(table_other, bucket, dtype))
    emb, mask = pre or assemble.gather_history(table_other, bucket, dtype)
    return SolveParams(emb=emb, wt=mask, r=mask, c0=reg_rows, c1=c1)


def params_weighted_mean(table_other: jax.Array, bucket: Bucket,
                         reg_rows: jax.Array, uobs: float,
                         row_weight: jax.Array,
                         dtype=None, pre=None) -> SolveParams:
    """SAFER-family user-side system (reference safer2.h:104-163,
    erm_mf.h:91-151):

    A = w * (sum_h v v^T / |H| + uobs * G) + reg * I
    rhs = (w / |H|) * sum_h v
    """
    coef = row_weight / safe_len(bucket)          # w / |H|
    if pre is None and assemble.is_wide(bucket, table_other.shape[1]):
        return SolveParams(emb=None, wt=None, r=None, c0=reg_rows,
                           c1=row_weight * uobs,
                           wide=_wide_hist(table_other, bucket, dtype,
                                           row_coef=coef))
    emb, mask = pre or assemble.gather_history(table_other, bucket, dtype)
    wt = coef[:, None] * mask
    return SolveParams(emb=emb, wt=wt, r=wt, c0=reg_rows,
                       c1=row_weight * uobs)


def params_weighted_item(table_other: jax.Array, bucket: Bucket,
                         reg_rows: jax.Array, uobs: float,
                         norm_dual: jax.Array,
                         dtype=None) -> SolveParams:
    """SAFER-family item-side system (reference safer2.h:166-221,
    erm_mf.h:153-210), against the dual-weighted Gramian U^T diag(z) U:

    A = uobs * G_w + reg * I + sum_h wt_u u u^T
    rhs = sum_h wt_u u            with wt_u = z_u / |H_u|.

    The reference's tail rankUpdate bug (safer2.h:203) is intentionally
    not reproduced (correct masked einsum instead).
    """
    c1 = jnp.full((bucket.n_rows,), uobs, jnp.float32)
    if assemble.is_wide(bucket, table_other.shape[1]):
        return SolveParams(emb=None, wt=None, r=None, c0=reg_rows, c1=c1,
                           wide=_wide_hist(table_other, bucket, dtype,
                                           extra_vec=norm_dual))
    emb, mask, wt = assemble.gather_history_extra(table_other, norm_dual,
                                                  bucket, dtype)
    return SolveParams(emb=emb, wt=wt, r=wt, c0=reg_rows, c1=c1)




# --------------------------------------------------------------------------
# Blockwise (subspace) solves with the flat prediction/residual cache
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Per-row coefficients of one bucket's block delta systems:

        A   = ch * (sum_h wt v_loc v_loc^T) + cg * G_loc + reg * I
        rhs = ch * (sum_h wt v_loc (pred-1)) + cg * (G_lg @ x_full)
              + reg * x_loc
        x_loc <- x_loc - A^-1 rhs

    One parameterization covers all three reference variants:
    iALS++ (ialspp.h:85-145): ch=1, cg=uobs, wt=mask;
    SAFER2++ user (safer2pp.h:97-159): ch=w/|H|, cg=w*uobs, wt=mask;
    SAFER2++ item (safer2pp.h:161-216): ch=1, cg=uobs, wt=z/|H| per slot.
    ``reg`` rides the solver's lazy diagonal shift, never a slab add.
    """

    cg: jax.Array             # [N] coefficient of the frozen-side Gramian
    reg: jax.Array            # [N] ridge
    ch: jax.Array = None      # [N] history-term coefficient (None = 1)


def block_sweep_frozen(table_self, table_other, buckets, gram, spec_fn,
                       *, bs: int, n_sweeps: int = 1, dtype=None,
                       extra_vec=None, eig=None, pre_list=None):
    """Blockwise coordinate sweep(s) of one side against the FROZEN
    other side — the ++ models' hot loop.

    Structured bucket-outer / block-inner: each bucket gathers its
    [N, L, d] history slab ONCE and every block (of every sweep, for the
    fold-in's ``n_sweeps=8``) slices it, with per-slot predictions
    maintained incrementally — the batched equivalent of the
    reference's flat prediction cache (ialspp.h:399-406,
    safer2pp.h:504-508), but slab-local: no per-tuple scatters, and the
    drift resets every sweep because pred is recomputed from the live
    tables at sweep start. The previous design re-gathered the full
    slab for EVERY block (d/bs full passes per side per sweep) and was
    4.4x slower than the exact solver at dim 512 (VERDICT round 1);
    this one does ~2 full-width passes per side per sweep.

    Ordering divergence from the reference: the reference interleaves
    StepU(block)/StepV(block) (ialspp.h:220-239, safer2pp.h:303-319),
    so a U block sees the previous V blocks' updates from the same pd
    iteration. Freezing the other side runs all blocks of U, then all
    blocks of V — the same per-block systems against the sweep-start
    other table (block-Jacobi across sides, Gauss-Seidel within a
    side). Both are valid block coordinate descent on the same
    objective; measured quality is inside reference reseed noise
    (BASELINE.md head-to-head, PARITY.md).

    ``gram`` is the FULL Gramian of ``table_other`` (dual-weighted for
    the SAFER2++ item sweep): the per-block G_loc/G_lg of the reference
    are slices of it since the other side is frozen. ``spec_fn(bucket)
    -> BlockSpec`` supplies the per-row coefficients; ``extra_vec``
    routes a per-column weight (the item sweep's z/|H|) through the
    fused slab gather. Zipf-head rows whose slab cannot materialize
    instead stream ONE full normal-equation pass (S, r0) and solve every
    block from slices of it (``assemble.wide_gram_resid``).

    ``eig``, when given, is ``(Q, lam)`` of the FULL ``gram`` (from
    ``woodbury.maybe_eigh``) and upgrades every Woodbury-ELIGIBLE
    bucket (2 * width <= dim) to ONE full-dim block per sweep solved
    via full-dim Woodbury; only wider (long-history / streamed) rows
    keep the bs-block sweeps. Rationale: ONE L x L capacitance solve
    per row replaces all dim/bs per-block bs x bs Cholesky solves, and
    the bs-block sweep's rotation savings (L*bs*d vs L*d^2 FLOPs per
    row) are bound by the same slab bytes. A full-dim block is still block
    coordinate descent (the largest block), so fixed points and the
    model contract are unchanged — only the per-sweep trajectory
    improves (a full solve is the limit the block sweep iterates
    toward; cf. test_ialspp_full_block_equals_ials), and the 8-sweep
    eval fold-in collapses to one solve for those rows. The reference
    has no such split because it has no Woodbury path at all — its ++
    blocks exist precisely to avoid d x d solves (ialspp.h:85-145);
    ours avoids them better where history permits, and keeps the ++
    subspace structure where it genuinely wins: rows with L > dim/2,
    whose blockwise solves cost (dim/bs) * bs^3 instead of the exact
    path's dim^3. FRT_NO_FULL_WOOD=1 restores uniform bs-blocks
    (block-Woodbury for narrow buckets).
    """
    if not buckets:
        return table_self
    dim = table_self.shape[1]

    # Block-level Woodbury: for buckets whose history width is at most
    # bs/2, the bs x bs delta system A = ch*H_ss + cg*G_ss + reg*I is
    # solved via ONE batched eigh of the frozen Gramian's diagonal
    # blocks (G_ss = Q_k diag(lam_k) Q_k^T, shared by every row) plus a
    # per-row L x L capacitance solve (ops/woodbury.py::solve_rhs) —
    # skipping both the bs x bs Cholesky solve and the per-row bs x bs
    # Gramian einsum. Most rows qualify: history
    # lengths are power-law (ML-1M/MSD median well under 32).
    q_full = lam_full = None
    if eig is not None and not os.environ.get("FRT_NO_FULL_WOOD"):
        q_full, lam_full = eig

    wood = (q_full is None  # full-dim Woodbury supersedes (see below)
            and dim % bs == 0 and bs >= 16
            and not os.environ.get("FRT_NO_BLOCK_WOOD")
            and any(not assemble.is_wide(g, dim) and 2 * g.width <= bs
                    for g in buckets))
    if wood:
        nb = dim // bs
        diag = gram.reshape(nb, bs, nb, bs)[
            jnp.arange(nb), :, jnp.arange(nb), :]         # [nb, bs, bs]
        lam_all, q_all = jnp.linalg.eigh(diag)
        lam_all = jnp.maximum(lam_all, 0.0)

    def gather(b):
        if extra_vec is None:
            emb, mask = assemble.gather_history(table_other, b, dtype)
            return emb, mask, None
        return assemble.gather_history_extra(table_other, extra_vec, b,
                                             dtype)

    def run_blocks(carry, blk, bs_b=bs, sweeps_b=n_sweeps):
        """Drive blk(carry, s, bs_static) over sweeps_b x blocks; one
        lax.scan when blocks are uniform (the unrolled per-block chain
        made dim-512 programs take minutes to compile)."""
        if dim % bs_b == 0:
            offs = jnp.tile(jnp.arange(0, dim, bs_b), sweeps_b)
            return jax.lax.scan(lambda c, s: (blk(c, s, bs_b), None),
                                carry, offs)[0]
        for _ in range(sweeps_b):
            for s in range(0, dim, bs_b):
                carry = blk(carry, s, min(s + bs_b, dim) - s)
        return carry

    def do_narrow(tbl, b, pre=None):
        if pre is not None:
            emb, mask, wt = pre[0], pre[1], None
        else:
            emb, mask, wt = gather(b)
        spec = spec_fn(b)
        # Woodbury-eligible upgrade: ONE full-dim block (see docstring)
        full_wood = (q_full is not None
                     and woodbury.applicable(b.width, dim))
        wt_eff = mask if wt is None else wt
        if spec.ch is not None:
            wt_eff = wt_eff * spec.ch[:, None]

        if full_wood:
            # The full-dim delta solve collapses algebraically to the
            # direct normal-equation solve (rhs = A x - b, so
            # x - A^-1 rhs = A^-1 b): solve it directly and skip the
            # prediction pass, the residual weighting, and the
            # G @ x / reg * x pull-back terms entirely. One such sweep
            # is exact; further sweeps against the same frozen side
            # would be no-ops.
            rhs = assemble.row_sums(emb, col_weight=(
                mask if wt is None else wt))
            if spec.ch is not None:
                rhs = rhs * spec.ch[:, None]
            xf = woodbury.solve_rhs(emb, wt_eff, spec.reg, spec.cg,
                                    rhs, q_full, lam_full)
            return assemble.scatter_bucket(tbl, b, xf)

        xf = assemble.read_rows(tbl, b)
        pred = assemble.rowwise_dot(emb, xf)
        use_wood = wood and 2 * b.width <= bs   # static per bucket

        def blk(carry, s, bsz):
            xf, pred = carry
            emb_loc = jax.lax.dynamic_slice_in_dim(emb, s, bsz, axis=2)
            x_loc = jax.lax.dynamic_slice_in_dim(xf, s, bsz, axis=1)
            g_lg = jax.lax.dynamic_slice(gram, (s, 0), (bsz, dim))
            resid = pred - mask
            rhs = assemble.row_sums(
                emb_loc, col_weight=resid if wt is None else wt * resid)
            if spec.ch is not None:
                rhs = rhs * spec.ch[:, None]
            rhs = (rhs + spec.cg[:, None] * (xf @ g_lg.T)
                   + spec.reg[:, None] * x_loc)
            if use_wood:
                k_i = s // bs
                q_k = jax.lax.dynamic_index_in_dim(q_all, k_i, 0,
                                                   keepdims=False)
                lam_k = jax.lax.dynamic_index_in_dim(lam_all, k_i, 0,
                                                     keepdims=False)
                delta = -woodbury.solve_rhs(emb_loc, wt_eff, spec.reg,
                                            spec.cg, rhs, q_k, lam_k)
            else:
                g_loc = jax.lax.dynamic_slice(gram, (s, s), (bsz, bsz))
                a = assemble.row_gramians(emb_loc, col_weight=wt)
                if spec.ch is not None:
                    a = a * spec.ch[:, None, None]
                a = a + spec.cg[:, None, None] * g_loc[None]
                delta = -solve.cholesky_solve(a, rhs, spec.reg)
            pred = pred + jnp.sum(emb_loc * delta[:, None, :], axis=2)
            xf = jax.lax.dynamic_update_slice_in_dim(xf, x_loc + delta,
                                                     s, axis=1)
            return xf, pred

        xf, _ = run_blocks((xf, pred), blk)
        return assemble.scatter_bucket(tbl, b, xf)

    def do_wide(tbl, b):
        spec = spec_fn(b)
        xf0 = assemble.read_rows(tbl, b)
        s_full, r0 = assemble.wide_gram_resid(table_other, b, xf0,
                                              extra_vec=extra_vec,
                                              dtype=dtype)
        n = b.n_rows

        def blk(xf, s, bsz):
            x_loc = jax.lax.dynamic_slice_in_dim(xf, s, bsz, axis=1)
            g_loc = jax.lax.dynamic_slice(gram, (s, s), (bsz, bsz))
            g_lg = jax.lax.dynamic_slice(gram, (s, 0), (bsz, dim))
            s_ss = jax.lax.dynamic_slice(s_full, (0, s, s), (n, bsz, bsz))
            s_row = jax.lax.dynamic_slice(s_full, (0, s, 0), (n, bsz, dim))
            # pred is linear in xf: hist term = r0_loc + (S @ (xf-xf0))_loc
            r_s = (jax.lax.dynamic_slice_in_dim(r0, s, bsz, axis=1)
                   + jnp.sum(s_row * (xf - xf0)[:, None, :], axis=2))
            a, rhs = s_ss, r_s
            if spec.ch is not None:
                a = a * spec.ch[:, None, None]
                rhs = rhs * spec.ch[:, None]
            a = a + spec.cg[:, None, None] * g_loc[None]
            rhs = (rhs + spec.cg[:, None] * (xf @ g_lg.T)
                   + spec.reg[:, None] * x_loc)
            delta = -solve.cholesky_solve(a, rhs, spec.reg)
            return jax.lax.dynamic_update_slice_in_dim(
                xf, x_loc + delta, s, axis=1)

        xf = run_blocks(xf0, blk)
        return assemble.scatter_bucket(tbl, b, xf)

    def do_bucket(tbl, b, pre=None):
        # Tie the slab gather to the carried table: the gather reads
        # only the frozen other side, so without the token nothing
        # orders one bucket's [N, L, d] slab after the previous
        # bucket's solve and XLA schedules them all live at once (the
        # OOM class solve_sweep's tokens prevent). Pre-gathered slabs
        # (the fused loss pass's, ``gather_and_losses``) skip both the
        # gather and the token.
        if pre is None:
            b = tie_bucket(b, tbl)
        if assemble.is_wide(b, dim):
            return do_wide(tbl, b)
        return do_narrow(tbl, b, pre)

    assert pre_list is None or extra_vec is None, \
        "pre-gathered slabs carry no extra_vec column"
    return sweep_apply(buckets, pre_list, table_self, do_bucket)


# --------------------------------------------------------------------------
# Interleaved (reference-order) blockwise sweep
# --------------------------------------------------------------------------


def block_sweep_interleaved(u, v, by_user, by_item, spec_u_fn, spec_v_fn,
                            *, bs: int, dtype=None, extra_vec_v=None,
                            g_weight_v=None):
    """Reference-ORDER blockwise epoch: per block s, StepU(s) then
    StepV(s) (ialspp.h:208-261, safer2pp.h:303-319) — the trajectory
    ``block_sweep_frozen`` deliberately reorders for speed.

    Fidelity mode (``Config.block_interleaved``): each U block sees the
    SAME pd iteration's previous V blocks (and vice versa), and the
    local/local-global Gramians are recomputed per block from the LIVE
    other table (ialspp.h:362-365, safer2pp.h:532-544) instead of
    sliced from a frozen one. The reference's flat per-tuple prediction
    cache (ialspp.h:399-406) becomes per-slot prediction arrays carried
    in BOTH adjacency views; a block's embedding deltas cross views as
    a [num_rows, bs] delta table that the other view row-gathers — no
    per-element scatters.

    ``spec_*_fn(bucket) -> BlockSpec`` as in ``block_sweep_frozen``;
    ``extra_vec_v`` routes the item sweep's per-slot z/|H_u| weights;
    ``g_weight_v`` (e.g. the dual vector) weights the V-step's
    user-side Gramian slices (U^T diag(z) U, safer2pp.h:532-544).

    Returns ``(u, v, preds_u)`` with ``preds_u`` aligned to
    ``group_same_shape(by_user)`` — end-of-epoch per-slot predictions,
    the analog of the reference's cache that its ComputeUserLoss reads
    (safer2pp.h:611-652); feed to ``losses_from_preds``. Requires
    ``dim % bs == 0`` (callers fall back to the frozen sweep otherwise).

    Zipf-head buckets (``assemble.is_wide``) never materialize a
    [N, L, bs] slab: their per-block gathers stream through fixed-width
    column chunks of the bs-wide block table (the interleaved analog of
    ``assemble.wide_*``; the reference's per-tuple cache handles any
    width, ialspp.h:399-406). Their carried predictions are padded to a
    whole number of chunks — ``losses_from_preds`` slices them back.
    """
    dim = u.shape[1]
    assert dim % bs == 0, "interleaved sweep requires dim % bs == 0"
    gu = group_same_shape(by_user)
    gi = group_same_shape(by_item)
    offs = jnp.arange(0, dim, bs)

    def cast(x):
        return x if dtype is None else x.astype(dtype)

    def _plan(b):
        """Static column-chunk plan (width, count) for a wide bucket —
        sized against the bs-wide block gathers; every consumer of the
        bucket's carried [N, c*w] predictions uses the same plan."""
        n, l = b.col_ids.shape
        w = min(assemble.WIDE_CHUNK, l)
        while w > 256 and n * w * (bs + 1) * 4 > assemble.wide_slab_bytes():
            w = (w + 1) // 2
        return w, -(-l // w)

    def _chunk_cols(b, w, c):
        n, l = b.col_ids.shape
        cols = b.col_ids
        if c * w != l:
            cols = jnp.pad(cols, ((0, 0), (0, c * w - l)))
        return (cols.reshape(n, c, w).transpose(1, 0, 2),   # [C, N, W]
                jnp.arange(c, dtype=jnp.int32) * w)

    def _chunk_gather(aug, b, cols_c, off, has_extra):
        """One [N, W, bs(+1)] masked chunk gather from the augmented
        block table; returns (emb, mask, extra-or-None)."""
        pos = jax.lax.broadcasted_iota(jnp.int32, cols_c.shape, 1) + off
        mask = (pos < b.length[:, None]).astype(jnp.float32)
        g = aug[cols_c] * mask[..., None].astype(aug.dtype)
        if has_extra:
            return g[..., :-1], mask, g[..., -1].astype(jnp.float32)
        return g, mask, None

    def _pred_bucket(b, tbl_self, other):
        """Fresh per-slot predictions, accumulated block-by-block so no
        [N, L, dim] slab ever materializes."""
        x_full = assemble.read_rows(tbl_self, b)

        if assemble.is_wide(b, dim):
            # Stream column chunks; within each chunk accumulate over
            # blocks so the live slab stays [N, W, bs].
            w, c = _plan(b)
            cols, coffs = _chunk_cols(b, w, c)

            def chunk_step(pred, xc):
                cols_c, off = xc

                def blk(pc, s):
                    o_blk = cast(jax.lax.dynamic_slice(
                        other, (0, s), (other.shape[0], bs)))
                    emb, _, _ = _chunk_gather(o_blk, b, cols_c, off,
                                              False)
                    x_loc = jax.lax.dynamic_slice(x_full, (0, s),
                                                  (b.n_rows, bs))
                    return pc + jnp.sum(emb * x_loc[:, None, :],
                                        axis=2), None

                pc = jax.lax.scan(blk, jnp.zeros((b.n_rows, w),
                                                 jnp.float32), offs)[0]
                return jax.lax.dynamic_update_slice(pred, pc,
                                                    (0, off)), None

            pred0 = jnp.zeros((b.n_rows, c * w), jnp.float32)
            return jax.lax.scan(chunk_step, pred0, (cols, coffs))[0]

        def step(pred, s):
            o_blk = cast(jax.lax.dynamic_slice(
                other, (0, s), (other.shape[0], bs)))
            emb, _ = assemble.gather_history(o_blk, b, None)
            x_loc = jax.lax.dynamic_slice(x_full, (0, s), (b.n_rows, bs))
            return pred + jnp.sum(emb * x_loc[:, None, :], axis=2), None

        pred0 = jnp.zeros((b.n_rows, b.width), jnp.float32)
        return jax.lax.scan(step, pred0, offs)[0]

    def init_preds(groups, tbl_self, other):
        preds = []
        for g in groups:
            if isinstance(g, Bucket):
                preds.append(_pred_bucket(g, tbl_self, other))
            else:
                preds.append(jax.lax.map(
                    lambda bk: _pred_bucket(bk, tbl_self, other), g.stack))
        return tuple(preds)

    def side_step(tbl_self, other, s, groups, preds, spec_fn, extra,
                  g_weight):
        """StepU/StepV at block offset ``s`` (ialspp.h:85-145,
        safer2pp.h:97-216): delta solves against live local Gramians.
        Returns (tbl_self', preds', delta_table [rows, bs])."""
        o_blk = jax.lax.dynamic_slice(other, (0, s), (other.shape[0], bs))
        lhs = o_blk if g_weight is None else o_blk * g_weight[:, None]
        g_lg = lhs.T @ other                       # [bs, dim] live
        g_loc = jax.lax.dynamic_slice(g_lg, (0, s), (bs, bs))
        o_blk_c = cast(o_blk)
        aug = o_blk_c if extra is None else jnp.concatenate(
            [o_blk_c, extra[:, None].astype(o_blk_c.dtype)], axis=1)
        dacc = jnp.zeros((tbl_self.shape[0], bs), jnp.float32)

        def finish(spec, rhs_hist, a_hist, x_full, x_loc):
            """Shared epilogue: coefficients + pull-back terms + solve."""
            rhs, a = rhs_hist, a_hist
            if spec.ch is not None:
                rhs = rhs * spec.ch[:, None]
                a = a * spec.ch[:, None, None]
            rhs = (rhs + spec.cg[:, None] * (x_full @ g_lg.T)
                   + spec.reg[:, None] * x_loc)
            a = a + spec.cg[:, None, None] * g_loc[None]
            return -solve.cholesky_solve(a, rhs, spec.reg)

        def do_b_wide(tbl_self, dacc, b, pred):
            """Zipf-head block step: stream [N, W, bs] column chunks of
            the block table (two passes: accumulate, then advance the
            carried predictions by the solved delta)."""
            spec = spec_fn(b)
            n = b.n_rows
            x_full = assemble.read_rows(tbl_self, b)
            x_loc = jax.lax.dynamic_slice(x_full, (0, s), (n, bs))
            w, c = _plan(b)
            cols, coffs = _chunk_cols(b, w, c)

            def acc(carry, xc):
                a, rh = carry
                cols_c, off = xc
                emb, mask_c, wt_c = _chunk_gather(aug, b, cols_c, off,
                                                  extra is not None)
                pc = jax.lax.dynamic_slice(pred, (0, off), (n, w))
                resid = pc - mask_c
                rh = rh + assemble.row_sums(
                    emb, col_weight=resid if wt_c is None else
                    wt_c * resid)
                a = a + assemble.row_gramians(emb, col_weight=wt_c)
                return (a, rh), None

            (a, rh), _ = jax.lax.scan(
                acc, (jnp.zeros((n, bs, bs), jnp.float32),
                      jnp.zeros((n, bs), jnp.float32)), (cols, coffs))
            delta = finish(spec, rh, a, x_full, x_loc)

            def upd(pred, xc):
                cols_c, off = xc
                emb, _, _ = _chunk_gather(aug, b, cols_c, off,
                                          extra is not None)
                pc = jax.lax.dynamic_slice(pred, (0, off), (n, w))
                pc = pc + jnp.sum(emb * delta[:, None, :], axis=2)
                return jax.lax.dynamic_update_slice(pred, pc,
                                                    (0, off)), None

            pred = jax.lax.scan(upd, pred, (cols, coffs))[0]
            x_new = jax.lax.dynamic_update_slice(x_full, x_loc + delta,
                                                 (0, s))
            tbl_self = assemble.scatter_bucket(tbl_self, b, x_new)
            dacc = assemble.scatter_bucket(dacc, b, delta)
            return tbl_self, dacc, pred

        def do_b(tbl_self, dacc, b, pred):
            if assemble.is_wide(b, dim):
                return do_b_wide(tbl_self, dacc, b, pred)
            if extra is None:
                emb, mask = assemble.gather_history(o_blk_c, b, None)
                wt = None
            else:
                emb, mask, wt = assemble.gather_history_extra(
                    o_blk_c, extra, b, None)
            spec = spec_fn(b)
            x_full = assemble.read_rows(tbl_self, b)
            x_loc = jax.lax.dynamic_slice(x_full, (0, s), (b.n_rows, bs))
            resid = pred - mask
            delta = finish(
                spec,
                assemble.row_sums(
                    emb, col_weight=resid if wt is None else wt * resid),
                assemble.row_gramians(emb, col_weight=wt),
                x_full, x_loc)
            pred = pred + jnp.sum(emb * delta[:, None, :], axis=2)
            x_new = jax.lax.dynamic_update_slice(x_full, x_loc + delta,
                                                 (0, s))
            tbl_self = assemble.scatter_bucket(tbl_self, b, x_new)
            dacc = assemble.scatter_bucket(dacc, b, delta)
            return tbl_self, dacc, pred

        new_preds = []
        for g, pred in zip(groups, preds):
            if isinstance(g, Bucket):
                tbl_self, dacc, p = do_b(tbl_self, dacc,
                                         tie_bucket(g, tbl_self), pred)
                new_preds.append(p)
            else:
                def body(c, xs):
                    t, d_ = c
                    bk, pk = xs
                    t, d_, pk = do_b(t, d_, tie_bucket(bk, t), pk)
                    return (t, d_), pk
                (tbl_self, dacc), pstk = jax.lax.scan(
                    body, (tbl_self, dacc), (g.stack, pred))
                new_preds.append(pstk)
        return tbl_self, tuple(new_preds), dacc

    def propagate(groups, preds, dacc, tbl_self, s):
        """Fold the other side's block deltas into this view's
        predictions: pred[n,l] += dacc[col_ids[n,l]] . x[row, s:s+bs] —
        the cross-view half of the reference's cache update
        (ialspp.h:399-406); f32 throughout (increments compound)."""
        x_blk = jax.lax.dynamic_slice(tbl_self, (0, s),
                                      (tbl_self.shape[0], bs))

        def do_p(b, pred):
            if assemble.is_wide(b, dim):
                xb = assemble.read_rows(x_blk, b)
                w, c = _plan(b)
                cols, coffs = _chunk_cols(b, w, c)

                def step(pred, xc):
                    cols_c, off = xc
                    dg, _, _ = _chunk_gather(dacc, b, cols_c, off, False)
                    pc = jax.lax.dynamic_slice(pred, (0, off),
                                               (b.n_rows, w))
                    pc = pc + jnp.sum(dg * xb[:, None, :], axis=2)
                    return jax.lax.dynamic_update_slice(pred, pc,
                                                        (0, off)), None

                return jax.lax.scan(step, pred, (cols, coffs))[0]
            dg, _ = assemble.gather_history(dacc, b, None)
            return pred + jnp.sum(dg * assemble.read_rows(x_blk, b)[:, None, :],
                                  axis=2)

        new_preds = []
        for g, pred in zip(groups, preds):
            if isinstance(g, Bucket):
                new_preds.append(do_p(g, pred))
            else:
                new_preds.append(jax.lax.scan(
                    lambda _, xs: (0, do_p(xs[0], xs[1])),
                    0, (g.stack, pred))[1])
        return tuple(new_preds)

    preds_u = init_preds(gu, u, v)
    preds_i = init_preds(gi, v, u)

    def block_step(carry, s):
        u, v, pu, pi = carry
        u, pu, du = side_step(u, v, s, gu, pu, spec_u_fn, None, None)
        pi = propagate(gi, pi, du, v, s)
        v, pi, dv = side_step(v, u, s, gi, pi, spec_v_fn, extra_vec_v,
                              g_weight_v)
        pu = propagate(gu, pu, dv, u, s)
        return (u, v, pu, pi), None

    (u, v, preds_u, preds_i), _ = jax.lax.scan(
        block_step, (u, v, preds_u, preds_i), offs)
    return u, v, preds_u


def losses_from_preds(preds_u, by_user, u, gram, num_users: int,
                      uobs: float, *, mean: bool, halve: bool) -> jax.Array:
    """Per-user losses from carried per-slot predictions — the analog of
    the reference's cache-based ComputeUserLoss (safer2pp.h:611-652,
    ialspp.h: ComputeUserLoss): obs = sum_h (pred-1)^2 [/|H| if mean]
    + uobs * u^T G u [x0.5 if halve]."""
    out = jnp.zeros((num_users,), jnp.float32)

    def lb(b, p):
        mask = assemble.history_mask(b)
        p = p[:, :mask.shape[1]]   # wide preds are chunk-padded
        obs = jnp.sum(jnp.square(p - mask) * mask, axis=1)
        if mean:
            obs = obs / safe_len(b)
        x = assemble.read_rows(u, b)
        loss = obs + uobs * jnp.einsum("nd,de,ne->n", x, gram, x)
        return loss * 0.5 if halve else loss

    for g, pred in zip(group_same_shape(by_user), preds_u):
        if isinstance(g, Bucket):
            out = assemble.scatter_bucket_vector(out, g, lb(g, pred))
        else:
            out = jax.lax.scan(
                lambda o, xs: (assemble.scatter_bucket_vector(
                    o, xs[0], lb(xs[0], xs[1])), None),
                out, (g.stack, pred))[0]
    return out


# --------------------------------------------------------------------------
# Losses / predictions
# --------------------------------------------------------------------------


def user_losses(user_emb: jax.Array, item_emb: jax.Array,
                gramian: jax.Array, by_user, num_users: int, uobs: float,
                *, halve: bool, dtype=None) -> jax.Array:
    """Per-user losses (reference ials.h:70-86 / safer2.h:85-101):

    L_u = sum_h (v^T u - 1)^2 / |H_u| + uobs * u^T G u   [ / 2 if halve ]

    The blockwise models' reference computes the observed part from the
    flat prediction cache (safer2pp.h:80-95); here predictions are
    always recomputed — same values, one row gather + multiply-reduce
    pass. Absent users keep loss 0.

    One implementation: this is ``gather_and_losses`` with slab-keeping
    disabled (budget 0 forces the re-gather path and a None pre_list).
    """
    return gather_and_losses(item_emb, by_user, user_emb, gramian,
                             num_users, uobs, halve=halve, dtype=dtype,
                             budget_bytes=0)[0]


# Keep the loss pass's gathered [N, L, d] slabs alive for reuse by the
# following U-sweep only when they all fit comfortably in device memory
# (they must stay live across the global xi/z barrier). Above this, fall
# back to re-gathering inside the (serialized, budget-capped) solve
# groups. Bytes on a 16 GiB device, scaled by ``mesh.memory_budget``.
FUSE_BUDGET_BYTES = 4 << 30


def gather_and_losses(table_other: jax.Array, buckets, probe_table,
                      gramian: jax.Array, num_rows: int, uobs: float, *,
                      halve: bool, dtype=None,
                      budget_bytes: int = None):
    """Per-row losses of the *carried* model, fused with the U-sweep.

    Computes the same per-user losses as ``user_losses`` (reference
    ials.h:70-86 / safer2.h:85-101) but returns the gathered history
    slabs for ``solve_sweep(pre_list=...)`` so the following U-sweep
    reuses them — the loss pass's table gather was one third of the
    epoch's gather traffic (the models shift the reference's
    end-of-epoch ComputeUserLoss to the top of the next pd iteration,
    where it reads the same frozen tables the U-step does; the update
    sequence is unchanged — see SAFER2._epoch).

    Returns ``(loss [num_rows], pre_list or None)``; ``pre_list`` aligns
    with ``group_same_shape(buckets)`` (stacked groups carry stacked
    slabs), the layout ``solve_sweep(pre_list=...)`` consumes.
    """
    dim = table_other.shape[1]
    bytes_per = 2 if dtype is not None else 4
    # Wide (streamed) buckets never keep slabs; they don't disable the
    # fusion for everyone else, they just get a None pre entry.
    total = sum(b.n_rows * b.width for b in buckets
                if not assemble.is_wide(b, dim)) * dim * bytes_per
    if budget_bytes is None:
        budget_bytes = memory_budget(FUSE_BUDGET_BYTES)
    keep = total <= budget_bytes
    out = jnp.zeros((num_rows,), jnp.float32)
    pre = [] if keep else None

    def piece(b):
        x = assemble.read_rows(probe_table, b)
        if assemble.is_wide(b, dim):
            t = table_other if dtype is None else table_other.astype(dtype)
            obs = assemble.wide_obs(t, b, x) / safe_len(b)
            emb = mask = None
        else:
            emb, mask = assemble.gather_history(table_other, b, dtype)
            p = assemble.rowwise_dot(emb, x)
            obs = jnp.sum(jnp.square(p - 1.0) * mask, axis=1) / safe_len(b)
        quad = uobs * jnp.einsum("nd,de,ne->n", x, gramian, x)
        loss = obs + quad
        if halve:
            loss = loss * 0.5
        return loss, emb, mask

    for g in group_same_shape(buckets):
        g_wide = assemble.is_wide(g, dim)
        if isinstance(g, BucketStack):
            def body(o, b):
                loss, emb, mask = piece(tie_bucket(b, o))
                o = assemble.scatter_bucket_vector(o, b, loss)
                return o, ((emb, mask) if (keep and not g_wide) else 0)
            out, ys = jax.lax.scan(body, out, g.stack)
            if keep:
                pre.append(None if g_wide else ys)
        else:
            loss, emb, mask = piece(tie_bucket(g, out))
            out = assemble.scatter_bucket_vector(out, g, loss)
            if keep:
                pre.append(None if g_wide else (emb, mask))
    return out, pre


def ials_reg(length: jax.Array, num_choices: int, reg: float,
             reg_exp: float, uobs: float) -> jax.Array:
    """Frequency-scaled regularizer reg*(|H| + uobs*n)^exp
    (reference ials.h:310-315)."""
    base = length.astype(jnp.float32) + uobs * num_choices
    if reg_exp == 1.0:
        return reg * base
    return reg * jnp.power(base, reg_exp)


def normal_init(key: jax.Array, rows: int, dim: int,
                stdev: float) -> jax.Array:
    """N(0, stdev/sqrt(dim)) init (reference recommender.h:61-67 with the
    adjusted stdev of ials.h:47)."""
    return jax.random.normal(key, (rows, dim), dtype=jnp.float32) * (
        stdev / (dim ** 0.5))

"""Normal-equation assembly over padded buckets.

This module replaces the reference's per-user streaming rank-128 updates
(reference ials.h:107-131: ``matrix_symm.rankUpdate(factor_batch)`` inside
a thread-pool loop) with *batched* matmul work: for a bucket of N rows whose
histories are padded to L columns,

    A_hist[n] = sum_{l < len(n)} v_{n,l} v_{n,l}^T
             == einsum('nld,nle->nde', Vh, Vh)        (one batched matmul)

The reference's tail-batch rankUpdate bug in three ProjectV variants
(safer2.h:203, erm_mf.h:190, cvar_mf.h:172 update the full 128-wide batch
including stale columns) is *not* reproduced: a vectorized masked einsum
has no tail, so we implement the correct math (see SURVEY.md section 5
quirk 1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from safer2_recommender_tpu.data.dataset import Bucket
from safer2_recommender_tpu.parallel.mesh import memory_budget


def history_mask(bucket: Bucket) -> jax.Array:
    """[N, L] float32 mask of valid (non-padding) history slots."""
    n, l = bucket.col_ids.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (n, l), 1)
    return (pos < bucket.length[:, None]).astype(jnp.float32)


def gather_history(table: jax.Array, bucket: Bucket,
                   dtype=None) -> Tuple[jax.Array, jax.Array]:
    """Gather the other-side embedding rows for each history slot.

    Returns (emb [N, L, d] *already masked*, mask [N, L]). When ``dtype``
    is bf16 the TABLE is cast before the gather (XLA CSEs the cast across
    a sweep's buckets), halving the random-row gather traffic — the
    dominant epoch cost at large dim once the solves are fast.
    """
    mask = history_mask(bucket)
    if dtype is not None:
        table = table.astype(dtype)
    emb = table[bucket.col_ids] * mask[..., None].astype(table.dtype)
    return emb, mask


def gather_history_extra(table: jax.Array, vec: jax.Array, bucket: Bucket,
                         dtype=None
                         ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Fused row gather of the embedding rows AND a per-row scalar.

    Returns (emb [N, L, d] masked, mask [N, L], extra [N, L] f32 masked)
    where ``extra[n, l] = vec[col_ids[n, l]]``. The scalar rides as an
    extra column of the gathered table, so one row gather serves both
    instead of a second element gather ``vec[bucket.col_ids]``. The
    concatenated table is identical across a sweep's buckets and CSE'd
    by XLA.
    """
    if dtype is not None:
        table = table.astype(dtype)
    aug = jnp.concatenate([table, vec[:, None].astype(table.dtype)], axis=1)
    mask = history_mask(bucket)
    g = aug[bucket.col_ids] * mask[..., None].astype(aug.dtype)
    return g[..., :-1], mask, g[..., -1].astype(jnp.float32)


# --------------------------------------------------------------------------
# Column-chunked ("wide") assembly for very long histories
# --------------------------------------------------------------------------
#
# Hot items in power-law data have histories of 10^5..10^6 users (the
# zipf head; real MSD's top songs exceed 10^5 listeners). Materializing
# their [N, L, d] gathered slab is impossible (one width-2^20 bucket at
# dim 512 is ~8.6 GB), so rows whose slab would exceed WIDE_SLAB_BYTES
# stream their history through fixed-width column chunks instead — a
# lax.scan accumulating the normal-equation pieces, the batched
# equivalent of the reference's rank-128 streaming updates
# (ials.h:107-131).

WIDE_SLAB_BYTES = 768 << 20     # on a 16 GiB device; see wide_slab_bytes
WIDE_CHUNK = 4096


def wide_slab_bytes() -> int:
    """``WIDE_SLAB_BYTES`` scaled to this device's memory."""
    return memory_budget(WIDE_SLAB_BYTES)


def is_wide(bucket: Bucket, dim: int) -> bool:
    """Stream this bucket through column chunks?  Only when the *width*
    is the problem (width > dim keeps it off the Woodbury path; narrow
    slabs are already bounded by the build-time row chunking)."""
    return bucket.width > dim and (
        bucket.n_rows * bucket.width * (dim + 1) * 4 > wide_slab_bytes())


def _wide_chunks(table: jax.Array, vec: Optional[jax.Array],
                 bucket: Bucket, dtype=None):
    """Iterator state for column-chunked sweeps: returns (xs, gather_fn)
    where ``xs = (cols [C, N, W], offs [C])`` scans over column chunks
    and ``gather_fn(cols_c, off) -> (emb, mask, wt_extra)`` gathers one
    chunk (``wt_extra`` is None when ``vec`` is None)."""
    n, l = bucket.col_ids.shape
    w = min(WIDE_CHUNK, l)
    # Shrink the chunk width until one chunk's gathered slab actually
    # fits the budget: a bucket with dim < width <= WIDE_CHUNK can
    # trip is_wide while a single full-width "chunk" would materialize
    # the entire slab (no streaming at all).
    d_aug = table.shape[1] + (0 if vec is None else 1)
    while w > 256 and n * w * d_aug * 4 > wide_slab_bytes():
        w = (w + 1) // 2
    c = -(-l // w)
    cols = bucket.col_ids
    if c * w != l:
        cols = jnp.pad(cols, ((0, 0), (0, c * w - l)))
    cols = cols.reshape(n, c, w).transpose(1, 0, 2)          # [C, N, W]
    offs = jnp.arange(c, dtype=jnp.int32) * w

    if dtype is not None:
        table = table.astype(dtype)
    aug = table if vec is None else jnp.concatenate(
        [table, vec[:, None].astype(table.dtype)], axis=1)

    def gather_fn(cols_c, off):
        pos = jax.lax.broadcasted_iota(jnp.int32, (n, w), 1) + off
        mask = (pos < bucket.length[:, None]).astype(jnp.float32)
        g = aug[cols_c] * mask[..., None].astype(aug.dtype)
        if vec is None:
            return g, mask, None
        return g[..., :-1], mask, g[..., -1].astype(jnp.float32)

    return (cols, offs), gather_fn


def wide_assemble(table: jax.Array, bucket: Bucket,
                  extra_vec: Optional[jax.Array] = None,
                  dtype=None, row_coef: Optional[jax.Array] = None,
                  init_a: Optional[jax.Array] = None
                  ) -> Tuple[jax.Array, jax.Array]:
    """Streamed ``(sum_h wt v v^T, sum_h wt v)`` over column chunks with
    ``wt = mask`` (or ``extra[col] * mask`` when ``extra_vec`` given).

    ``row_coef`` ([N]) folds a per-row coefficient into the chunk
    weights (same numerics as the non-wide path's ``wt = coef * mask``)
    and ``init_a`` ([N, d, d]) seeds the accumulator — together they
    replace what used to be two/three extra full memory-bound passes
    over the [N, d, d] slab (post-scale by coef, then add c1*G)."""
    n = bucket.n_rows
    d = table.shape[1]
    xs, gather_fn = _wide_chunks(table, extra_vec, bucket, dtype)

    def body(carry, x):
        a, rhs = carry
        cols_c, off = x
        emb, mask, wt = gather_fn(cols_c, off)
        wt = mask if wt is None else wt
        if row_coef is not None:
            wt = wt * row_coef[:, None]
        a = a + row_gramians(emb, col_weight=wt)
        rhs = rhs + row_sums(emb, col_weight=wt)
        return (a, rhs), None

    init = (jnp.zeros((n, d, d), jnp.float32) if init_a is None else init_a,
            jnp.zeros((n, d), jnp.float32))
    (a, rhs), _ = jax.lax.scan(body, init, xs)
    return a, rhs


def wide_matvec(table: jax.Array, bucket: Bucket, x: jax.Array,
                extra_vec: Optional[jax.Array] = None,
                dtype=None) -> Tuple[jax.Array, jax.Array]:
    """Streamed ``(sum_h wt v (v.x), sum_h wt v)`` (the history terms of
    A @ x and rhs) for the gradient models."""
    n = bucket.n_rows
    d = table.shape[1]
    xs, gather_fn = _wide_chunks(table, extra_vec, bucket, dtype)

    def body(carry, xc):
        ax, rhs = carry
        cols_c, off = xc
        emb, mask, wt = gather_fn(cols_c, off)
        wt = mask if wt is None else wt
        p = rowwise_dot(emb, x)
        ax = ax + row_sums(emb, col_weight=wt * p)
        rhs = rhs + row_sums(emb, col_weight=wt)
        return (ax, rhs), None

    init = (jnp.zeros((n, d), jnp.float32), jnp.zeros((n, d), jnp.float32))
    (ax, rhs), _ = jax.lax.scan(body, init, xs)
    return ax, rhs


def wide_gram_resid(table: jax.Array, bucket: Bucket,
                    x_full: jax.Array,
                    extra_vec: Optional[jax.Array] = None,
                    dtype=None) -> Tuple[jax.Array, jax.Array]:
    """Streamed FULL normal-equation pieces for the blockwise models'
    zipf-head rows:

        S  = sum_h wt v v^T            [N, d, d]
        r0 = sum_h wt v (pred0 - 1)    [N, d],  pred0 = <v, x_full>

    with ``wt = mask`` (or ``extra[col] * mask``). Wide rows are few
    (hot items), so [N, d, d] fits while their [N, L, d] slab does not;
    every block system of the sweep is then a pure slice of (S, r0):
    since pred is linear in x with the other side frozen,
    ``sum_h wt v_loc (pred - 1) = r0_loc + (S @ (x - x0))_loc``. One
    streamed pass therefore serves all d/bs block solves — the streamed
    per-block variant re-read the whole history d/bs times
    (models/common.py::block_sweep_frozen consumes this).
    """
    n = bucket.n_rows
    d = table.shape[1]
    xs, gather_fn = _wide_chunks(table, extra_vec, bucket, dtype)

    def body(carry, xc):
        s_acc, r0 = carry
        cols_c, off = xc
        emb, mask, wt = gather_fn(cols_c, off)
        wt = mask if wt is None else wt
        p = rowwise_dot(emb, x_full)
        s_acc = s_acc + row_gramians(emb, col_weight=wt)
        r0 = r0 + row_sums(emb, col_weight=wt * (p - mask))
        return (s_acc, r0), None

    init = (jnp.zeros((n, d, d), jnp.float32),
            jnp.zeros((n, d), jnp.float32))
    (s_acc, r0), _ = jax.lax.scan(body, init, xs)
    return s_acc, r0


def wide_obs(table: jax.Array, bucket: Bucket, probe_rows: jax.Array,
             dtype=None) -> jax.Array:
    """Streamed per-row ``sum_h (v.u - 1)^2`` for the loss pass."""
    xs, gather_fn = _wide_chunks(table, None, bucket, dtype)

    def body(acc, xc):
        cols_c, off = xc
        emb, mask, _ = gather_fn(cols_c, off)
        p = rowwise_dot(emb, probe_rows)
        return acc + jnp.sum(jnp.square(p - 1.0) * mask, axis=1), None

    init = jnp.zeros((bucket.n_rows,), jnp.float32)
    return jax.lax.scan(body, init, xs)[0]


def row_gramians(emb: jax.Array, col_weight: Optional[jax.Array] = None,
                 out_dtype=jnp.float32) -> jax.Array:
    """Batched sum of outer products: [N, L, d] -> [N, d, d].

    ``col_weight`` ([N, L]) applies per-interaction weights w (the
    reference multiplies factors by sqrt(w) before rankUpdate,
    safer2.h:192; weighting one einsum operand is the same quadratic
    form without the sqrt round-trip). The weight is cast to the
    embedding dtype so a bf16 assembly stays bf16 in the matmul.
    """
    lhs = emb if col_weight is None else (
        emb * col_weight[..., None].astype(emb.dtype))
    return jnp.einsum("nld,nle->nde", lhs, emb,
                      preferred_element_type=out_dtype)


def row_sums(emb: jax.Array, col_weight: Optional[jax.Array] = None,
             out_dtype=jnp.float32) -> jax.Array:
    """Batched rhs accumulation: [N, L, d] -> [N, d] (f32 accumulation).

    Contracts L against a ones vector (one non-batched dot_general)
    instead of ``jnp.sum(lhs.astype(f32))``: the astype materialized a
    second, twice-as-wide copy of the slab that the reduce then re-read.
    The dot reads the bf16 slab once and accumulates in f32.
    """
    lhs = emb if col_weight is None else (
        emb * col_weight[..., None].astype(emb.dtype))
    ones = jnp.ones((emb.shape[1],), lhs.dtype)
    return jax.lax.dot_general(
        lhs, ones, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=out_dtype)


def rowwise_dot(emb: jax.Array, vec: jax.Array) -> jax.Array:
    """Per-slot dots: [N, L, d] x [N, d] -> [N, L].

    Implemented as broadcast multiply + reduce instead of
    ``einsum('nld,nd->nl')``, which XLA may lower to a batched
    per-element mat-vec with a fixed per-element cost; the elementwise
    form is bound by the slab's bytes instead.
    """
    return jnp.sum(emb * vec[:, None, :], axis=2)


def scatter_rows(table: jax.Array, row_ids: jax.Array,
                 values: jax.Array) -> jax.Array:
    """Write solved rows back; padded row_ids are out of bounds -> dropped.

    Replaces the reference's mutex-guarded ``get_user_embedding_ref(u) =
    new_user_emb`` write-back (ials.h:352-354).

    Prefer ``scatter_bucket`` when a ``Bucket`` is in hand — contiguous
    buckets write back with ``dynamic_update_slice`` and bypass the
    scatter lowering entirely.
    """
    return table.at[row_ids].set(values.astype(table.dtype), mode="drop")


def _use_contig(bucket: Bucket) -> bool:
    import os
    return bucket.contiguous and os.environ.get("FRT_NO_CONTIG") != "1"


def read_rows(table: jax.Array, bucket: Bucket) -> jax.Array:
    """``table[bucket.row_ids]`` — a slice (not a gather) for contiguous
    solver-order buckets. Padded rows read whatever follows the bucket's
    range; their solves are garbage either way and the masked write-back
    drops them."""
    if _use_contig(bucket):
        return jax.lax.dynamic_slice(
            table, (bucket.row_start,) + (0,) * (table.ndim - 1),
            (bucket.n_rows,) + table.shape[1:])
    return table[bucket.row_ids]


def scatter_bucket(table: jax.Array, bucket: Bucket,
                   values: jax.Array) -> jax.Array:
    """Bucket-aware write-back (see ``scatter_rows``): contiguous
    buckets do a masked read-modify-write ``dynamic_update_slice`` at
    memcpy-class bandwidth instead of a scatter; the [N] mask
    keeps padded rows at their current table values, so pad overhang
    into the next bucket's rows is harmless."""
    if _use_contig(bucket):
        start = (bucket.row_start,) + (0,) * (table.ndim - 1)
        cur = jax.lax.dynamic_slice(
            table, start, (bucket.n_rows,) + table.shape[1:])
        mask = (bucket.length > 0).reshape(
            (-1,) + (1,) * (table.ndim - 1))
        vals = jnp.where(mask, values.astype(table.dtype), cur)
        return jax.lax.dynamic_update_slice(table, vals, start)
    return scatter_rows(table, bucket.row_ids, values)


def scatter_vector(vec: jax.Array, row_ids: jax.Array,
                   values: jax.Array) -> jax.Array:
    return vec.at[row_ids].set(values.astype(vec.dtype), mode="drop")


def scatter_bucket_vector(vec: jax.Array, bucket: Bucket,
                          values: jax.Array) -> jax.Array:
    """Bucket-aware per-row scalar write-back (same contract as
    ``scatter_bucket``)."""
    if _use_contig(bucket):
        cur = jax.lax.dynamic_slice(vec, (bucket.row_start,),
                                    (bucket.n_rows,))
        vals = jnp.where(bucket.length > 0, values.astype(vec.dtype), cur)
        return jax.lax.dynamic_update_slice(vec, vals,
                                            (bucket.row_start,))
    return scatter_vector(vec, bucket.row_ids, values)


# NOTE: there is deliberately NO per-tuple prediction cache here. The
# reference's flat rating-indexed cache (ialspp.h:399-406,
# safer2pp.h:504-508) exists to avoid recomputing full dots on a CPU;
# on a device its by-item accesses are per-ELEMENT gathers/scatter-adds
# where row gathers move whole embedding rows, so the blockwise models
# recompute predictions from the live tables instead
# (models/common.py::block_sweep_frozen).

"""Data layer: CSV ingest -> device-resident bucketed COO/CSR.

Reference parity
----------------
The reference ingests a 2-column ``uid,sid`` CSV (header discarded) into
dual sparse indexes ``by_user[u] = [(item, rating_index)...]`` and
``by_item[i] = [(user, rating_index)...]`` where ``rating_index`` is the
global tuple position keying the blockwise models' flat per-tuple
prediction cache (reference include/frecsys/dataset.h:71-99,
ialspp.h:210-216). That cache — and with it any per-tuple indexing — is
deliberately absent here: per-tuple (element) gathers/scatters move one
value where row gathers move whole embedding rows, so the blockwise models
recompute predictions from the live tables instead
(models/common.py::block_sweep_frozen). Both adjacency views
carry only (row, col, length).

Device design
-------------
Ragged per-row histories (5..10^3+ interactions) are the central layout
problem: compiled XLA programs need static shapes. We bucket
rows by history length into power-of-two padded tiles:

  Bucket(row_ids[N], col_ids[N, L], length[N])

Every per-row computation then becomes a *batched* einsum / Cholesky over
the bucket, compiled once per (N, L) shape. Padding conventions:

  * padded rows:    row_ids == num_rows (out of bounds -> scatter drops),
                    length == 0
  * padded columns: col_ids == 0 (masked via length)

On a device mesh, bucket rows are sharded over the "data" axis; the
embedding tables stay replicated (catalog sides are small for these
workloads) and XLA inserts the Gramian all-reduces.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from safer2_recommender_tpu.parallel import mesh as mesh_lib

_log = logging.getLogger("safer2_recommender_tpu")


# --------------------------------------------------------------------------
# Host-side dataset
# --------------------------------------------------------------------------


def _read_csv_native(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    from safer2_recommender_tpu.native import build as native_build

    lib = native_build.load()
    if lib is None:
        return None
    import ctypes

    n = lib.frt_csv_count(path.encode())
    if n < 0:
        return None
    users = np.empty(n, dtype=np.int32)
    items = np.empty(n, dtype=np.int32)
    got = lib.frt_csv_read(
        path.encode(),
        users.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        items.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
    )
    if got != n:
        return None
    return users, items


def _read_csv_python(path: str) -> Tuple[np.ndarray, np.ndarray]:
    try:
        import pandas as pd

        df = pd.read_csv(path, dtype=np.int32)
        cols = df.columns
        return (df[cols[0]].to_numpy(np.int32),
                df[cols[1]].to_numpy(np.int32))
    except ImportError:
        arr = np.loadtxt(path, dtype=np.int32, delimiter=",", skiprows=1,
                         ndmin=2)
        return arr[:, 0].astype(np.int32), arr[:, 1].astype(np.int32)


class Dataset:
    """Host-side interaction set as COO arrays in file tuple order.

    Equivalent surface to reference Dataset (dataset.h:24-69):
    ``num_users``/``num_items`` are ``max id + 1`` (id gaps keep embedding
    rows, matching the reference's table sizing in run_model.cc:240).
    """

    def __init__(self, user_ids: np.ndarray, item_ids: np.ndarray):
        assert user_ids.shape == item_ids.shape
        self.user_ids = np.ascontiguousarray(user_ids, dtype=np.int32)
        self.item_ids = np.ascontiguousarray(item_ids, dtype=np.int32)
        self.nnz = int(user_ids.shape[0])
        self.max_user = int(user_ids.max()) if self.nnz else -1
        self.max_item = int(item_ids.max()) if self.nnz else -1
        self.num_users = self.max_user + 1
        self.num_items = self.max_item + 1
        # bincount>0 beats np.unique's O(n log n) re-sort for the
        # distinct counts (several seconds at MSD scale)
        _log.info(
            "max_user=%d\tmax_item=%d\tdistinct user=%d\tdistinct item=%d"
            "\tnum_tuples=%d",
            self.max_user, self.max_item,
            int((np.bincount(self.user_ids,
                             minlength=self.num_users) > 0).sum()),
            int((np.bincount(self.item_ids,
                             minlength=self.num_items) > 0).sum()),
            self.nnz,
        )

    @classmethod
    def from_csv(cls, path: str) -> "Dataset":
        """Read a 2-column uid,sid CSV (reference dataset.h:71-99).

        A missing ``foo.csv`` falls back to ``foo.csv.gz`` (the in-repo
        ML-1M test fixture ships gzipped); the mmap native reader only
        handles plain files, gz goes through pandas/numpy.
        """
        import os

        if not os.path.exists(path) and os.path.exists(path + ".gz"):
            return cls(*_read_csv_python(path + ".gz"))
        out = _read_csv_native(path)
        if out is None:
            out = _read_csv_python(path)
        return cls(*out)

    def num_tuples(self) -> int:
        return self.nnz


# --------------------------------------------------------------------------
# Bucketed device layout
# --------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Bucket:
    """A padded tile of rows whose histories all fit in ``L`` columns.

    ``contiguous`` buckets (produced by ``DeviceData.build``'s
    solver-order renumbering) own the table row range
    ``[row_start, row_start + real rows)``: row reads become slices and
    write-backs become masked ``dynamic_update_slice``s at memcpy-class
    bandwidth instead of scatters. ``row_ids`` stays authoritative
    either way (real rows are ``row_start + arange``; pads follow).
    """

    row_ids: jax.Array    # [N] int32; padded rows == num_rows (drop)
    col_ids: jax.Array    # [N, L] int32; padded cols == 0 (masked)
    length: jax.Array     # [N] int32; 0 on padded rows
    row_start: Optional[jax.Array] = None   # scalar i32 (contiguous only)
    contiguous: bool = dataclasses.field(
        default=False, metadata=dict(static=True))

    @property
    def n_rows(self) -> int:
        return self.row_ids.shape[0]

    @property
    def width(self) -> int:
        return self.col_ids.shape[1]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bucket_edges(max_len: int, min_bucket: int,
                  growth: int) -> Sequence[int]:
    if min_bucket < 1 or growth < 2:
        raise ValueError(
            f"min_bucket >= 1 and growth >= 2 required (got {min_bucket}, "
            f"{growth}); the width ladder must strictly grow")
    edges = []
    e = min_bucket
    while True:
        edges.append(e)
        if e >= max_len:
            break
        e *= growth
    return edges


def _build_buckets(
    sorted_rows: np.ndarray,      # [nnz] row id per tuple, sorted ascending
    sorted_cols: np.ndarray,      # [nnz] col id per tuple (same order)
    num_rows: int,
    min_bucket: int,
    row_multiple: int,
    growth: int,
    max_rows: int = 0,
    max_tuples: int = 0,
):
    """Group rows by history length into padded tiles whose widths grow
    by ``growth`` per bucket. A coarser ladder (growth=4) pads more tuples
    (~2.1x vs ~1.4x on ML-1M) but quarters the number of per-bucket op
    chains in every sweep — the right trade when epochs are bound by
    host-side dispatch (small dim) rather than device FLOPs/bandwidth.

    ``max_rows``/``max_tuples`` (0 = unbounded) split oversized buckets
    into row chunks so a sweep never materializes more than a bounded
    slab of [rows, d, d] normal equations / [rows, L, d] gathered
    embeddings. Required beyond ML-1M scale: MSD (571k users, dim 512)
    would otherwise need ~600GB for one bucket's batched systems — the
    reference instead streams one user at a time (ials.h:326-361).
    """
    if sorted_rows.size == 0:
        return ()
    # rows are already sorted: run-length detection instead of
    # np.unique (which re-sorts — ~6s of the MSD-scale build time)
    change = np.empty(sorted_rows.size, dtype=bool)
    change[0] = True
    np.not_equal(sorted_rows[1:], sorted_rows[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    uniq = sorted_rows[starts]
    counts = np.diff(np.append(starts, sorted_rows.size))
    max_len = int(counts.max())
    edges = _bucket_edges(max_len, min_bucket, growth)

    buckets = []
    prev = 0
    for edge in edges:
        sel = (counts > prev) & (counts <= edge)
        prev = edge
        ids = uniq[sel]
        if ids.size == 0:
            continue
        st = starts[sel]
        ct = counts[sel]
        chunk = ids.size
        if max_rows > 0:
            chunk = min(chunk, max_rows)
        if max_tuples > 0:
            chunk = min(chunk, max(max_tuples // edge, row_multiple))
        chunk = _round_up(chunk, row_multiple)
        for lo in range(0, ids.size, chunk):
            hi = min(lo + chunk, ids.size)
            n = hi - lo
            n_pad = _round_up(n, row_multiple)
            row_ids = np.full(n_pad, num_rows, dtype=np.int32)
            row_ids[:n] = ids[lo:hi]
            length = np.zeros(n_pad, dtype=np.int32)
            length[:n] = ct[lo:hi]
            col_ids = np.zeros((n_pad, edge), dtype=np.int32)
            # Vectorized ragged fill: flat (row, offset-within-row) pairs.
            cts = ct[lo:hi]
            row_of = np.repeat(np.arange(n), cts)
            off = _segment_arange(cts)
            gidx = np.repeat(st[lo:hi], cts) + off
            col_ids[row_of, off] = sorted_cols[gidx]
            buckets.append(
                Bucket(
                    row_ids=jnp.asarray(row_ids),
                    col_ids=jnp.asarray(col_ids),
                    length=jnp.asarray(length),
                ))
    return tuple(buckets)


def _segment_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0-1, 0..c1-1, ...] without a Python loop."""
    total = int(counts.sum())
    ends = np.cumsum(counts)
    out = np.arange(total, dtype=np.int64)
    out -= np.repeat(ends - counts, counts)
    return out


def _solver_order(buckets, num_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """Solver-order renumbering of one side's ids.

    New id = position of the row in the concatenation of the built
    buckets' real rows (so every bucket owns a contiguous id range);
    ids absent from every bucket (history-less gap ids, reference
    safer2.h:827-830 keeps vector slots for them) follow in old-id
    order. Returns ``(perm old->new, order new->old)``.
    """
    parts = []
    for b in buckets:
        r = np.asarray(b.row_ids)
        n = int(np.asarray(b.length).astype(bool).sum())
        parts.append(r[:n])
    active = (np.concatenate(parts) if parts
              else np.zeros(0, np.int64)).astype(np.int64)
    perm = np.full(num_rows, -1, np.int64)
    perm[active] = np.arange(active.size)
    gaps = np.flatnonzero(perm < 0)
    perm[gaps] = active.size + np.arange(gaps.size)
    order = np.empty(num_rows, np.int64)
    order[perm] = np.arange(num_rows)
    return perm.astype(np.int32), order.astype(np.int32)


def _renumber_buckets(buckets, perm_other: np.ndarray,
                      num_rows: int) -> Tuple[Bucket, ...]:
    """Rewrite one side's buckets into solver order: row ids become the
    bucket's contiguous range (``contiguous=True`` when the padded
    window fits the table — only the last bucket's pad can overhang,
    which keeps the scatter fallback), col ids map through the OTHER
    side's permutation."""
    out, start = [], 0
    for b in buckets:
        n = int(np.asarray(b.length).astype(bool).sum())
        row_ids = np.full(b.n_rows, num_rows, dtype=np.int32)
        row_ids[:n] = start + np.arange(n, dtype=np.int32)
        col_ids = perm_other[np.asarray(b.col_ids)].astype(np.int32)
        contig = start + b.n_rows <= num_rows
        out.append(Bucket(
            row_ids=jnp.asarray(row_ids),
            col_ids=jnp.asarray(col_ids),
            length=b.length,
            row_start=jnp.int32(start) if contig else None,
            contiguous=contig,
        ))
        start += n
    return tuple(out)


# One [rows, d, d] slab's budget on a 16 GiB device (scaled to the
# device's memory by ``mesh_lib.memory_budget``).
BUCKET_BUDGET_BYTES = 2 << 30


def _bucket_budgets(dim: int, budget_bytes: Optional[int]
                    ) -> Tuple[int, int]:
    """Per-bucket row/tuple caps from the embedding dim (0 = no cap);
    ``budget_bytes`` None means ``BUCKET_BUDGET_BYTES`` scaled to the
    device.

    Caps the two big per-bucket intermediates: the batched normal
    equations [rows, d, d] (plus ~2 live copies in the solver) and the
    gathered history embeddings [rows, L, d] (~2 copies with the masked
    product)."""
    if dim <= 0:
        return 0, 0
    if budget_bytes is None:
        budget_bytes = mesh_lib.memory_budget(BUCKET_BUDGET_BYTES)
    # One [rows, d, d] slab of ``budget`` bytes; solver copies live in the
    # remaining device memory (groups are serialized, models/common.py).
    max_rows = max(budget_bytes // (dim * dim * 4), 64)
    max_tuples = max(budget_bytes // (2 * dim * 4), 4096)
    return int(max_rows), int(max_tuples)


def _csr_views(ids: np.ndarray, other: np.ndarray):
    """Group tuples by ``ids``; returns (grouped ids, other).

    Within-group order is free: a row's history is a SET — bucket
    assembly only segment-sums over it, so column order never changes
    the math (only float summation order, at ULP level). That buys two
    host-time wins at MSD scale (~20M tuples, one core): the by-user
    view is usually already grouped (CSV order / generators emit
    user-major) and costs one O(n) check, and the by-item view can use
    introsort argsort (~2x numpy's stable radix at 20M keys)."""
    if ids.size == 0 or bool((ids[1:] >= ids[:-1]).all()):
        return ids, other
    order = np.argsort(ids)
    return ids[order], other[order]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceData:
    """Device-resident training dataset (both adjacency views).

    ``user_hist_size``/``item_hist_size`` are float vectors with 0 at id
    gaps (reference safer2.h:827-830). ``item_reg`` is the SAFER-family
    per-item regularization statistic sum(1/|H_u|) over the item's users
    (reference safer2.h:831-837, erm_mf.h:580-586).
    """

    by_user: Tuple[Bucket, ...]
    by_item: Tuple[Bucket, ...]
    user_hist_size: jax.Array   # [num_users] f32 (solver order)
    item_hist_size: jax.Array   # [num_items] f32 (solver order)
    item_reg: jax.Array         # [num_items] f32 (solver order)
    num_users: int = dataclasses.field(metadata=dict(static=True))
    num_items: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    # Solver-order renumbering (see _solver_order): every per-row array
    # in this structure — and every model table/vector trained against
    # it — lives in PERMUTED (solver-order) id space. perm maps
    # original -> solver ids, order maps back. Evaluation data built in
    # original id space is remapped model-side (models/base.py::
    # _permute_fold); serving decodes item ids through item_order.
    user_perm: Optional[jax.Array] = None    # [num_users] i32 old->new
    item_perm: Optional[jax.Array] = None    # [num_items] i32 old->new
    user_order: Optional[jax.Array] = None   # [num_users] i32 new->old
    item_order: Optional[jax.Array] = None   # [num_items] i32 new->old

    @classmethod
    def build(
        cls,
        ds: Dataset,
        mesh=None,
        num_users: Optional[int] = None,
        num_items: Optional[int] = None,
        min_bucket: int = 8,
        row_multiple: int = 8,
        growth: int = 2,
        dim: int = 0,
        memory_budget_bytes: Optional[int] = None,
    ) -> "DeviceData":
        num_users = num_users or ds.num_users
        num_items = num_items or ds.num_items
        row_multiple = row_multiple * mesh_lib.num_shards(mesh)
        max_rows, max_tuples = _bucket_budgets(dim, memory_budget_bytes)

        u_rows, u_cols = _csr_views(ds.user_ids, ds.item_ids)
        by_user = _build_buckets(
            u_rows, u_cols, num_users,
            min_bucket, row_multiple, growth, max_rows, max_tuples)

        i_rows, i_cols = _csr_views(ds.item_ids, ds.user_ids)
        by_item = _build_buckets(
            i_rows, i_cols, num_items,
            min_bucket, row_multiple, growth, max_rows, max_tuples)

        # Solver-order renumbering: each bucket's rows become a
        # contiguous table range (write-backs become dynamic_update_
        # slice instead of scatter — see Bucket.contiguous).
        perm_u, order_u = _solver_order(by_user, num_users)
        perm_i, order_i = _solver_order(by_item, num_items)
        by_user = _renumber_buckets(by_user, perm_i, num_users)
        by_item = _renumber_buckets(by_item, perm_u, num_items)

        # bincount ≈ 10x faster than np.add.at at MSD scale
        uh = np.bincount(ds.user_ids,
                         minlength=num_users).astype(np.float32)
        ih = np.bincount(ds.item_ids,
                         minlength=num_items).astype(np.float32)
        ireg = np.bincount(ds.item_ids, weights=1.0 / uh[ds.user_ids],
                           minlength=num_items).astype(np.float32)

        dd = cls(
            by_user=by_user,
            by_item=by_item,
            user_hist_size=jnp.asarray(uh[order_u]),
            item_hist_size=jnp.asarray(ih[order_i]),
            item_reg=jnp.asarray(ireg[order_i]),
            num_users=num_users,
            num_items=num_items,
            nnz=ds.nnz,
            user_perm=jnp.asarray(perm_u),
            item_perm=jnp.asarray(perm_i),
            user_order=jnp.asarray(order_u),
            item_order=jnp.asarray(order_i),
        )
        if mesh is not None:
            dd = dd.shard(mesh)
        return dd

    def shard(self, mesh) -> "DeviceData":
        """Shard bucket rows over the mesh data axis; vectors replicated.

        Sharded buckets KEEP the contiguous fast path (round 4): the
        8-device collective audit and the sharded-vs-single equivalence
        suite pass with it, and the per-device XLA cost model reads
        slightly FEWER bytes than the scatter lowering (0.24 vs 0.25 of
        the 1-device program at the 8k/256 probe shape — no replication
        blowup from the spanning dynamic-update-slice window).
        FRT_SHARD_CONTIG=0 restores the scatter path for A/Bs on real
        multi-chip hardware.
        """
        import os

        rep = mesh_lib.replicated(mesh)
        keep_contig = os.environ.get("FRT_SHARD_CONTIG") != "0"
        shard_bucket = lambda b: Bucket(
            row_ids=mesh_lib.put(b.row_ids, mesh_lib.row_sharding(mesh, 1)),
            col_ids=mesh_lib.put(b.col_ids, mesh_lib.row_sharding(mesh, 2)),
            length=mesh_lib.put(b.length, mesh_lib.row_sharding(mesh, 1)),
            row_start=(mesh_lib.put(b.row_start, rep)
                       if keep_contig and b.contiguous else None),
            contiguous=keep_contig and b.contiguous,
        )
        return dataclasses.replace(
            self,
            by_user=tuple(shard_bucket(b) for b in self.by_user),
            by_item=tuple(shard_bucket(b) for b in self.by_item),
            user_hist_size=mesh_lib.put(self.user_hist_size, rep),
            item_hist_size=mesh_lib.put(self.item_hist_size, rep),
            item_reg=mesh_lib.put(self.item_reg, rep),
            user_perm=mesh_lib.put(self.user_perm, rep),
            item_perm=mesh_lib.put(self.item_perm, rep),
            user_order=mesh_lib.put(self.user_order, rep),
            item_order=mesh_lib.put(self.item_order, rep),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FoldInData:
    """Held-out evaluation data ("strong generalization").

    Evaluation folds in *fresh* user embeddings from the held-out users'
    training interactions with item embeddings frozen, then scores the
    full catalog (reference ials.h:148-185, safer2.h:225-263). Eval users
    get compact row ids 0..n_eval-1 (the reference's ``user_to_ind`` map,
    recommender.h:82).

    gt/excl are padded with ``num_items`` (never matches a real item).
    """

    by_user: Tuple[Bucket, ...]      # fold-in histories, compact rows
    excl: jax.Array                  # [n_pad, Hmax] i32 history (mask at eval)
    gt: jax.Array                    # [n_pad, Gmax] i32 ground-truth items
    gt_len: jax.Array                # [n_pad] i32 (0 => padded/skip row)
    hist_size: jax.Array             # [n_pad] f32 fold-in history sizes
    n_eval: int = dataclasses.field(metadata=dict(static=True))
    n_pad: int = dataclasses.field(metadata=dict(static=True))
    num_items: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def build(
        cls,
        tr: Dataset,
        te: Dataset,
        num_items: int,
        mesh=None,
        min_bucket: int = 8,
        row_multiple: int = 8,
        chunk: int = 1024,
        growth: int = 2,
        dim: int = 0,
        memory_budget_bytes: Optional[int] = None,
    ) -> "FoldInData":
        row_multiple = row_multiple * mesh_lib.num_shards(mesh)
        max_rows, max_tuples = _bucket_budgets(dim, memory_budget_bytes)
        uniq = np.unique(tr.user_ids)
        n_eval = uniq.size
        compact_u = np.searchsorted(uniq, tr.user_ids).astype(np.int32)
        n_pad = _round_up(max(n_eval, 1), max(chunk, row_multiple))

        u_rows, u_cols = _csr_views(compact_u, tr.item_ids)
        # The padded-row sentinel must be out of bounds of the PADDED
        # [n_pad, dim] fold-in table (not just past n_eval), or padded
        # rows' garbage solves would scatter into real table rows.
        by_user = _build_buckets(
            u_rows, u_cols, n_pad,
            min_bucket, row_multiple, growth, max_rows, max_tuples)

        counts = np.bincount(compact_u, minlength=n_eval)
        hmax = int(counts.max()) if n_eval else 1
        excl = np.full((n_pad, hmax), num_items, dtype=np.int32)
        order = np.argsort(compact_u, kind="stable")
        row_of = compact_u[order]
        off = _segment_arange(counts[counts > 0]) if n_eval else (
            np.zeros(0, dtype=np.int64))
        excl[row_of, off] = tr.item_ids[order]

        # ground truth (only te users that exist among tr users are
        # evaluated; the reference indexes metrics via the tr-built
        # user_to_ind map, recommender.h:109-117)
        te_mask = np.isin(te.user_ids, uniq)
        te_u = te.user_ids[te_mask]
        te_i = te.item_ids[te_mask]
        te_compact = np.searchsorted(uniq, te_u).astype(np.int32)
        gt_counts = np.bincount(te_compact, minlength=n_eval)
        gmax = int(gt_counts.max()) if gt_counts.size else 1
        gt = np.full((n_pad, max(gmax, 1)), num_items, dtype=np.int32)
        gorder = np.argsort(te_compact, kind="stable")
        grow = te_compact[gorder]
        goff = _segment_arange(gt_counts[gt_counts > 0]) if te_u.size else (
            np.zeros(0, dtype=np.int64))
        gt[grow, goff] = te_i[gorder]
        gt_len = np.zeros(n_pad, dtype=np.int32)
        gt_len[:n_eval] = gt_counts

        hist = np.zeros(n_pad, dtype=np.float32)
        hist[:n_eval] = counts

        fd = cls(
            by_user=by_user,
            excl=jnp.asarray(excl),
            gt=jnp.asarray(gt),
            gt_len=jnp.asarray(gt_len),
            hist_size=jnp.asarray(hist),
            n_eval=n_eval,
            n_pad=n_pad,
            num_items=num_items,
            nnz=tr.nnz,
        )
        if mesh is not None:
            # Shard the fold-in buckets like DeviceData.shard does for
            # training — without this the whole eval program (fold-in
            # solves, scoring matmul, top-k) compiled replicated: every
            # device redid all the work and eval did not scale at all
            # (found by auditing the eval path's collectives: zero).
            # The row-aligned metric arrays shard too; n_pad is rounded
            # to row_multiple * num_shards above so rows divide evenly.
            shard_bucket = lambda b: Bucket(
                row_ids=mesh_lib.put(b.row_ids,
                                     mesh_lib.row_sharding(mesh, 1)),
                col_ids=mesh_lib.put(b.col_ids,
                                     mesh_lib.row_sharding(mesh, 2)),
                length=mesh_lib.put(b.length,
                                    mesh_lib.row_sharding(mesh, 1)),
            )
            rows = lambda x: mesh_lib.put(
                x, mesh_lib.row_sharding(mesh, np.ndim(x)))
            fd = dataclasses.replace(
                fd,
                by_user=tuple(shard_bucket(b) for b in fd.by_user),
                excl=rows(fd.excl),
                gt=rows(fd.gt),
                gt_len=rows(fd.gt_len),
                hist_size=rows(fd.hist_size),
            )
        return fd

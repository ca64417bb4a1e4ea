"""Compile-once fixed-shape serving engine (beyond-reference).

``Recommender.recommend()`` builds a fresh ``FoldInData`` per call;
bucket widths and row counts follow each batch's histories, so every
novel shape pays full XLA compilation — fine for offline batch scoring,
wrong for a serving process. The reference has no serving surface at
all (``recommender.h`` can only score a fixed evaluation fold), so this
module has no counterpart to match; it exists because a framework that
advertises ``recommend()`` needs a production story for it.

``Server`` pads every request batch onto a small static shape ladder
(batch-size rung x history-width rung), AOT-compiles ONE program per
rung pair on first use (``jax.jit(...).lower(...).compile()``), and
reuses it forever: after warmup there are mechanically zero recompiles —
a compiled executable rejects any other shape, and ``num_compiles``
exposes the ladder size for tests/monitoring to assert on.

Id spaces: the solver-order item permutation (data/dataset.py::
_solver_order) is applied on the HOST while the batch is packed (one
int32 gather over the request's items), and the returned top-k ids are
decoded the same way — the device program never sees original ids and
no per-batch device-side fold remap (or its device-memory cache) exists on this
path.

``recommend_stream`` overlaps the host-side packing of batch k+1 with
device execution of batch k: dispatch is asynchronous, so building the
next batch before fetching the previous result hides the pack cost.
"""

from __future__ import annotations

import logging
from typing import Iterable, Iterator, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from safer2_recommender_tpu.data.dataset import (
    Bucket,
    Dataset,
    FoldInData,
    _round_up,
    _segment_arange,
)

_log = logging.getLogger("safer2_recommender_tpu")


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


class Server:
    """Fixed-shape serving over a trained model.

    Build AFTER training / checkpoint restore (it snapshots the model's
    id permutation; a later ``_note_perms`` with a different DeviceData
    is picked up lazily by identity). ``k``/``approx`` are baked into
    the compiled programs (see ``Recommender.recommend`` for the approx
    trade-off).
    """

    def __init__(self, model, k: int = 100, approx: bool = False,
                 batch_sizes: Tuple[int, ...] = (64, 512, 4096),
                 widths: Tuple[int, ...] = (32, 128, 512)):
        from safer2_recommender_tpu.parallel.mesh import num_shards

        self.model = model
        self.k = int(k)
        self.approx = bool(approx)
        # rung sizes must divide evenly over the mesh data axis (and the
        # eval-chunk logic wants multiples of 8 regardless)
        self._mult = 8 * num_shards(model.mesh)
        self.batch_sizes = tuple(sorted(
            {max(_round_up(int(b), self._mult), self._mult)
             for b in batch_sizes}))
        self.widths = tuple(sorted({int(w) for w in widths}))
        self._programs = {}
        self._perm_src = None
        self._perm = None
        self._order = None
        self._refresh_perm()

    # ---- id permutation (host-side) ---------------------------------------

    def _refresh_perm(self) -> None:
        src = getattr(self.model, "_item_perm", None)
        if src is self._perm_src:
            return
        from safer2_recommender_tpu.parallel.mesh import to_host

        self._perm_src = src
        if src is None:
            self._perm = self._order = None
        else:
            self._perm = to_host(src).astype(np.int32)
            self._order = to_host(
                self.model._item_order).astype(np.int32)

    # ---- shape ladder -------------------------------------------------------

    @property
    def num_compiles(self) -> int:
        """Distinct compiled programs so far. Steady-state serving must
        hold this constant — a compiled executable cannot retrace, so a
        growing count is the ONLY way a recompile can happen."""
        return len(self._programs)

    def _rung(self, ladder: Tuple[int, ...], x: int) -> int:
        for r in ladder:
            if x <= r:
                return r
        # beyond the ladder: next power of two (compiles once, then
        # cached like any other rung); logged because a production
        # ladder should be sized to its traffic
        r = max(_round_up(_next_pow2(x), self._mult), self._mult)
        _log.info("serving shape ladder extended to %d (request "
                  "exceeded %d)", r, ladder[-1])
        return r

    def _program(self, B: int, W: int):
        prog = self._programs.get((B, W))
        if prog is None:
            sds = jax.ShapeDtypeStruct
            shard = self._row_sharding
            bucket = Bucket(
                row_ids=sds((B,), jnp.int32, sharding=shard(1)),
                col_ids=sds((B, W), jnp.int32, sharding=shard(2)),
                length=sds((B,), jnp.int32, sharding=shard(1)),
            )
            fold = FoldInData(
                by_user=(bucket,),
                excl=sds((B, W), jnp.int32, sharding=shard(2)),
                gt=sds((B, 1), jnp.int32, sharding=shard(2)),
                gt_len=sds((B,), jnp.int32, sharding=shard(1)),
                hist_size=sds((B,), jnp.float32, sharding=shard(1)),
                n_eval=B, n_pad=B,
                num_items=self.model.num_items, nnz=0,
            )
            state_sds = jax.tree_util.tree_map(
                lambda x: sds(x.shape, x.dtype,
                              sharding=getattr(x, "sharding", None)),
                self.model.state)
            prog = jax.jit(self._serve_fn).lower(state_sds, fold).compile()
            self._programs[(B, W)] = prog
        return prog

    def _row_sharding(self, ndim: int):
        from safer2_recommender_tpu.parallel.mesh import row_sharding

        return row_sharding(self.model.mesh, ndim)

    def _serve_fn(self, state, fold):
        ue = self.model._fold_in(state, fold)
        return self.model._recommend_ids(
            ue, state.item_emb, fold.excl, k=self.k, approx=self.approx)

    # ---- batch packing ------------------------------------------------------

    def _pack(self, users: np.ndarray, items: np.ndarray):
        """Split a request into rung-shaped sub-batches; yields
        (distinct user ids, FoldInData) per sub-batch."""
        if items.size:
            lo, hi = int(items.min()), int(items.max())
            if lo < 0 or hi >= self.model.num_items:
                raise ValueError(
                    f"request item ids must be in [0, "
                    f"{self.model.num_items}); got range [{lo}, {hi}]")
        uniq, inv = np.unique(users, return_inverse=True)
        counts = np.bincount(inv, minlength=uniq.size)
        order = np.argsort(inv, kind="stable")
        items = np.ascontiguousarray(items)[order]
        if self._perm is not None:
            items = self._perm[items]
        max_b = self.batch_sizes[-1]
        starts = np.concatenate(([0], np.cumsum(counts)))
        for lo in range(0, uniq.size, max_b):
            hi = min(lo + max_b, uniq.size)
            yield (uniq[lo:hi],
                   self._pack_one(counts[lo:hi],
                                  items[starts[lo]:starts[hi]]))

    def _pack_one(self, counts: np.ndarray, items: np.ndarray):
        n = counts.size
        B = self._rung(self.batch_sizes, n)
        W = self._rung(self.widths, int(counts.max()) if n else 1)
        ni = self.model.num_items
        col = np.zeros((B, W), np.int32)
        excl = np.full((B, W), ni, np.int32)
        row_of = np.repeat(np.arange(n), counts)
        off = _segment_arange(counts)
        col[row_of, off] = items
        excl[row_of, off] = items
        row_ids = np.full(B, B, np.int32)   # pads out of bounds -> dropped
        row_ids[:n] = np.arange(n, dtype=np.int32)
        length = np.zeros(B, np.int32)
        length[:n] = counts
        leaves = dict(
            row=jnp.asarray(row_ids), col=jnp.asarray(col),
            length=jnp.asarray(length), excl=jnp.asarray(excl),
            gt=jnp.asarray(np.full((B, 1), ni, np.int32)),
            gt_len=jnp.asarray(np.zeros(B, np.int32)),
            hist=jnp.asarray(length.astype(np.float32)),
        )
        if self.model.mesh is not None:
            from safer2_recommender_tpu.parallel import mesh as mesh_lib
            leaves = {k: mesh_lib.put(np.asarray(v),
                                      self._row_sharding(v.ndim))
                      for k, v in leaves.items()}
        return FoldInData(
            by_user=(Bucket(row_ids=leaves["row"], col_ids=leaves["col"],
                            length=leaves["length"]),),
            excl=leaves["excl"], gt=leaves["gt"], gt_len=leaves["gt_len"],
            hist_size=leaves["hist"],
            n_eval=B, n_pad=B, num_items=ni, nnz=0,
        )

    # ---- serving surface ----------------------------------------------------

    def _dispatch(self, histories):
        if isinstance(histories, Dataset):
            u, i = histories.user_ids, histories.item_ids
        else:
            u, i = histories
            u = np.asarray(u, np.int32)
            i = np.asarray(i, np.int32)
        self._refresh_perm()
        out = []
        for users, fold in self._pack(u, i):
            prog = self._program(fold.n_pad, fold.excl.shape[1])
            out.append((users, prog(self.model.state, fold)))
        return out

    def _fetch(self, dispatched) -> Tuple[np.ndarray, np.ndarray]:
        if not dispatched:   # empty request batch -> empty result
            return (np.zeros(0, np.int32),
                    np.zeros((0, self.k), np.int32))
        us, ids = [], []
        for users, dev in dispatched:
            arr = np.asarray(jax.device_get(dev))[: users.size]
            if self._order is not None:
                arr = self._order[arr]
            us.append(users)
            ids.append(arr)
        return np.concatenate(us), np.concatenate(ids, axis=0)

    def recommend(self, histories) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k for one request batch: a ``Dataset`` (or ``(user_ids,
        item_ids)`` arrays) of interactions in ORIGINAL id space.
        Returns ``(user_ids [n], item_ids [n, k])`` like
        ``Recommender.recommend``."""
        return self._fetch(self._dispatch(histories))

    def recommend_stream(self, batches: Iterable) -> Iterator[
            Tuple[np.ndarray, np.ndarray]]:
        """``recommend`` over a stream, one batch of pipelining deep:
        batch k+1 is packed and dispatched before batch k's result is
        fetched, hiding host-side packing behind device execution."""
        prev = None
        for h in batches:
            disp = self._dispatch(h)
            if prev is not None:
                yield self._fetch(prev)
            prev = disp
        if prev is not None:
            yield self._fetch(prev)

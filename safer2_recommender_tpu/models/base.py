"""Recommender base class: state, training loop plumbing, eval engine.

Plays the role of the reference's abstract ``Recommender``
(reference include/frecsys/recommender.h:40-130): shared evaluation of a
held-out dataset (fold-in + full-catalog scoring + Recall/NDCG/CVaR) and
the stats-printing toggles. The threaded per-user evaluation driver
(recommender.h:78-129) becomes a chunked, sharded scoring matmul with a
fused masked top-k.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from safer2_recommender_tpu.config import Config
from safer2_recommender_tpu.data.dataset import DeviceData, FoldInData
from safer2_recommender_tpu.evaluation.metrics import (
    DEFAULT_ALPHA_LIST,
    DEFAULT_K_LIST,
    EvaluationResult,
    topk_ids,
    topk_metrics,
)
from safer2_recommender_tpu.models import common
from safer2_recommender_tpu.ops import woodbury

_log = logging.getLogger("safer2_recommender_tpu")


def _dd_fingerprint(dd: DeviceData) -> Tuple[int, ...]:
    """Identity of a DeviceData's id universe + solver order:
    (num_users, num_items, nnz, crc32(user_order), crc32(item_order)).
    Model tables are only meaningful relative to the solver order they
    were trained in; this is what export/eval/serving validate against
    (id spaces: data/dataset.py::_solver_order)."""
    import zlib

    from safer2_recommender_tpu.parallel.mesh import to_host

    return (dd.num_users, dd.num_items, dd.nnz,
            zlib.crc32(to_host(dd.user_order).astype(np.int32).tobytes()),
            zlib.crc32(to_host(dd.item_order).astype(np.int32).tobytes()))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MFState:
    """Model state pytree (superset across the six models)."""

    user_emb: jax.Array      # [num_users, dim]
    item_emb: jax.Array      # [num_items, dim]
    item_gramian: jax.Array  # [dim, dim] cached V^T V (safer2.h:55)
    user_loss: jax.Array     # [num_users]
    dual_weight: jax.Array   # [num_users]
    xi: jax.Array            # scalar smoothed-quantile estimate
    key: jax.Array           # PRNG key (explicit; improves on the
                             # reference's std::random_device seeding)
    steps: jax.Array         # epochs trained (selects the reference's
                             # Initialize-time xi warm start on epoch 0;
                             # see SAFER2._epoch)
    eig_qu: jax.Array        # [dim, dim] warm eigenbasis of the user
                             # sweep's shared Gramian (Woodbury refresh,
                             # ops/woodbury.py::refresh_eigh)
    eig_qv: jax.Array        # [dim, dim] warm eigenbasis of the item
                             # sweep's shared Gramian

    def replace(self, **kw) -> "MFState":
        return dataclasses.replace(self, **kw)


class Recommender:
    """Base class. Subclasses implement ``_epoch`` and ``_fold_in``."""

    name = "base"

    def __init__(self, cfg: Config, num_users: int, num_items: int,
                 mesh=None):
        self.cfg = cfg
        self.num_users = num_users
        self.num_items = num_items
        self.mesh = mesh
        self.print_train_stats = False
        self.print_residual_stats = False
        self.print_var_stats = False

        # "auto" is f32 on every backend: bf16 assembly was faster on
        # the GPU but moved dim-512 fold-in embeddings by up to a
        # quarter of their size (PERF.md)
        self.asm_dtype = jnp.bfloat16 if cfg.compute_dtype == "bf16" else None

        key = jax.random.PRNGKey(cfg.seed)
        ku, ki, kr = jax.random.split(key, 3)
        user_emb = common.normal_init(ku, num_users, cfg.dim, cfg.stdev)
        item_emb = common.normal_init(ki, num_items, cfg.dim, cfg.stdev)
        self.state = MFState(
            user_emb=user_emb,
            item_emb=item_emb,
            item_gramian=item_emb.T @ item_emb,
            user_loss=jnp.zeros((num_users,), jnp.float32),
            dual_weight=jnp.full((num_users,), cfg.alpha, jnp.float32),
            xi=jnp.float32(0.0),
            key=kr,
            steps=jnp.int32(0),
            eig_qu=jnp.eye(cfg.dim, dtype=jnp.float32),
            eig_qv=jnp.eye(cfg.dim, dtype=jnp.float32),
        )
        if mesh is not None:
            # Replicate the state over the mesh. Single-process runs
            # would get there lazily via jit auto-placement, but a
            # MULTI-PROCESS mesh cannot: each process's plainly-created
            # arrays live on its local device 0 only, and jit rejects
            # mixing them with global-mesh operands.
            from safer2_recommender_tpu.parallel import mesh as mesh_lib
            rep = mesh_lib.replicated(mesh)
            self.state = jax.tree_util.tree_map(
                lambda x: mesh_lib.put(x, rep), self.state)
        self._epoch_jit = jax.jit(self._epoch)
        self._fold_in_jit = jax.jit(self._fold_in)
        self._eval_jit = None
        self._rec_jit = None

    # ---- reference API surface -------------------------------------------

    def set_print_train_stats(self, v: bool) -> None:
        self.print_train_stats = v

    def set_print_residual_stats(self, v: bool) -> None:
        self.print_residual_stats = v

    def set_print_var_stats(self, v: bool) -> None:
        self.print_var_stats = v

    def get_mean_weight(self) -> float:
        """Mean dual weight; tracks alpha when xi is accurate
        (reference safer2.h:812-817, Proposition C.1 hook)."""
        return float(jnp.mean(self.state.dual_weight))

    def initialize(self, dd: DeviceData) -> None:
        """Pre-training warm start; overridden by the SAFER family
        (reference safer2.h:819-838)."""
        self._note_perms(dd)

    def export_state(self, dd: DeviceData = None) -> dict:
        """Numpy view of the model state in ORIGINAL id space.

        Model tables/vectors live in solver-order ids
        (data/dataset.py::_solver_order); this gathers them back so
        ``out["user_emb"][u]`` is user ``u`` of the original Dataset.
        The permutation is remembered from training (or restored from a
        format-v2 checkpoint via ``load_checkpoint_meta``); a passed
        ``dd`` is validated against it. Returns user_emb, item_emb,
        user_loss, dual_weight, xi arrays.

        Raises on a TRAINED state whose permutation is unknown (e.g. a
        pre-v2 checkpoint restored into a fresh process) — an identity
        fallback would return solver-order rows silently labeled as
        original-id rows, wrong for every user. Matches the id contract
        of the reference's eval surface (recommender.h:78-129): results
        must be id-correct however the state got there.
        """
        from safer2_recommender_tpu.parallel.mesh import to_host

        if dd is not None and getattr(dd, "user_perm", None) is not None:
            fp = _dd_fingerprint(dd)
            if getattr(self, "_dd_fp", None) is not None \
                    and fp != self._dd_fp:
                raise ValueError(
                    "export_state: the supplied DeviceData does not match "
                    "the data this state was trained against (fingerprint "
                    f"{fp} != {self._dd_fp}); rows would come back "
                    "misaligned. Pass the training DeviceData (or none — "
                    "the training permutation is remembered).")
        # original id u sits at solver position perm[u] (perm/order are
        # inverse permutations by construction, _solver_order)
        pu = getattr(self, "_user_perm", None)
        pi = getattr(self, "_item_perm", None)
        if pu is None and dd is not None:
            pu = getattr(dd, "user_perm", None)
            pi = getattr(dd, "item_perm", None)
        if pu is None:
            if int(np.asarray(self.state.steps)) > 0:
                raise ValueError(
                    "export_state on a trained state with no recorded id "
                    "permutation — the tables are in solver order and "
                    "would be mislabeled. If this state was restored "
                    "from a checkpoint, restore the id sidecar too "
                    "(CheckpointManager.restore_with_meta + "
                    "load_checkpoint_meta), or call initialize()/"
                    "train_epoch() with the training DeviceData first "
                    "(docs/API.md 'Id spaces').")
            pu = np.arange(self.num_users)
            pi = np.arange(self.num_items)
        else:
            pu, pi = to_host(pu), to_host(pi)
        s = self.state
        return {
            "user_emb": to_host(s.user_emb)[pu],
            "item_emb": to_host(s.item_emb)[pi],
            "user_loss": to_host(s.user_loss)[pu],
            "dual_weight": to_host(s.dual_weight)[pu],
            "xi": float(to_host(s.xi)),
        }

    def checkpoint_meta(self) -> dict:
        """Id-space sidecar for ``CheckpointManager.save`` (format v2):
        the solver-order id orders + training-data fingerprint that make
        a checkpoint self-contained. None when no DeviceData was seen
        yet (a fresh untrained model)."""
        if getattr(self, "_user_order", None) is None:
            return None
        from safer2_recommender_tpu.parallel.mesh import to_host

        return {
            "format_version": np.int32(2),
            "user_order": to_host(self._user_order).astype(np.int32),
            "item_order": to_host(self._item_order).astype(np.int32),
            "dd_fp": np.asarray(self._dd_fp, np.int64),
        }

    def load_checkpoint_meta(self, meta: dict) -> None:
        """Adopt a restored checkpoint's id sidecar: evaluation, serving
        and export become id-correct in this process without ever
        rebuilding the training DeviceData. ``meta=None`` (a pre-v2
        checkpoint) warns if the restored state is trained."""
        if meta is None:
            if int(np.asarray(self.state.steps)) > 0:
                _log.warning(
                    "restored checkpoint has no id sidecar (format v1) — "
                    "evaluation/serving/export need the training "
                    "DeviceData (same bucketing parameters) passed to "
                    "initialize()/train_epoch() first to recover the id "
                    "permutation")
            return
        uo = np.asarray(meta["user_order"], np.int32)
        io = np.asarray(meta["item_order"], np.int32)
        if uo.size != self.num_users or io.size != self.num_items:
            raise ValueError(
                f"checkpoint id sidecar sized ({uo.size}, {io.size}) does "
                f"not match this model ({self.num_users}, "
                f"{self.num_items}) — wrong checkpoint for this dataset?")
        up = np.empty_like(uo)
        up[uo] = np.arange(uo.size, dtype=np.int32)
        ip = np.empty_like(io)
        ip[io] = np.arange(io.size, dtype=np.int32)
        put = jnp.asarray
        if self.mesh is not None:
            from safer2_recommender_tpu.parallel import mesh as mesh_lib
            rep = mesh_lib.replicated(self.mesh)
            put = lambda x: mesh_lib.put(x, rep)
        self._user_order, self._user_perm = put(uo), put(up)
        self._item_order, self._item_perm = put(io), put(ip)
        self._dd_fp = tuple(int(x) for x in meta["dd_fp"])
        self._noted_dd_id = None
        self._fold_perm_cache = {}

    def _note_perms(self, dd: DeviceData) -> None:
        """Remember the training data's solver-order permutation
        (data/dataset.py::_solver_order). Model tables and per-row state
        live in solver-order id space; evaluation/serving data built in
        original id space is remapped through this at eval time.

        Validates repeat calls against the remembered fingerprint: a
        TRAINED state fed a DeviceData with a different solver order
        (same data rebucketed — e.g. other memory_budget_bytes/growth,
        or a post-restore rebuild) is REMAPPED into the new order; a
        different id universe raises instead of silently corrupting."""
        if getattr(dd, "item_perm", None) is None:
            return
        if getattr(self, "_noted_dd_id", None) == id(dd):
            return
        fp = _dd_fingerprint(dd)
        old = getattr(self, "_dd_fp", None)
        if old is not None and old != fp:
            trained = int(np.asarray(self.state.steps)) > 0
            if not trained:
                pass  # untrained tables are order-free: just re-target
            elif old[:3] == fp[:3]:
                _log.warning(
                    "DeviceData solver order differs from the one this "
                    "state was trained in (same id universe — likely "
                    "rebuilt with different bucketing parameters); "
                    "remapping model tables into the new order")
                self._remap_state_to(dd)
            else:
                raise ValueError(
                    "train/initialize called with a DeviceData whose id "
                    f"universe {fp[:3]} (users, items, nnz) does not "
                    f"match the one this trained state came from "
                    f"{old[:3]} — tables would be silently misaligned. "
                    "Build the DeviceData from the training Dataset, or "
                    "start from a fresh model.")
        self._item_perm = dd.item_perm
        self._item_order = dd.item_order
        self._user_perm = dd.user_perm
        self._user_order = dd.user_order
        self._dd_fp = fp
        self._noted_dd_id = id(dd)
        self._fold_perm_cache = {}

    def _remap_state_to(self, dd: DeviceData) -> None:
        """Gather per-row state from the remembered solver order into
        ``dd``'s. Slot j of the new order holds original id
        dd.*_order[j], which sat at old slot old_perm[dd.*_order[j]].
        The [dim, dim] leaves (gramian, eigenbases) are permutation-
        invariant (G = VᵀV) and stay untouched."""
        from safer2_recommender_tpu.parallel.mesh import to_host

        gu = to_host(self._user_perm)[to_host(dd.user_order)]
        gi = to_host(self._item_perm)[to_host(dd.item_order)]
        put = jnp.asarray
        if self.mesh is not None:
            from safer2_recommender_tpu.parallel import mesh as mesh_lib
            rep = mesh_lib.replicated(self.mesh)
            put = lambda x: mesh_lib.put(x, rep)
        s = self.state
        self.state = s.replace(
            user_emb=put(to_host(s.user_emb)[gu]),
            item_emb=put(to_host(s.item_emb)[gi]),
            user_loss=put(to_host(s.user_loss)[gu]),
            dual_weight=put(to_host(s.dual_weight)[gu]),
        )

    def _permute_fold(self, fold: FoldInData,
                      cache: bool = True) -> FoldInData:
        """Remap a FoldInData's item ids (fold-in histories, exclusion
        lists, ground truth) into the model's solver-order item space.
        Identity when the model never saw a renumbered DeviceData. The
        result is cached per fold object — evaluation runs every epoch
        under --print_evaluation_stats. ``cache=False`` for transient
        folds (recommend() builds one per request batch; pinning those
        would hold whole folds' device arrays in memory long after the
        batch is answered)."""
        perm = getattr(self, "_item_perm", None)
        if perm is None:
            if int(np.asarray(self.state.steps)) > 0 and not getattr(
                    self, "_perm_warned", False):
                # A trained state without a known permutation is almost
                # certainly a checkpoint restored into a fresh model
                # that never saw its DeviceData: tables are in solver
                # order and an identity remap would silently corrupt
                # metrics/recommendations. One call into train_epoch /
                # initialize with the rebuilt dd fixes it.
                self._perm_warned = True
                _log.warning(
                    "evaluating a trained state with no recorded id "
                    "permutation — if this state was restored from a "
                    "checkpoint, call initialize()/train_epoch() with "
                    "the DeviceData first so ids can be remapped "
                    "(docs/API.md 'Id spaces')")
            return fold
        store = None
        if cache:
            store = getattr(self, "_fold_perm_cache", None)
            if store is None:
                store = self._fold_perm_cache = {}
            hit = store.get(id(fold))
            if hit is not None and hit[0] is fold:
                return hit[1]
        ni = self.num_items

        def ids(a):
            # gt/excl pads are num_items ("never matches"); keep them out
            # of range after the remap too
            return jnp.where(a >= ni, ni,
                             perm[jnp.minimum(a, ni - 1)].astype(a.dtype))

        def bmap(b):
            # bucket col pads are 0 and masked; a plain remap suffices
            return dataclasses.replace(
                b, col_ids=perm[b.col_ids].astype(jnp.int32))

        out = dataclasses.replace(
            fold,
            by_user=tuple(bmap(b) for b in fold.by_user),
            excl=ids(fold.excl),
            gt=ids(fold.gt),
        )
        # bounded multi-entry cache: the CLI alternates validation and
        # test folds — a single slot would thrash and redo the eager
        # remap every evaluation. Entries pin the fold object, so id()
        # keys stay unique while cached.
        if store is not None:
            if len(store) >= 4:
                store.pop(next(iter(store)))
            store[id(fold)] = (fold, out)
        return out

    def train_epochs(self, dd: DeviceData, n: int) -> None:
        """Run ``n`` epochs in ONE device dispatch via ``lax.scan``.

        Chaining epochs on-device removes the per-epoch dispatch and
        host sync. Skips the per-epoch stat logging — use
        ``train_epoch`` when per-epoch stats are on (the reference logs
        per epoch, run_model.cc:258-270). Returns without waiting for
        the device: ``jax.block_until_ready(model.state)`` waits.
        """
        self._note_perms(dd)
        if not hasattr(self, "_epochs_scan_jit"):
            def _run(state, dd_, n_):
                return jax.lax.scan(
                    lambda s, _: (self._epoch(s, dd_), None),
                    state, None, length=n_)[0]
            # Donate the incoming state: the embedding tables are the
            # dominant device-memory tenants at scale (2 x [rows, 512] f32 at MSD)
            # and nothing reads the old state after a chained dispatch.
            self._epochs_scan_jit = jax.jit(_run, static_argnums=(2,),
                                            donate_argnums=(0,))
        self.state = self._epochs_scan_jit(self.state, dd, n)

    def train_epoch(self, dd: DeviceData) -> None:
        self._note_perms(dd)
        if self._stats_order == "pre":
            self._log_train_stats(dd)
        prev = self.state if self.print_residual_stats else None
        self.state = jax.block_until_ready(self._epoch_jit(self.state, dd))
        if self._stats_order == "post":
            self._log_train_stats(dd)
        # The reference emits these per-epoch lines UNCONDITIONALLY
        # inside Train (safer2.h:300,330-334; erm_mf.h:277;
        # cvar_mf.h:301-303,328). They force a host sync; the chained
        # ``train_epochs`` path stays silent for benchmarking.
        self._log_epoch_lines()
        self._log_var_stats()
        if prev is not None:
            # Residual norms (reference safer2.h:324-328). Unlike the
            # reference (which returns 0 for some models' residuals,
            # e.g. ials.h:363-364), we always report the true norms.
            ru = float(jnp.linalg.norm(self.state.user_emb - prev.user_emb))
            rv = float(jnp.linalg.norm(self.state.item_emb - prev.item_emb))
            rz = float(jnp.linalg.norm(
                self.state.dual_weight - prev.dual_weight))
            _log.info("U residual: %s, V residual: %s, z residual: %s",
                      ru, rv, rz)

    # ---- subclass hooks ---------------------------------------------------

    # When the reference model logs its loss decomposition: "pre" = at the
    # top of Train (safer family, e.g. safer2.h:267), "post" = after the
    # sweeps (iALS, ials.h:203).
    _stats_order = "pre"
    # True on the exact-solve models whose loss pass is phase-shifted to
    # the top of the next epoch (PARITY.md section 5) — their
    # loss-derived log lines describe the pre-epoch model.
    _loss_lags_one_epoch = False

    def _epoch(self, state: MFState, dd: DeviceData) -> MFState:
        raise NotImplementedError

    def _reg_vectors(self, dd: DeviceData):
        """Per-row regularization values for the stats lines
        ([num_users], [num_items])."""
        raise NotImplementedError

    def _log_epoch_lines(self) -> None:
        """Per-model end-of-epoch log lines (Weighted Loss / Xi / ...)."""

    def _log_train_stats(self, dd: DeviceData) -> None:
        if not self.print_train_stats:
            return
        from safer2_recommender_tpu.models import stats
        from safer2_recommender_tpu.utils.logging import Timer

        if not hasattr(self, "_stats_jit"):
            def _impl(state, dd_):
                ur, ir = self._reg_vectors(dd_)
                return stats.loss_decomposition(
                    state.user_emb, state.item_emb, state.user_loss, dd_,
                    ur, ir, self.cfg.uobs_weight,
                    loss_is_user_sum=(self._stats_order == "pre"))
            self._stats_jit = jax.jit(_impl)
        with Timer() as t:
            vals = jax.block_until_ready(self._stats_jit(self.state, dd))
        stats.log_loss_decomposition(vals, dd, t.ms)

    def _fold_in(self, state: MFState, fold: FoldInData) -> jax.Array:
        """Return eval-user embeddings [fold.n_pad, dim]."""
        raise NotImplementedError

    # ---- evaluation engine -------------------------------------------------

    def evaluate_dataset(
        self,
        fold: FoldInData,
        k_list: Sequence[int] = DEFAULT_K_LIST,
        alpha_list: Sequence[float] = DEFAULT_ALPHA_LIST,
    ) -> EvaluationResult:
        """Held-out evaluation (reference EvaluateDataset overrides):
        fold in fresh user embeddings from fold.by_user with items frozen,
        score the full catalog, mask history, compute Recall/NDCG."""
        fold = self._permute_fold(fold)
        ue = self._fold_in_jit(self.state, fold)
        if self._eval_jit is None:
            self._eval_jit = jax.jit(
                self._eval_metrics, static_argnames=("k_list",))
        recall, ndcg = self._eval_jit(ue, self.state.item_emb, fold,
                                      k_list=tuple(k_list))
        from safer2_recommender_tpu.parallel.mesh import to_host
        recall = to_host(recall)
        ndcg = to_host(ndcg)
        keep = to_host(fold.gt_len) > 0
        return EvaluationResult(
            k_list=tuple(k_list),
            alpha_list=tuple(alpha_list),
            recall=recall[keep],
            ndcg=ndcg[keep],
        )

    def recommend(self, histories, k: int = 10, approx: bool = False):
        """Serve top-k recommendations for new users.

        ``approx=True`` ranks with ``jax.lax.approx_max_k`` (near-tied
        items may swap in/out of the list) and default-precision
        scoring; whether it is faster than the exact path depends on how
        the backend lowers ``approx_max_k``. Evaluation always stays
        exact.

        ``histories`` is a Dataset of (user, item) interactions (or a
        pre-built FoldInData); each user's embedding is folded in from
        their history with item embeddings frozen — the same
        strong-generalization fold-in the evaluation protocol uses —
        then the full catalog is scored (history masked out) and the
        top-k item ids returned. Beyond-reference capability: the
        reference can only *score* held-out users, never emit
        recommendations.

        Returns ``(user_ids [n], item_ids [n, k])`` numpy arrays, rows
        aligned to the distinct users of ``histories``.
        """
        from safer2_recommender_tpu.data.dataset import Dataset

        if isinstance(histories, Dataset):
            users = np.unique(np.asarray(histories.user_ids))
            empty = Dataset(np.zeros(0, np.int32), np.zeros(0, np.int32))
            fold = FoldInData.build(histories, empty,
                                    num_items=self.num_items,
                                    dim=self.cfg.dim,
                                    mesh=self.mesh)
        else:
            fold = histories
            users = np.arange(fold.n_eval)
        # cache=False: request folds are transient — pinning them would
        # hold ~4 batches' device arrays for the model's lifetime
        fold = self._permute_fold(fold, cache=False)
        ue = self._fold_in_jit(self.state, fold)
        if self._rec_jit is None:
            self._rec_jit = jax.jit(self._recommend_ids,
                                    static_argnames=("k", "approx"))
        from safer2_recommender_tpu.parallel.mesh import to_host
        ids = to_host(
            self._rec_jit(ue, self.state.item_emb, fold.excl, k=k,
                          approx=approx))
        order = getattr(self, "_item_order", None)
        if order is not None:
            # decode solver-order item ids back to catalog ids
            ids = to_host(order)[ids]
        return users, ids[: users.size]

    def _recommend_ids(self, ue: jax.Array, item_emb: jax.Array,
                       excl: jax.Array, *, k: int,
                       approx: bool = False) -> jax.Array:
        # chunked like _eval_metrics: an unchunked [n_pad, num_items]
        # score matrix for a large serving batch would exhaust memory
        chunk = self._eval_chunk(ue.shape[0])
        n_chunks = ue.shape[0] // chunk

        def score_chunk(args):
            u, ex = args
            # exact serving scores in full f32 (near-ties must rank
            # deterministically); approx mode accepts tie reordering
            # and takes the fast default-precision matmul too
            scores = jnp.matmul(
                u, item_emb.T,
                precision=None if approx else jax.lax.Precision.HIGHEST)
            return topk_ids(scores, ex, k, approx=approx)

        ids = jax.lax.map(score_chunk,
                          (self._shard_chunked(ue.reshape(n_chunks, chunk, -1)),
                           self._shard_chunked(excl.reshape(n_chunks, chunk, -1))))
        return ids.reshape(-1, k)

    def _eval_chunk(self, n_pad: int) -> int:
        """Largest divisor of the fold's padded row count that fits the
        configured chunk (FoldInData pads to its own default multiple,
        so an arbitrary eval_chunk need not divide n_pad). On a mesh the
        chunk must also split evenly over the data axis so the scoring
        rows inside each lax.map step stay sharded."""
        from safer2_recommender_tpu.parallel.mesh import num_shards
        step = num_shards(self.mesh)
        chunk = min(self.cfg.eval_chunk, n_pad)
        chunk = max(chunk - chunk % step, step)   # n_pad % step == 0
        while n_pad % chunk:
            chunk -= step
        return chunk

    def _shard_chunked(self, x: jax.Array) -> jax.Array:
        """Constrain a chunked [n_chunks, chunk, ...] operand so the
        lax.map scan axis is replicated and the rows WITHIN each chunk
        shard over the mesh — the reshape from row-sharded [n_pad, ...]
        would otherwise leave the scan axis sharded (which forces a
        gather) or replicate the whole scoring program."""
        if self.mesh is None:
            return x
        from jax.sharding import NamedSharding, PartitionSpec as P
        spec = P(None, "data", *([None] * (x.ndim - 2)))
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(self.mesh, spec))

    def _eval_metrics(self, ue: jax.Array, item_emb: jax.Array,
                      fold: FoldInData, *, k_list: Tuple[int, ...]):
        chunk = self._eval_chunk(fold.n_pad)
        n_chunks = fold.n_pad // chunk
        d = ue.shape[1]

        def score_chunk(args):
            u, excl, gt, gt_len = args
            # full f32 like the reference's scoring (ials.h:181-183) —
            # a default-precision matmul may round its inputs (TF32 or
            # bf16) and near-tied items would reorder inside the top-k
            scores = jnp.matmul(u, item_emb.T,
                                precision=jax.lax.Precision.HIGHEST)
            return topk_metrics(scores, excl, gt, gt_len, k_list)

        rec, ndcg = jax.lax.map(
            score_chunk,
            (
                self._shard_chunked(ue.reshape(n_chunks, chunk, d)),
                self._shard_chunked(fold.excl.reshape(n_chunks, chunk, -1)),
                self._shard_chunked(fold.gt.reshape(n_chunks, chunk, -1)),
                self._shard_chunked(fold.gt_len.reshape(n_chunks, chunk)),
            ),
        )
        nk = len(k_list)
        return rec.reshape(-1, nk), ndcg.reshape(-1, nk)

    # ---- logging ------------------------------------------------------------

    def _log_var_stats(self) -> None:
        if not self.print_var_stats:
            return
        self._note_loss_phase()
        from safer2_recommender_tpu.parallel.mesh import to_host
        loss = to_host(self.state.user_loss)
        vals = np.sort(-loss)
        # Reference (ials.h:212-218): Q = n * alpha stays a FLOAT — the
        # sum runs over floor(Q)+1 elements but the divisor is Q itself.
        qf = len(vals) * self.cfg.alpha
        # alpha == 1.0 (plain ERM) would index one past the end — the
        # reference reads out of bounds there (ials.h:214); clamp instead.
        q = min(int(qf), len(vals) - 1)
        var = -vals[q]
        cvar = -vals[: q + 1].sum() / (qf if qf > 0 else 1.0)
        _log.info("VaR: %s CVaR: %s", var, cvar)
        dw = np.asarray(self.state.dual_weight)
        _log.info("Min: %.3f, Mean: %.3f, Max: %.3f",
                  dw.min(), dw.mean(), dw.max())

    def _log_weighted_loss(self) -> None:
        self._note_loss_phase()
        wl = float(jnp.mean(self.state.dual_weight * self.state.user_loss))
        _log.info("Weighted Loss: %s", wl)

    def _note_loss_phase(self) -> None:
        """One-time heads-up that the exact-solve models' loss-derived
        log lines (Weighted Loss / VaR / CVaR) describe the PRE-epoch
        model: their loss pass is phase-shifted to the top of the next
        epoch to share the U-sweep's gather (PARITY.md section 5; the
        update sequence is provably identical, only the print timing
        moves one epoch vs the reference's safer2.h:300-321)."""
        if self._loss_lags_one_epoch and not getattr(
                self, "_loss_phase_noted", False):
            self._loss_phase_noted = True
            _log.info(
                "note: loss-derived stats lag one epoch (they describe "
                "the pre-epoch model; identical math, shifted print — "
                "PARITY.md section 5)")


class SaferFamilyMixin:
    """Shared SAFER-family machinery: the two regularizer formulas
    (reference safer2.h:418-432, erm_mf.h:384-395) every family member
    (erm_mf, cvar_mf, safer2, safer2pp) uses, plus the weighted
    exact-solve sweeps and one-shot fold-in that erm_mf and safer2
    share verbatim (cvar_mf overrides with gradient steps / closed-form
    eval; safer2pp with blockwise sweeps)."""

    def _user_reg(self) -> float:
        # reference safer2.h:418-421
        return self.cfg.l2_reg * (1.0 + self.cfg.uobs_weight
                                  * self.num_items)

    def _item_reg(self, item_reg_vec, row_ids) -> jax.Array:
        # reference safer2.h:426-432; gap ids clamp to the last stat
        stat = item_reg_vec[jnp.minimum(row_ids, item_reg_vec.shape[0] - 1)]
        return self.cfg.l2_reg * (
            stat + self.cfg.alpha * self.cfg.uobs_weight * self.num_users)

    def _reg_vectors(self, dd: DeviceData):
        ur = jnp.full((dd.num_users,), self._user_reg(), jnp.float32)
        ir = self._item_reg(dd.item_reg, jnp.arange(dd.item_reg.shape[0]))
        return ur, ir

    def _step_u(self, ue, item_emb, gramian, buckets, dual, pre_list=None,
                q_prev=None):
        """Weighted mean-normalized exact U-solves (reference
        safer2.h:104-163 / erm_mf.h:91-151). Returns (new table, new
        eigenbasis or None)."""
        cfg = self.cfg
        reg = self._user_reg()
        eig = woodbury.maybe_eigh(gramian, cfg.dim, use_cg=cfg.use_cg,
                                  q_prev=q_prev,
                                  refresh_tol=cfg.eig_refresh_tol)

        def params_fn(b, pre=None):
            w = dual[jnp.minimum(b.row_ids, dual.shape[0] - 1)]
            return common.params_weighted_mean(
                item_emb, b, jnp.full((b.n_rows,), reg, jnp.float32),
                cfg.uobs_weight, w, dtype=self.asm_dtype, pre=pre)

        out = common.solve_sweep(ue, buckets, params_fn, gramian,
                                 eig=eig, use_cg=cfg.use_cg,
                                 cg_tol=cfg.cg_error_tolerance,
                                 cg_iters=cfg.cg_max_iterations,
                                 pre_list=pre_list)
        return out, (eig[0] if eig is not None else None)

    def _step_v(self, v, user_emb, dd: DeviceData, dual, q_prev=None):
        """Dual-weighted exact V-solves (reference safer2.h:166-221 /
        erm_mf.h:153-210). The weighted Gramian U^T diag(z) U spans the
        full table incl. id gaps (erm_mf.h:462-467) and is recomputed
        every call — it cannot be cached like V^T V."""
        cfg = self.cfg
        w_gram = user_emb.T @ (user_emb * dual[:, None])
        norm_dual = jnp.where(dd.user_hist_size > 0,
                              dual / jnp.maximum(dd.user_hist_size, 1.0),
                              0.0)

        eig = woodbury.maybe_eigh(w_gram, cfg.dim, use_cg=cfg.use_cg,
                                  q_prev=q_prev,
                                  refresh_tol=cfg.eig_refresh_tol)

        def params_fn(b):
            reg = self._item_reg(dd.item_reg, b.row_ids)
            return common.params_weighted_item(
                user_emb, b, reg, cfg.uobs_weight, norm_dual,
                dtype=self.asm_dtype)

        out = common.solve_sweep(v, dd.by_item, params_fn, w_gram,
                                 eig=eig, use_cg=cfg.use_cg,
                                 cg_tol=cfg.cg_error_tolerance,
                                 cg_iters=cfg.cg_max_iterations)
        return out, (eig[0] if eig is not None else None)

    def _fold_in(self, state: "MFState", fold: FoldInData) -> jax.Array:
        """StepU with weight 1.0 (reference safer2.h:246-252,
        erm_mf.h:234-244)."""
        ue = jnp.zeros((fold.n_pad, self.cfg.dim), jnp.float32)
        ones = jnp.ones((fold.n_pad,), jnp.float32)
        return self._step_u(ue, state.item_emb, state.item_gramian,
                            fold.by_user, ones, q_prev=state.eig_qu)[0]

"""iALS++: block coordinate descent over embedding sub-blocks.

Capability parity with reference include/frecsys/ialspp.h
(IALSppRecommender, the "subspace optimization" of the iALS++ paper):
delta solves over blocks of size ``block_size``:

  A = uobs * G_loc + reg * I + sum_h v_loc v_loc^T
  rhs = sum_h v_loc (pred - 1) + uobs * G_lg @ x + reg * x_loc
  x_loc <- x_loc - A^-1 rhs                        (ialspp.h:85-145)

Train epoch = full U block sweep, then full V block sweep — a
batched reordering of the reference's per-block U/V interleave
(ialspp.h:208-261): with the other side frozen, every block's
G_loc/G_lg are slices of ONE Gramian and each bucket's history slab is
gathered once per sweep instead of once per block (see
models/common.py::block_sweep_frozen for the equivalence argument).
The reference's flat prediction cache with lock-free racy scatters
(ialspp.h:399-406, :469-517) becomes slab-local incremental
predictions. Held-out eval = 8 blockwise fold-in epochs
(ialspp.h:149-206, num_epochs hard-coded at :152) reusing one slab
gather across all 8 sweeps.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from safer2_recommender_tpu.data.dataset import DeviceData, FoldInData
from safer2_recommender_tpu.models import common
from safer2_recommender_tpu.models.base import MFState, Recommender, _log
from safer2_recommender_tpu.ops import woodbury


def _warn_interleaved_fallback(model) -> None:
    """One-time runtime notice when --block_interleaved cannot engage
    (dim % block_size != 0): the user asked for the reference-order
    fidelity trajectory but is getting the fast frozen sweep."""
    if model.cfg.block_interleaved and (
            model.cfg.dim % model.cfg.block_size) and not getattr(
            model, "_interleaved_fallback_warned", False):
        model._interleaved_fallback_warned = True
        _log.warning(
            "block_interleaved requested but dim %d is not a multiple of "
            "block_size %d — falling back to the frozen (fast) sweep; "
            "the reference-order fidelity trajectory needs "
            "dim %% block_size == 0",
            model.cfg.dim, model.cfg.block_size)


class IALSpp(Recommender):
    name = "ialspp"
    _stats_order = "post"

    @property
    def _loss_lags_one_epoch(self) -> bool:
        # In interleaved mode the stored loss is computed at end of
        # epoch from the carried prediction cache — it does NOT lag.
        return not (self.cfg.block_interleaved
                    and self.cfg.dim % self.cfg.block_size == 0)

    def _reg_vectors(self, dd: DeviceData):
        cfg = self.cfg
        ur = common.ials_reg(dd.user_hist_size, dd.num_items, cfg.l2_reg,
                             cfg.l2_reg_exp, cfg.uobs_weight)
        ir = common.ials_reg(dd.item_hist_size, dd.num_users, cfg.l2_reg,
                             cfg.l2_reg_exp, cfg.uobs_weight)
        return ur, ir

    def _spec_fn(self, num_choices: int):
        """Freq-scaled regularizer, unweighted history term
        (reference ialspp.h:85-145 + RegularizationValue)."""
        cfg = self.cfg

        def spec_fn(b):
            reg = common.ials_reg(b.length, num_choices, cfg.l2_reg,
                                  cfg.l2_reg_exp, cfg.uobs_weight)
            return common.BlockSpec(
                cg=jnp.full((b.n_rows,), cfg.uobs_weight, jnp.float32),
                reg=reg)
        return spec_fn

    def _epoch(self, state: MFState, dd: DeviceData) -> MFState:
        cfg = self.cfg
        _warn_interleaved_fallback(self)   # runs at trace time, once
        if cfg.block_interleaved and cfg.dim % cfg.block_size == 0:
            # Reference-order mode (ialspp.h:208-261): per block,
            # Step(user) then Step(item); loss from the carried
            # prediction slots like the reference's cache-based
            # ComputeUserLoss.
            u, v, preds_u = common.block_sweep_interleaved(
                state.user_emb, state.item_emb, dd.by_user, dd.by_item,
                self._spec_fn(dd.num_items), self._spec_fn(dd.num_users),
                bs=cfg.block_size, dtype=self.asm_dtype)
            gram = v.T @ v
            # mean=True: the reference's ComputeUserLoss divides by
            # |H_u| (ialspp.h 'loss /= user_history.size()'), matching
            # the frozen path's gather_and_losses.
            loss = common.losses_from_preds(
                preds_u, dd.by_user, u, gram, dd.num_users,
                cfg.uobs_weight, mean=True, halve=False)
            return state.replace(user_emb=u, item_emb=v,
                                 item_gramian=gram, user_loss=loss,
                                 steps=state.steps + 1)
        # The reference's end-of-epoch ComputeUserLoss (stats-only) is
        # shifted to the top of the next epoch so it shares the user
        # sweep's slab gathers (same move as IALS._epoch); the stored
        # user_loss describes the carried (pre-epoch) model.
        loss, pre = common.gather_and_losses(
            state.item_emb, dd.by_user, state.user_emb,
            state.item_gramian, dd.num_users, cfg.uobs_weight,
            halve=False, dtype=self.asm_dtype)
        # (Q, lam) of each sweep's frozen Gramian upgrades Woodbury-
        # eligible buckets to one full-dim block (block_sweep_frozen
        # docstring); warm-started from the previous epoch's basis.
        eig_u = woodbury.maybe_eigh(state.item_gramian, cfg.dim,
                                    use_cg=False, q_prev=state.eig_qu,
                                    refresh_tol=cfg.eig_refresh_tol)
        u = common.block_sweep_frozen(
            state.user_emb, state.item_emb, dd.by_user,
            state.item_gramian, self._spec_fn(dd.num_items),
            bs=cfg.block_size, dtype=self.asm_dtype, eig=eig_u,
            pre_list=pre)
        gram_u = u.T @ u
        eig_v = woodbury.maybe_eigh(gram_u, cfg.dim, use_cg=False,
                                    q_prev=state.eig_qv,
                                    refresh_tol=cfg.eig_refresh_tol)
        v = common.block_sweep_frozen(
            state.item_emb, u, dd.by_item, gram_u,
            self._spec_fn(dd.num_users), bs=cfg.block_size,
            dtype=self.asm_dtype, eig=eig_v)
        gram = v.T @ v
        return state.replace(user_emb=u, item_emb=v, item_gramian=gram,
                             user_loss=loss, steps=state.steps + 1,
                             eig_qu=eig_u[0] if eig_u else state.eig_qu,
                             eig_qv=eig_v[0] if eig_v else state.eig_qv)

    def _fold_in(self, state: MFState, fold: FoldInData) -> jax.Array:
        """8 blockwise fold-in epochs (reference ialspp.h:149-206); the
        item table is frozen throughout, so ONE slab gather per bucket
        serves all 8 x dim/block_size block solves.

        The fold-in trajectory follows the training mode — genuinely
        blockwise under cfg.block_interleaved, collapsed to one exact
        solve (full-dim Woodbury) in the default fast mode — see
        SAFER2pp._fold_in's docstring for the measured rationale;
        FRT_FOLDIN_EXACT / FRT_FOLDIN_BLOCKWISE override for A/Bs."""
        ue = jnp.zeros((fold.n_pad, self.cfg.dim), jnp.float32)
        blockwise = ((self.cfg.block_interleaved
                      or os.environ.get("FRT_FOLDIN_BLOCKWISE") == "1")
                     and os.environ.get("FRT_FOLDIN_EXACT") != "1")
        eig = None
        if not blockwise:
            eig = woodbury.maybe_eigh(state.item_gramian, self.cfg.dim,
                                      use_cg=False, q_prev=state.eig_qu,
                                      refresh_tol=self.cfg.eig_refresh_tol)
        return common.block_sweep_frozen(
            ue, state.item_emb, fold.by_user, state.item_gramian,
            self._spec_fn(self.num_items), bs=self.cfg.block_size,
            n_sweeps=self.cfg.eval_fold_in_epochs, dtype=self.asm_dtype,
            eig=eig)

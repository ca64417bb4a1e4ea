"""Ranking metrics: Recall@k, NDCG@k, and across-user metric-CVaR.

Vectorized equivalents of the reference's per-user evaluation
(reference recommender.h:132-199) and result aggregation
(reference evaluation.h:30-103):

  * top-k with ascending-index tie-break — ``lax.top_k`` matches the
    reference's nth_element + stable_sort behavior (recommender.h:143-153).
  * Recall@k normalized by min(k, |gt|) (recommender.h:156-165).
  * NDCG@k with ideal-DCG normalization over min(k, |gt|) positions
    (recommender.h:167-181).
  * metric-CVaR: lower-tail running mean of the sorted per-user metric,
    sampled at positions floor(n * alpha) (evaluation.h:83-102).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

_log = logging.getLogger("safer2_recommender_tpu")

DEFAULT_K_LIST = (5, 10, 20, 50, 100)
DEFAULT_ALPHA_LIST = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)


def topk_metrics(scores: jax.Array, excl: jax.Array, gt: jax.Array,
                 gt_len: jax.Array, k_list: Sequence[int]):
    """Compute Recall@k / NDCG@k for a chunk of users.

    scores [B, I] full-catalog scores; excl [B, H] history item ids (padded
    with I, dropped); gt [B, G] ground-truth ids (padded with I); gt_len [B].
    Returns (recall [B, K], ndcg [B, K]).
    """
    b, num_items = scores.shape
    # k beyond the catalog is clamped (the whole catalog is ranked);
    # the reference never exercises this (its k_list max 100 << items).
    max_k = min(int(max(k_list)), num_items)
    neg = jnp.finfo(scores.dtype).min
    # Mask training history to float lowest (recommender.h:137-140).
    rows = jnp.broadcast_to(jnp.arange(b)[:, None], excl.shape)
    masked = scores.at[rows.reshape(-1), excl.reshape(-1)].set(
        neg, mode="drop")
    _, top_ids = jax.lax.top_k(masked, max_k)              # [B, max_k]

    hits = jnp.any(
        top_ids[:, :, None] == gt[:, None, :], axis=-1
    ).astype(jnp.float32)                                   # [B, max_k]
    cum_hits = jnp.cumsum(hits, axis=1)

    gains = 1.0 / jnp.log2(jnp.arange(max_k, dtype=jnp.float32) + 2.0)
    cum_dcg = jnp.cumsum(hits * gains[None, :], axis=1)
    cum_ideal = jnp.cumsum(gains)                           # [max_k]

    gt_f = gt_len.astype(jnp.float32)
    recalls, ndcgs = [], []
    for k in k_list:
        kk = min(k, max_k)
        denom_r = jnp.minimum(float(k), gt_f)
        recalls.append(cum_hits[:, kk - 1] / jnp.maximum(denom_r, 1.0))
        ideal_idx = jnp.clip(jnp.minimum(k, gt_len) - 1, 0, max_k - 1)
        ndcgs.append(cum_dcg[:, kk - 1] / cum_ideal[ideal_idx])
    return jnp.stack(recalls, axis=1), jnp.stack(ndcgs, axis=1)


def topk_ids(scores: jax.Array, excl: jax.Array, k: int,
             approx: bool = False) -> jax.Array:
    """Top-k item ids for a chunk of users with training history masked
    out (the serving-path counterpart of ``topk_metrics``).

    scores [B, I]; excl [B, H] history ids (padded with I, dropped).
    ``approx=True`` uses ``jax.lax.approx_max_k`` (default ~0.95
    per-element recall target — near-ties may swap in/out); its speed
    depends on how the backend lowers it. Evaluation always uses the
    exact path (reference parity).
    """
    b, num_items = scores.shape
    neg = jnp.finfo(scores.dtype).min
    rows = jnp.broadcast_to(jnp.arange(b)[:, None], excl.shape)
    masked = scores.at[rows.reshape(-1), excl.reshape(-1)].set(
        neg, mode="drop")
    if approx:
        return jax.lax.approx_max_k(masked, min(k, num_items))[1]
    return jax.lax.top_k(masked, min(k, num_items))[1]


def metric_cvar(values: np.ndarray,
                alpha_list: Sequence[float]) -> np.ndarray:
    """Lower-tail running mean at positions floor(n*alpha).

    Exact port of EvaluationResult::cvar (reference evaluation.h:83-102):
    cvar[j] = mean(sorted_values[0 .. floor(n*alpha_j)]).
    """
    ms = np.sort(np.asarray(values, dtype=np.float64))
    n = ms.size
    if n == 0:        # no evaluable users: report zeros, don't crash
        return np.zeros(len(alpha_list), dtype=np.float32)
    prefix = np.cumsum(ms)
    out = np.zeros(len(alpha_list), dtype=np.float32)
    for j, a in enumerate(alpha_list):
        pos = int(n * a)
        pos = min(pos, n - 1)
        out[j] = prefix[pos] / (pos + 1)
    return out


@dataclasses.dataclass
class EvaluationResult:
    """Per-user metric matrices + formatted reporting.

    Mirrors reference EvaluationResult (evaluation.h:36-103); ``recall``
    and ``ndcg`` are [num_eval_users, len(k_list)] numpy arrays.
    """

    k_list: Sequence[int]
    alpha_list: Sequence[float]
    recall: np.ndarray
    ndcg: np.ndarray

    def format(self, measure_name: str, measurements) -> str:
        parts = [
            f"{measure_name}@{k}={m:.4f}"
            for k, m in zip(self.k_list, measurements)
        ]
        return " ".join(parts)

    def mean_recall(self) -> np.ndarray:
        return self.recall.mean(axis=0)

    def mean_ndcg(self) -> np.ndarray:
        return self.ndcg.mean(axis=0)

    def cvar(self, measurements) -> np.ndarray:
        return metric_cvar(measurements, self.alpha_list)

    def show(self) -> None:
        """Emit the reference's log lines (evaluation.h:61-81)."""
        _log.info(self.format("Mean Rec", self.mean_recall()))
        _log.info(self.format("Mean NDCG", self.mean_ndcg()))
        nk = len(self.k_list)
        rec_cvar = np.stack(
            [self.cvar(self.recall[:, i]) for i in range(nk)])
        ndcg_cvar = np.stack(
            [self.cvar(self.ndcg[:, i]) for i in range(nk)])
        for j, a in enumerate(self.alpha_list):
            _log.info(self.format(f"Rec CVaR (q={a:.2f})", rec_cvar[:, j]))
            _log.info(self.format(f"NDCG CVaR (q={a:.2f})", ndcg_cvar[:, j]))

"""Metric-engine tests against hand-computed cases (the behavioral
contract of reference recommender.h:132-199 and evaluation.h:83-102)."""

import math

import jax.numpy as jnp
import numpy as np

from safer2_recommender_tpu.evaluation.metrics import metric_cvar, topk_metrics


def test_topk_metrics_hand_case():
    num_items = 10
    # one user: scores rank items [9, 8, 7, ..., 0]
    scores = jnp.asarray(np.arange(10, dtype=np.float32)[None, :])
    # exclude item 9 -> effective ranking [8, 7, 6, ...]
    excl = jnp.asarray([[9, num_items]], dtype=jnp.int32)
    # ground truth: items 8 and 5 -> hits at ranks 0 and 3 (0-based)
    gt = jnp.asarray([[8, 5, num_items]], dtype=jnp.int32)
    gt_len = jnp.asarray([2], dtype=jnp.int32)
    k_list = (1, 2, 5)
    rec, ndcg = topk_metrics(scores, excl, gt, gt_len, k_list)
    rec, ndcg = np.asarray(rec)[0], np.asarray(ndcg)[0]

    # Recall@k = hits / min(k, |gt|)  (recommender.h:156-165)
    assert rec[0] == 1.0 / 1.0          # @1: hit 8, min(1,2)=1
    assert rec[1] == 1.0 / 2.0          # @2: one hit of two
    assert rec[2] == 2.0 / 2.0          # @5: both

    g = lambda i: 1.0 / math.log2(i + 2.0)
    # NDCG@k = DCG / ideal-DCG(min(k,|gt|)) (recommender.h:167-181)
    assert np.isclose(ndcg[0], g(0) / g(0))
    assert np.isclose(ndcg[1], g(0) / (g(0) + g(1)))
    assert np.isclose(ndcg[2], (g(0) + g(3)) / (g(0) + g(1)))


def test_topk_tie_break_by_index():
    # equal scores: lower item index must win (nth_element + stable_sort
    # over iota order, recommender.h:143-153)
    num_items = 6
    scores = jnp.asarray([[1.0, 1.0, 1.0, 1.0, 1.0, 1.0]])
    excl = jnp.asarray([[num_items]], dtype=jnp.int32)
    gt = jnp.asarray([[0, 1]], dtype=jnp.int32)
    gt_len = jnp.asarray([2], dtype=jnp.int32)
    rec, _ = topk_metrics(scores, excl, gt, gt_len, (2,))
    assert np.asarray(rec)[0, 0] == 1.0


def test_metric_cvar_reference_semantics():
    # evaluation.h:83-102: cvar[j] = mean(sorted[0..floor(n*alpha_j)])
    vals = np.array([0.5, 0.1, 0.9, 0.3, 0.7], dtype=np.float32)
    alphas = (0.2, 0.5, 0.9)
    got = metric_cvar(vals, alphas)
    s = np.sort(vals)
    want = [s[: int(5 * a) + 1].mean() for a in alphas]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_metric_cvar_is_lower_tail_mean():
    rng = np.random.default_rng(0)
    vals = rng.uniform(size=1000).astype(np.float32)
    got = metric_cvar(vals, (0.1,))[0]
    s = np.sort(vals)
    assert np.isclose(got, s[:101].mean(), rtol=1e-5)


def test_recommend_serving_api(tiny):
    # recommend() folds in new users and returns history-masked top-k
    # item ids aligned to the distinct users of the histories.
    import numpy as np

    from safer2_recommender_tpu import Config, Dataset, get_model

    ds, dd = tiny
    m = get_model("safer2", Config(dim=8, bandwidth=0.3),
                  ds.num_users, ds.num_items)
    m.initialize(dd)
    m.train_epoch(dd)

    hist = Dataset(ds.user_ids[:500], ds.item_ids[:500])
    users, recs = m.recommend(hist, k=7)
    assert users.shape[0] == np.unique(np.asarray(hist.user_ids)).size
    assert recs.shape == (users.shape[0], 7)
    assert (recs >= 0).all() and (recs < ds.num_items).all()
    # a user's own history never appears in their recommendations
    by_user = {}
    for u, i in zip(np.asarray(hist.user_ids), np.asarray(hist.item_ids)):
        by_user.setdefault(int(u), set()).add(int(i))
    for row, u in enumerate(users):
        assert not (set(recs[row].tolist()) & by_user[int(u)])


def test_recommend_approx_mode(tiny):
    # approx=True (jax.lax.approx_max_k; exact fallback on CPU) must keep
    # the serving invariants — valid original ids, history excluded —
    # and substantially agree with the exact ranking.
    import numpy as np

    from safer2_recommender_tpu import Config, Dataset, get_model

    ds, dd = tiny
    m = get_model("ials", Config(dim=8), ds.num_users, ds.num_items)
    m.train_epoch(dd)
    hist = Dataset(ds.user_ids[:400], ds.item_ids[:400])
    users, exact = m.recommend(hist, k=5)
    users2, approx = m.recommend(hist, k=5, approx=True)
    assert np.array_equal(users, users2)
    assert (approx >= 0).all() and (approx < ds.num_items).all()
    by_user = {}
    for u, i in zip(np.asarray(hist.user_ids), np.asarray(hist.item_ids)):
        by_user.setdefault(int(u), set()).add(int(i))
    overlaps = []
    for row, u in enumerate(users):
        s = set(approx[row].tolist())
        assert not (s & by_user[int(u)])
        overlaps.append(len(s & set(exact[row].tolist())) / 5.0)
    assert np.mean(overlaps) >= 0.7


def test_export_state_original_ids(tiny):
    # export_state must undo the solver-order renumbering: the exported
    # per-user loss of original user u equals the state vector at
    # solver position perm[u].
    import numpy as np

    from safer2_recommender_tpu import Config, get_model

    ds, dd = tiny
    m = get_model("safer2", Config(dim=8, bandwidth=0.3),
                  ds.num_users, ds.num_items)
    m.initialize(dd)
    m.train_epoch(dd)
    out = m.export_state(dd)
    perm_u = np.asarray(dd.user_perm)
    perm_i = np.asarray(dd.item_perm)
    loss = np.asarray(m.state.user_loss)
    ue = np.asarray(m.state.user_emb)
    ve = np.asarray(m.state.item_emb)
    for u in (0, 1, ds.num_users - 1):
        assert out["user_loss"][u] == loss[perm_u[u]]
        assert np.array_equal(out["user_emb"][u], ue[perm_u[u]])
    for i in (0, ds.num_items - 1):
        assert np.array_equal(out["item_emb"][i], ve[perm_i[i]])
    # export without dd falls back to the perms remembered at training
    out2 = m.export_state()
    assert np.array_equal(out2["user_emb"], out["user_emb"])


def test_recommend_decodes_solver_order_ids(tiny):
    # Model tables live in solver-order id space (DeviceData.build's
    # renumbering); recommend() must decode its top-k back to ORIGINAL
    # catalog ids: the returned top-1's solver-space score must equal
    # the history-masked maximum of the manually computed score row.
    import numpy as np

    from safer2_recommender_tpu import Config, Dataset, get_model
    from safer2_recommender_tpu.data.dataset import FoldInData

    ds, dd = tiny
    m = get_model("ials", Config(dim=8), ds.num_users, ds.num_items)
    m.train_epoch(dd)
    hist = Dataset(ds.user_ids[:300], ds.item_ids[:300])
    users, recs = m.recommend(hist, k=3)

    empty = Dataset(np.zeros(0, np.int32), np.zeros(0, np.int32))
    fold = m._permute_fold(FoldInData.build(hist, empty,
                                            num_items=ds.num_items))
    ue = np.asarray(m._fold_in_jit(m.state, fold))
    scores = ue @ np.asarray(m.state.item_emb).T
    excl = np.asarray(fold.excl)
    perm = np.asarray(dd.item_perm)
    for r in range(users.size):
        s = scores[r].copy()
        s[excl[r][excl[r] < ds.num_items]] = -np.inf
        assert np.isclose(s[perm[recs[r, 0]]], s.max(), rtol=1e-5)

"""Data-layer invariants: the bucketed layout must reproduce the COO set."""

import numpy as np

from safer2_recommender_tpu import Dataset, DeviceData, FoldInData


def _pairs_from_buckets(buckets):
    """Recover (row, col) pairs from padded buckets."""
    rows, cols = [], []
    for b in buckets:
        r = np.asarray(b.row_ids)
        c = np.asarray(b.col_ids)
        ln = np.asarray(b.length)
        for k in range(r.shape[0]):
            if ln[k] == 0:
                continue
            rows.extend([r[k]] * int(ln[k]))
            cols.extend(c[k, : ln[k]])
    return np.array(rows), np.array(cols)


def test_roundtrip(tiny):
    # Bucket ids live in solver-order space (DeviceData.build renumbers
    # so each bucket owns a contiguous table range); mapping back
    # through user_order/item_order must recover the COO multiset.
    ds, dd = tiny
    uo = np.asarray(dd.user_order)
    io = np.asarray(dd.item_order)
    rows, cols = _pairs_from_buckets(dd.by_user)
    rows, cols = uo[rows], io[cols]
    assert len(rows) == ds.nnz
    # by_user recovers the COO multiset
    assert sorted(zip(rows.tolist(), cols.tolist())) == sorted(
        zip(ds.user_ids.tolist(), ds.item_ids.tolist()))
    # the by_item view is the transposed multiset
    rows_i, cols_i = _pairs_from_buckets(dd.by_item)
    rows_i, cols_i = io[rows_i], uo[cols_i]
    assert len(rows_i) == ds.nnz
    assert sorted(zip(cols_i.tolist(), rows_i.tolist())) == sorted(
        zip(ds.user_ids.tolist(), ds.item_ids.tolist()))


def test_solver_order_contiguity(tiny):
    # The renumbering contract scatter_bucket/read_rows rely on: every
    # contiguous bucket's real rows are exactly
    # [row_start, row_start + n), consecutive across buckets; at most
    # the LAST bucket of a side may be non-contiguous (pad overhang),
    # and perm/order are inverse permutations.
    ds, dd = tiny
    for buckets, num, perm, order in (
            (dd.by_user, dd.num_users, dd.user_perm, dd.user_order),
            (dd.by_item, dd.num_items, dd.item_perm, dd.item_order)):
        perm = np.asarray(perm)
        order = np.asarray(order)
        assert np.array_equal(perm[order], np.arange(num))
        start = 0
        for i, b in enumerate(buckets):
            r = np.asarray(b.row_ids)
            n = int((np.asarray(b.length) > 0).sum())
            assert np.array_equal(r[:n], np.arange(start, start + n))
            if b.contiguous:
                assert int(b.row_start) == start
                assert start + b.n_rows <= num
            else:
                assert i == len(buckets) - 1
            start += n


def test_hist_and_reg_stats(tiny):
    ds, dd = tiny
    uo = np.asarray(dd.user_order)
    io = np.asarray(dd.item_order)
    uh = np.zeros(ds.num_users)
    np.add.at(uh, ds.user_ids, 1)
    # per-row vectors are stored in solver order
    assert np.array_equal(np.asarray(dd.user_hist_size), uh[uo])
    # item_reg = sum over the item's users of 1/|H_u| (safer2.h:831-837)
    ireg = np.zeros(ds.num_items)
    for u, i in zip(ds.user_ids, ds.item_ids):
        ireg[i] += 1.0 / uh[u]
    np.testing.assert_allclose(np.asarray(dd.item_reg), ireg[io],
                               rtol=1e-5)


def test_padding_sentinels(tiny):
    ds, dd = tiny
    for buckets, num, perm_other in (
            (dd.by_user, dd.num_users, dd.item_perm),
            (dd.by_item, dd.num_items, dd.user_perm)):
      pad_col = int(np.asarray(perm_other)[0])
      for b in buckets:
        r = np.asarray(b.row_ids)
        ln = np.asarray(b.length)
        # padded rows carry out-of-bounds ids (dropped by scatters)
        assert np.all(r[ln == 0] == num)
        # padded columns were id 0 before renumbering (masked by length
        # at gather time), so they now carry perm_other[0]
        c = np.asarray(b.col_ids)
        pos = np.arange(c.shape[1])[None, :]
        assert np.all(c[pos >= ln[:, None]] == pad_col)


def test_fold_in_data(tiny):
    ds, _ = tiny
    # use one half as "tr", other half as "te"
    half = ds.nnz // 2
    tr = Dataset(ds.user_ids[:half], ds.item_ids[:half])
    te = Dataset(ds.user_ids[half:], ds.item_ids[half:])
    fold = FoldInData.build(tr, te, num_items=ds.num_items)
    uniq = np.unique(tr.user_ids)
    assert fold.n_eval == uniq.size
    gt = np.asarray(fold.gt)
    gt_len = np.asarray(fold.gt_len)
    # ground truth rows must match te restricted to tr users
    for row in range(min(fold.n_eval, 20)):
        uid = uniq[row]
        expected = np.sort(te.item_ids[te.user_ids == uid])
        got = np.sort(gt[row, : gt_len[row]])
        assert np.array_equal(got, expected)


def test_contiguous_writeback_compiles_scatter_free():
    # The solver-order renumbering exists so write-backs compile to
    # dynamic-update-slices, not scatters. Guard it: with id gaps
    # providing pad slack (every bucket contiguous), the compiled epoch
    # must contain NO scatter op. A silent fall-back to the scatter path
    # would cost time without failing any other test.
    import jax
    import numpy as np

    from safer2_recommender_tpu import Config, Dataset, DeviceData, get_model

    rng = np.random.default_rng(0)
    # id gaps on BOTH sides -> gap rows absorb all pad overhang
    users = (rng.integers(0, 100, 4000) * 3 // 2).astype(np.int32)
    items = (rng.integers(0, 60, 4000) * 2).astype(np.int32)
    pairs = np.unique(np.stack([users, items], 1), axis=0).astype(np.int32)
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    dd = DeviceData.build(ds)
    assert all(b.contiguous for b in dd.by_user + dd.by_item)

    m = get_model("safer2", Config(dim=16, bandwidth=0.3),
                  ds.num_users, ds.num_items)
    hlo = jax.jit(m._epoch).lower(m.state, dd).compile().as_text()
    assert " scatter" not in hlo and "scatter(" not in hlo, (
        "epoch compiled with a scatter op despite contiguous buckets")


def test_bucket_splitting_matches_unsplit():
    # Tiny memory budget forces bucket row-chunking; training must be
    # numerically identical to the unsplit layout.
    import jax.numpy as jnp

    from safer2_recommender_tpu import Config, Dataset, DeviceData, get_model

    rng = np.random.default_rng(0)
    n = 4000
    pairs = np.unique(np.stack([rng.integers(0, 150, n),
                                rng.integers(0, 80, n)], 1), axis=0)
    ds = Dataset(pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32))

    dd_full = DeviceData.build(ds)
    dd_split = DeviceData.build(ds, dim=16,
                                memory_budget_bytes=64 * 16 * 16 * 4 * 3)
    assert len(dd_split.by_user) > len(dd_full.by_user)

    outs = []
    for dd in (dd_full, dd_split):
        m = get_model("ials", Config(dim=16, seed=7), ds.num_users,
                      ds.num_items)
        m.train_epoch(dd)
        outs.append(np.asarray(m.state.user_emb))
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-4, atol=2e-5)


def test_bucket_stacks_scan_matches_unsplit():
    # Heavier chunking makes several same-shape chunks per width; those
    # run as one lax.scan (models/common.py::BucketStack). Training must
    # stay numerically identical to the unsplit layout for both the
    # exact-solve and the blockwise model families.
    from safer2_recommender_tpu import Config, Dataset, DeviceData, get_model
    from safer2_recommender_tpu.models import common

    rng = np.random.default_rng(1)
    pairs = np.unique(np.stack([rng.integers(0, 300, 6000),
                                rng.integers(0, 120, 6000)], 1),
                      axis=0).astype(np.int32)
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    dd_plain = DeviceData.build(ds)
    dd_chunked = DeviceData.build(ds, dim=16, memory_budget_bytes=64 * 1024)
    assert any(isinstance(g, common.BucketStack)
               for g in common.group_same_shape(dd_chunked.by_user))

    for name in ("safer2", "safer2pp"):
        outs = []
        for dd in (dd_plain, dd_chunked):
            m = get_model(name,
                          Config(dim=16, block_size=8, bandwidth=0.15,
                                 alpha=0.3, seed=3),
                          ds.num_users, ds.num_items)
            m.initialize(dd)
            m.train_epoch(dd)
            outs.append(np.asarray(m.state.user_emb))
        np.testing.assert_allclose(outs[0], outs[1], rtol=2e-4, atol=2e-5)


def test_wide_streamed_assembly_matches_dense(monkeypatch):
    # Zipf-head rows (hot items with 10^5+ users at MSD scale) stream
    # their history through column chunks (ops/assemble.py::wide_*)
    # instead of materializing the [N, L, d] slab; the result must match
    # the dense path exactly.
    from safer2_recommender_tpu import Config, Dataset, DeviceData, get_model
    import safer2_recommender_tpu.ops.assemble as assemble

    rng = np.random.default_rng(2)
    hot = np.stack([np.arange(600), np.zeros(600, dtype=np.int64)], 1)
    tail = np.stack([rng.integers(0, 600, 5000),
                     rng.integers(1, 80, 5000)], 1)
    pairs = np.unique(np.concatenate([hot, tail]), axis=0).astype(np.int32)
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    dd = DeviceData.build(ds)

    def run(name):
        m = get_model(name, Config(dim=16, bandwidth=0.15, alpha=0.3,
                                   seed=5), ds.num_users, ds.num_items)
        m.initialize(dd)
        m.train_epoch(dd)
        return np.asarray(m.state.item_emb), np.asarray(m.state.user_loss)

    # blockwise models stream the zipf head through wide_block_system
    # (per-chunk recomputed predictions), exact models through
    # wide_assemble/wide_matvec — all must match the dense path.
    for name in ("safer2", "cvar_mf", "ialspp", "safer2pp"):
        v_ref, l_ref = run(name)
        monkeypatch.setattr(assemble, "WIDE_SLAB_BYTES", 1)
        monkeypatch.setattr(assemble, "WIDE_CHUNK", 256)
        v_wide, l_wide = run(name)
        monkeypatch.undo()
        np.testing.assert_allclose(v_wide, v_ref, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(l_wide, l_ref, rtol=2e-4, atol=2e-5)


def test_fold_in_empty_datasets():
    # Degenerate splits must build (the n_eval == 0 index fallback used
    # to be float64 and crashed the ragged fill).
    empty = Dataset(np.zeros(0, np.int32), np.zeros(0, np.int32))
    te = Dataset(np.array([0, 1], np.int32), np.array([1, 2], np.int32))
    assert FoldInData.build(empty, te, num_items=5).n_pad > 0
    assert FoldInData.build(te, empty, num_items=5).n_pad > 0


def test_eval_chunk_need_not_divide_fold_padding(tiny):
    # Config.eval_chunk is user-settable; _eval_metrics must chunk any
    # fold padding (it used to assert divisibility against the fold's
    # own independent default).
    from safer2_recommender_tpu import Config, get_model

    ds, dd = tiny
    tr = Dataset(ds.user_ids[::2], ds.item_ids[::2])
    te = Dataset(ds.user_ids[1::2], ds.item_ids[1::2])
    fold = FoldInData.build(tr, te, num_items=ds.num_items)
    m = get_model("ials", Config(dim=8, eval_chunk=600),
                  ds.num_users, ds.num_items)
    m.initialize(dd)
    m.train_epoch(dd)
    res = m.evaluate_dataset(fold)
    assert res.recall.shape[0] > 0


def test_loss_decomposition_streams_wide_buckets(monkeypatch):
    # --print_train_stats at MSD scale used to materialize the full
    # [N, L, d] slab per bucket (OOM); the wide path must stream and
    # produce the same observed-loss total.
    from safer2_recommender_tpu import Config, Dataset, DeviceData, get_model
    from safer2_recommender_tpu.models import stats
    import safer2_recommender_tpu.ops.assemble as assemble

    rng = np.random.default_rng(3)
    hot = np.stack([np.zeros(700, dtype=np.int64), np.arange(700)], 1)
    tail = np.stack([rng.integers(1, 60, 4000),
                     rng.integers(0, 700, 4000)], 1)
    pairs = np.unique(np.concatenate([hot, tail]), axis=0).astype(np.int32)
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    dd = DeviceData.build(ds)
    m = get_model("ials", Config(dim=16), ds.num_users, ds.num_items)
    m.initialize(dd)

    def decomp():
        ur, ir = m._reg_vectors(dd)
        return [float(v) for v in stats.loss_decomposition(
            m.state.user_emb, m.state.item_emb, m.state.user_loss, dd,
            ur, ir, m.cfg.uobs_weight, loss_is_user_sum=False)]

    dense = decomp()
    monkeypatch.setattr(assemble, "WIDE_SLAB_BYTES", 1)
    monkeypatch.setattr(assemble, "WIDE_CHUNK", 256)
    wide = decomp()
    np.testing.assert_allclose(wide, dense, rtol=2e-4)


def test_bucket_edges_rejects_degenerate_ladder():
    import pytest

    from safer2_recommender_tpu.data.dataset import _bucket_edges

    with pytest.raises(ValueError):
        _bucket_edges(100, 8, growth=1)   # would loop forever
    with pytest.raises(ValueError):
        _bucket_edges(100, 0, growth=2)

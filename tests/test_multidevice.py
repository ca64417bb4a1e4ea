"""Multi-device SPMD tests (a capability the reference never had —
its parallelism is pthread-only, SURVEY.md section 2 P7).

Runs the full SAFER2 training step over an 8-device CPU mesh with bucket
rows sharded on the "data" axis and checks numerical agreement with the
unsharded run.
"""

import jax
import numpy as np
import pytest

from safer2_recommender_tpu import Config, DeviceData, get_model
from safer2_recommender_tpu.parallel import get_mesh


@pytest.fixture(scope="module")
def mesh():
    if jax.device_count() < 2:
        pytest.skip("needs >= 2 devices")
    return get_mesh()


@pytest.mark.parametrize(
    "name", ["ials", "ialspp", "erm_mf", "cvar_mf", "safer2", "safer2pp"])
def test_sharded_epoch_matches_single_device(tiny, mesh, name):
    ds, _ = tiny
    cfg = Config(dim=8, block_size=4)

    dd_single = DeviceData.build(ds)
    dd_sharded = DeviceData.build(ds, mesh=mesh)

    m1 = get_model(name, cfg, ds.num_users, ds.num_items)
    m1.initialize(dd_single)
    m1.train_epoch(dd_single)

    m2 = get_model(name, cfg, ds.num_users, ds.num_items, mesh=mesh)
    m2.initialize(dd_sharded)
    m2.train_epoch(dd_sharded)

    np.testing.assert_allclose(
        np.asarray(m1.state.user_emb), np.asarray(m2.state.user_emb),
        rtol=5e-3, atol=5e-5)
    np.testing.assert_allclose(
        np.asarray(m1.state.user_loss), np.asarray(m2.state.user_loss),
        rtol=5e-3, atol=5e-5)


def test_sharded_bucket_row_counts_divisible(tiny, mesh):
    ds, _ = tiny
    dd = DeviceData.build(ds, mesh=mesh)
    n_dev = jax.device_count()
    for b in dd.by_user + dd.by_item:
        assert b.row_ids.shape[0] % n_dev == 0


def test_sharded_woodbury_matches_single_device(tiny, mesh):
    # dim 128 opens the Woodbury gate (ops/woodbury.py MIN_DIM); the
    # eigendecomposition is replicated while bucket rows stay sharded.
    import jax.numpy as jnp

    ds, _ = tiny
    cfg = Config(dim=128)

    m1 = get_model("safer2", cfg, ds.num_users, ds.num_items)
    dd1 = DeviceData.build(ds, dim=128)
    m1.initialize(dd1)
    m1.train_epoch(dd1)

    m2 = get_model("safer2", cfg, ds.num_users, ds.num_items, mesh=mesh)
    dd2 = DeviceData.build(ds, mesh=mesh, dim=128)
    m2.initialize(dd2)
    m2.train_epoch(dd2)

    np.testing.assert_allclose(np.asarray(m1.state.user_emb),
                               np.asarray(m2.state.user_emb),
                               rtol=5e-3, atol=5e-5)


@pytest.mark.parametrize("d", [32, 128])
def test_spd_solve_partitions_over_batch(mesh, d):
    # the path spd_solve picks for this backend and width (CPU: LAPACK at
    # 32, the factored recursion at 128) must run per shard: a batch
    # sharded over the mesh stays sharded and is never gathered.
    from jax.sharding import NamedSharding, PartitionSpec as P

    from safer2_recommender_tpu.ops import block_chol

    rng = np.random.default_rng(0)
    n = 64
    x = rng.normal(size=(n, d + 3, d)).astype(np.float32)
    a = np.einsum("nld,nle->nde", x, x) + 2.0 * np.eye(d, dtype=np.float32)
    b = rng.normal(size=(n, d)).astype(np.float32)
    ref = np.linalg.solve(a.astype(np.float64), b[..., None])[..., 0]

    a_s = jax.device_put(a, NamedSharding(mesh, P("data", None, None)))
    b_s = jax.device_put(b, NamedSharding(mesh, P("data", None)))
    jitted = jax.jit(block_chol.spd_solve)
    out = jitted(a_s, b_s)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-3, atol=2e-4)
    assert out.sharding.spec == P("data")
    txt = jitted.lower(a_s, b_s).compile().as_text()
    assert "all-gather" not in txt


def test_sharded_evaluation_matches_single_device(tiny, mesh):
    # fold-in + full-catalog scoring + metrics under a sharded fold must
    # reproduce the single-device evaluation numbers.
    from safer2_recommender_tpu import Config, FoldInData, get_model
    from safer2_recommender_tpu.data.dataset import Dataset

    ds, _ = tiny
    tr = Dataset(ds.user_ids[::2], ds.item_ids[::2])
    te = Dataset(ds.user_ids[1::2], ds.item_ids[1::2])
    cfg = Config(dim=8, bandwidth=0.3)

    dd1 = DeviceData.build(ds)
    m1 = get_model("safer2", cfg, ds.num_users, ds.num_items)
    m1.initialize(dd1)
    m1.train_epoch(dd1)
    f1 = FoldInData.build(tr, te, num_items=ds.num_items)
    r1 = m1.evaluate_dataset(f1)

    dd2 = DeviceData.build(ds, mesh=mesh)
    m2 = get_model("safer2", cfg, ds.num_users, ds.num_items, mesh=mesh)
    m2.initialize(dd2)
    m2.train_epoch(dd2)
    f2 = FoldInData.build(tr, te, num_items=ds.num_items, mesh=mesh)
    r2 = m2.evaluate_dataset(f2)

    np.testing.assert_allclose(r1.mean_ndcg(), r2.mean_ndcg(),
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(r1.mean_recall(), r2.mean_recall(),
                               rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("name,budget_ratio", [("safer2", 3.0),
                                               ("safer2pp", 2.5),
                                               ("ials", 3.0)])
def test_epoch_collective_bytes_bounded(tiny, mesh, name, budget_ratio):
    # Regression gate on the epoch's REAL cross-device traffic, measured
    # from compiled HLO (parallel/audit.py): with bucket rows sharded
    # and tables replicated, each sweep's solved rows all-gather back
    # into the replicated tables, so per-epoch collective bytes land at
    # ~1-2.5x the (U+V) table bytes (measured: safer2 2.2x, safer2pp
    # 1.1x, scripts/audit_collectives.py). If a sharding change ever
    # makes XLA gather the [N, L, d] history slabs or the per-row
    # normal equations across devices instead, this blows past the
    # budget by an order of magnitude. docs/SCALING.md's multi-host
    # model is derived from these same numbers.
    from safer2_recommender_tpu.parallel.audit import (collective_traffic,
                                                       total_bytes)

    ds, _ = tiny
    cfg = Config(dim=16, block_size=8, compute_dtype="f32")
    dd = DeviceData.build(ds, mesh=mesh)
    m = get_model(name, cfg, ds.num_users, ds.num_items, mesh=mesh)
    hlo = jax.jit(m._epoch).lower(m.state, dd).compile().as_text()
    traffic = collective_traffic(hlo)
    assert traffic, "sharded epoch compiled to zero collectives?"
    table_bytes = (ds.num_users + ds.num_items) * cfg.dim * 4
    slack = 256 * 1024  # Gramians/stats/quantile scalars at tiny scale
    assert total_bytes(traffic) <= budget_ratio * table_bytes + slack, (
        f"{name}: {total_bytes(traffic)} collective bytes vs "
        f"{table_bytes} table bytes — traffic model broken: {traffic}")


# (the former mocked multi-host `put` signature test is superseded by
# tests/test_distributed.py, which runs the REAL 2-process branch:
# a dropped global_shape would concatenate the hosts' identical copies
# and fail its state-equality assert)


@pytest.mark.parametrize("name", ["safer2", "safer2pp"])
def test_eval_collective_bytes_bounded(tiny, mesh, name):
    # Regression gate on the EVAL path's cross-device traffic (VERDICT
    # r2 item 7): fold-in (safer2: one exact sweep; safer2pp: 8
    # blockwise sweeps, reference ialspp.h:149-206) plus the chunked
    # scoring/top-k program. Measured behavior: fold-in gathers the
    # solved eval rows back (~1x the [n_pad, dim] table per sweep
    # family), and _eval_metrics reshards its four row-aligned operands
    # into the chunked layout once (~1x their combined bytes). A
    # sharding regression — e.g. the [chunk, num_items] score matrices
    # or the [N, L, d] fold-in slabs gathering across devices — lands
    # an order of magnitude above this budget. Before round 3 the whole
    # eval path compiled REPLICATED (zero collectives, no scaling), so
    # the gate also asserts traffic is nonzero.
    from safer2_recommender_tpu import FoldInData
    from safer2_recommender_tpu.data.dataset import Dataset
    from safer2_recommender_tpu.parallel.audit import (collective_traffic,
                                                       total_bytes)

    ds, _ = tiny
    tr = Dataset(ds.user_ids[::2], ds.item_ids[::2])
    te = Dataset(ds.user_ids[1::2], ds.item_ids[1::2])
    cfg = Config(dim=16, block_size=8, compute_dtype="f32")
    m = get_model(name, cfg, ds.num_users, ds.num_items, mesh=mesh)
    fold = FoldInData.build(tr, te, num_items=ds.num_items, dim=16,
                            mesh=mesh)
    k_list = (5, 10, 20, 50, 100)

    hlo_f = jax.jit(m._fold_in).lower(m.state, fold).compile().as_text()
    ue = m._fold_in_jit(m.state, fold)
    hlo_e = (jax.jit(m._eval_metrics, static_argnames=("k_list",))
             .lower(ue, m.state.item_emb, fold, k_list=k_list)
             .compile().as_text())

    tf = collective_traffic(hlo_f)
    te_ = collective_traffic(hlo_e)
    assert tf, f"{name}: fold-in compiled replicated (zero collectives)"
    assert te_, f"{name}: eval compiled replicated (zero collectives)"

    ue_bytes = fold.n_pad * cfg.dim * 4
    input_bytes = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                      for x in (fold.excl, fold.gt, fold.gt_len)) + ue_bytes
    sweeps = cfg.eval_fold_in_epochs if name == "safer2pp" else 1
    slack = 256 * 1024
    assert total_bytes(tf) <= 2.0 * sweeps * ue_bytes + slack, (
        f"{name} fold-in: {total_bytes(tf)} collective bytes vs "
        f"{ue_bytes} ue bytes — eval traffic model broken: {tf}")
    assert total_bytes(te_) <= 2.0 * input_bytes + slack, (
        f"{name} eval: {total_bytes(te_)} collective bytes vs "
        f"{input_bytes} input bytes — eval traffic model broken: {te_}")


def test_sharded_rotated_direct_matches_single_device(mesh):
    # Buckets wider than dim/2 take the eigenbasis-rotated direct path
    # (vector ridge through the batched solver); it must agree with the
    # single-device run under SPMD sharding.
    import numpy as np

    from safer2_recommender_tpu.data.dataset import Dataset

    rng = np.random.default_rng(7)
    hot = np.stack([np.zeros(150, np.int64), np.arange(150)], 1)
    tail = np.stack([rng.integers(1, 120, 2000),
                     rng.integers(0, 150, 2000)], 1)
    pairs = np.unique(np.concatenate([hot, tail]), axis=0).astype(np.int32)
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    cfg = Config(dim=128)

    m1 = get_model("safer2", cfg, ds.num_users, ds.num_items)
    dd1 = DeviceData.build(ds, dim=128)
    m1.initialize(dd1)
    m1.train_epoch(dd1)

    m2 = get_model("safer2", cfg, ds.num_users, ds.num_items, mesh=mesh)
    dd2 = DeviceData.build(ds, mesh=mesh, dim=128)
    m2.initialize(dd2)
    m2.train_epoch(dd2)

    np.testing.assert_allclose(np.asarray(m1.state.user_emb),
                               np.asarray(m2.state.user_emb),
                               rtol=5e-3, atol=5e-5)


@pytest.mark.parametrize("kind", ["none", "rows", "replicated"])
def test_put_places_with_sharding(mesh, kind):
    # put = jax.device_put honoring sharding=None: values round-trip and
    # the array carries the requested sharding
    from jax.sharding import NamedSharding, PartitionSpec as P

    from safer2_recommender_tpu.parallel import mesh as pmesh

    sh = {"none": None,
          "rows": NamedSharding(mesh, P("data", None)),
          "replicated": NamedSharding(mesh, P())}[kind]
    x = np.random.default_rng(5).normal(size=(64, 33)).astype(np.float32)
    got = pmesh.put(x, sh)
    np.testing.assert_array_equal(np.asarray(got), x)
    if sh is not None:
        assert got.sharding.is_equivalent_to(sh, x.ndim)
    else:
        assert len(got.devices()) == 1
    if kind != "rows":                 # 0-d scalars have no rows
        assert float(pmesh.put(np.float32(3.0), sh)) == 3.0

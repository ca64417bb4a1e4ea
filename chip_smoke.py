"""Smoke test of the main path on one NVIDIA GPU.

    python chip_smoke.py               # six phases on one card
    python chip_smoke.py --four-cards  # the 4-card mesh against 1 card

Run from the root of a checkout. One process drives the card through the
entry points a user calls, in phases; each prints one line, and the
first failure ends the run with a non-zero exit:

1. device: JAX's backend must be the GPU; the card's name and power
   limit come from ``nvidia-smi``.
2. solver: ``spd_solve`` at the sweeps' widths against a float64 numpy
   solve, plus the zero-row and rank-deficient cases.
3. oracles: one epoch of each model at the sizes of
   ``tests/test_numpy_oracle.py`` against its float64 oracles, under
   ``jax.default_matmul_precision("highest")``.
4. cli: the README's ML-1M SAFER2 dim-32 command, 10 epochs, on the
   bundled split; mean NDCG@20 must reach 0.2.
5. full width: all six models, 2 epochs at dim 512 (README MSD config)
   on the 50k-user power-law workload, then ``evaluate_dataset`` on a
   held-out fold.
6. serving: ``Server`` on the trained SAFER2 model.

The last line of standard output is the JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ML1M_DIR = os.path.join(REPO, "tests", "ml-1m")

MODELS = ("ials", "ialspp", "erm_mf", "cvar_mf", "safer2", "safer2pp")
SOLVER_SHAPES = ((4096, 32), (2048, 128), (1024, 256), (256, 512),
                 (16, 512))
# The CPU suite's bound for spd_solve (tests/test_ops.py): f32 solves of
# systems whose condition number the ridge keeps below ~1e3.
SOLVER_RTOL, SOLVER_ATOL = 2e-3, 2e-4
# Four cards against one: the CPU suite's mesh bound
# (tests/test_multidevice.py): sums are split differently per device.
MESH_RTOL, MESH_ATOL = 5e-3, 5e-5
ALPHA_BAND = 0.02


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def msd_config(dim: int = 512):
    """The README's MSD SAFER2 config (bench.py uses the same)."""
    from safer2_recommender_tpu import Config

    return Config(dim=dim, uobs_weight=0.0004, l2_reg=0.0012, alpha=0.3,
                  bandwidth=0.1, use_snr=True, sampling_ratio=0.1,
                  xi_iterations=5, pd_iterations=1,
                  block_size=min(64, dim), stepsize=0.1)


def workload(users: int, items: int, fold_users: int, seed: int = 0):
    """Training Dataset from ``data/synth.py::powerlaw_dataset`` and a
    held-out FoldInData of ``fold_users`` fresh users from the same
    distribution (each history split 80/20 into fold-in / ground
    truth)."""
    from safer2_recommender_tpu import Dataset
    from safer2_recommender_tpu.data.synth import powerlaw_dataset

    ds = Dataset(*powerlaw_dataset(users, items, seed=seed))
    fu, fi = powerlaw_dataset(fold_users, items, seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    fu, fi = _dedup(fu, fi)
    test = rng.random(fu.size) < 0.2
    return ds, Dataset(fu[~test], fi[~test]), Dataset(fu[test], fi[test])


def _dedup(u, i):
    pairs = np.unique(np.stack([u, i], 1), axis=0)
    return pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)


def _block(x):
    import jax

    return jax.block_until_ready(x)


# ---- phase 1 --------------------------------------------------------------


def phase_device():
    from safer2_recommender_tpu.utils.device import (
        card_name_and_power_limit,
        require_gpu,
    )

    device = require_gpu()
    card = card_name_and_power_limit()
    say("device", f"{device['kind']} x{device['count']}; "
                  f"nvidia-smi: {card}")
    return device, card


# ---- phase 2 --------------------------------------------------------------


def phase_solver(shapes=SOLVER_SHAPES, seed: int = 0) -> dict:
    """spd_solve with a per-system ridge against float64 numpy; returns
    the max relative error for each shape."""
    import jax.numpy as jnp

    from safer2_recommender_tpu.ops import block_chol

    rng = np.random.default_rng(seed)
    errs = {}
    for n, d in shapes:
        g = rng.normal(size=(n, d, d)).astype(np.float32)
        a = np.einsum("nij,nkj->nik", g, g) / d
        b = rng.normal(size=(n, d)).astype(np.float32)
        ridge = rng.uniform(0.01, 0.5, n).astype(np.float32)
        t0 = time.perf_counter()
        x = np.asarray(_block(block_chol.spd_solve(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(ridge))))
        first_s = time.perf_counter() - t0
        want = np.linalg.solve(
            a.astype(np.float64) + ridge[:, None, None] * np.eye(d),
            b.astype(np.float64)[..., None])[..., 0]
        np.testing.assert_allclose(x, want, rtol=SOLVER_RTOL,
                                   atol=SOLVER_ATOL,
                                   err_msg=f"spd_solve [{n}, {d}]")
        errs[(n, d)] = float(np.max(np.abs(x - want))
                             / np.max(np.abs(want)))
        say("solver", f"[{n}, {d}, {d}] max rel err {errs[(n, d)]:.3e} "
                      f"(first call {first_s:.2f} s)")

    # an all-zero (padded) system next to real ones
    a = np.einsum("nij,nkj->nik", *(2 * [rng.normal(
        size=(8, 16, 16)).astype(np.float32)])) / 16 + 0.05 * np.eye(16)
    a = a.astype(np.float32)
    a[3] = 0.0
    b = rng.normal(size=(8, 16)).astype(np.float32)
    x = np.asarray(block_chol.spd_solve(jnp.asarray(a), jnp.asarray(b)))
    assert np.isfinite(x).all(), "zero-row system came back nonfinite"
    want = np.linalg.solve(a[4:].astype(np.float64), b[4:, :, None])[..., 0]
    np.testing.assert_allclose(x[4:], want, rtol=SOLVER_RTOL,
                               atol=SOLVER_ATOL)
    # exactly singular PSD systems with a nonzero diagonal (l2_reg=0,
    # history 3 < dim 16)
    v = rng.normal(size=(6, 3, 16)).astype(np.float32)
    x = np.asarray(block_chol.spd_solve(
        jnp.asarray(np.einsum("nld,nle->nde", v, v)),
        jnp.asarray(v.sum(1))))
    assert np.isfinite(x).all(), "rank-deficient system came back nonfinite"
    say("solver", f"ok: {len(shapes)} shapes within rtol={SOLVER_RTOL} "
                  f"atol={SOLVER_ATOL}; zero-row and rank-deficient "
                  "systems finite")
    return errs


# ---- phase 3 --------------------------------------------------------------


def _tolerance_ratio(cases) -> float:
    """max over cases of |got - want| / (atol + rtol |want|): <= 1 is
    within the oracle's tolerance."""
    worst = 0.0
    for _, got, want, rtol, atol in cases:
        got = np.asarray(got, np.float64)
        want = np.asarray(want, np.float64)
        excess = np.abs(got - want) / (atol + rtol * np.abs(want) + 1e-300)
        worst = max(worst, float(np.max(excess)) if excess.size else 0.0)
    return worst


def phase_oracles(names=None) -> dict:
    """The float64 oracles of tests/test_numpy_oracle.py, each run at
    HIGHEST matmul precision (gated) and at default precision (reported
    only: an f32 matmul may run in TF32 there)."""
    import jax

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_numpy_oracle as oracles

    ds, dd = oracles.small_dataset()
    chosen = [n for n in oracles.ORACLES if names is None or n in names]

    def run(name):
        fn, kw = oracles.ORACLES[name]
        t0 = time.perf_counter()
        with jax.default_matmul_precision("highest"):
            cases = fn(ds, dd, **kw)
        oracles.assert_cases(cases)
        return (_tolerance_ratio(cases),
                _tolerance_ratio(fn(ds, dd, **kw)),
                time.perf_counter() - t0)

    # independent models: overlap their compiles
    with ThreadPoolExecutor(max_workers=len(chosen)) as pool:
        results = list(pool.map(run, chosen))
    out = {}
    for name, (high, default, secs) in zip(chosen, results):
        out[name] = (high, default)
        say("oracles", f"{name}: error/tolerance {high:.3f} at highest, "
                       f"{default:.3f} at default precision "
                       f"({secs:.1f} s, concurrent)")
    say("oracles", f"ok: {len(out)} oracles within tolerance at highest "
                   f"precision; worst default-precision ratio "
                   f"{max(d for _, d in out.values()):.3f} (not gated)")
    return out


# ---- phase 4 --------------------------------------------------------------


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def phase_cli(epochs: int = 10, min_ndcg: float = 0.2) -> float:
    """The README's ML-1M SAFER2 dim-32 command through ``cli.main``."""
    from safer2_recommender_tpu import cli

    data = lambda f: os.path.join(ML1M_DIR, f)  # noqa: E731
    argv = ["--model_name", "safer2", "--dim", "32",
            "--uobs_weight", "0.004", "--alpha", "0.3", "--l2_reg", "0.004",
            "--bandwidth", "0.15", "--xi_iterations", "5",
            "--pd_iterations", "1", "--stdev", "0.1",
            "--epoch", str(epochs),
            "--train_data", data("train.csv"),
            "--test_train_data", data("validation_tr.csv"),
            "--test_test_data", data("validation_te.csv")]
    log = logging.getLogger("safer2_recommender_tpu")
    grab = _Lines()
    log.addHandler(grab)
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
    finally:
        log.removeHandler(grab)
    wall = time.perf_counter() - t0
    assert rc == 0, f"cli.main returned {rc}"
    epoch_ms = [int(m.group(1)) for m in
                (re.match(r"Epoch: \d+, Timer: Train=(\d+)", s)
                 for s in grab.lines) if m]
    assert len(epoch_ms) == epochs, (
        f"{len(epoch_ms)} epoch lines for {epochs} epochs")
    ndcg = [float(m.group(1)) for m in
            (re.search(r"Mean NDCG@20=([0-9.]+)", s) for s in grab.lines)
            if m]
    assert ndcg, "no Mean NDCG@20 line"
    assert ndcg[-1] >= min_ndcg, (
        f"mean NDCG@20 {ndcg[-1]:.4f} < {min_ndcg}")
    say("cli", f"ok: {epochs} epoch lines (first {epoch_ms[0]} ms, last "
               f"{epoch_ms[-1]} ms), mean NDCG@20 {ndcg[-1]:.4f} >= "
               f"{min_ndcg}; {wall:.1f} s in all")
    return ndcg[-1]


# ---- phase 5 --------------------------------------------------------------


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return stats.get("peak_bytes_in_use") if stats else None


def phase_full_width(users: int = 50_000, items: int = 40_000,
                     dim: int = 512, fold_users: int = 5_000,
                     models=MODELS, seed: int = 0):
    """Every model through get_model -> initialize -> train_epochs (2
    epochs: the first compiles) -> evaluate_dataset. Returns the trained
    safer2 model (or the last one) and its training Dataset."""
    from safer2_recommender_tpu import DeviceData, FoldInData, get_model
    from safer2_recommender_tpu.data.dataset import BUCKET_BUDGET_BYTES
    from safer2_recommender_tpu.models.common import (
        FUSE_BUDGET_BYTES,
        SOLVE_GROUP_BYTES,
    )
    from safer2_recommender_tpu.ops.assemble import WIDE_SLAB_BYTES
    from safer2_recommender_tpu.parallel.mesh import memory_budget

    say("full width", "budgets (bytes): " + ", ".join(
        f"{k} {memory_budget(v)}" for k, v in (
            ("bucket", BUCKET_BUDGET_BYTES),
            ("solve group", SOLVE_GROUP_BYTES),
            ("fuse", FUSE_BUDGET_BYTES), ("wide slab", WIDE_SLAB_BYTES))))
    t0 = time.perf_counter()
    ds, fold_tr, fold_te = workload(users, items, fold_users, seed)
    dd = DeviceData.build(ds, dim=dim)
    fold = FoldInData.build(fold_tr, fold_te, num_items=ds.num_items,
                            dim=dim)
    say("full width", f"workload {ds.num_users} users x {ds.num_items} "
                      f"items, {ds.nnz} interactions; fold "
                      f"{fold.n_eval} users; built in "
                      f"{time.perf_counter() - t0:.1f} s")
    cfg = msd_config(dim)

    def warm(name):
        # initialize, the first (compiling) epoch and a first evaluation;
        # the six models run this concurrently so their compiles overlap
        m = get_model(name, cfg, ds.num_users, ds.num_items)
        t0 = time.perf_counter()
        m.initialize(dd)
        m.train_epochs(dd, 1)
        _block(m.state)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        m.evaluate_dataset(fold, k_list=(20,))
        return m, t_first, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(models)) as pool:
        warmed = dict(zip(models, pool.map(warm, models)))
    say("full width", f"{len(models)} models initialized, trained one "
                      f"epoch and evaluated concurrently in "
                      f"{time.perf_counter() - t0:.1f} s")
    keep = None
    for name in models:
        m, t_first, t_eval = warmed.pop(name)
        t0 = time.perf_counter()
        m.train_epochs(dd, 1)
        _block(m.state)
        t_epoch = time.perf_counter() - t0
        loss = np.asarray(m.state.user_loss)
        assert np.isfinite(loss).all(), f"{name}: nonfinite loss"
        msg = (f"{name}: init + first epoch {t_first:.2f} s, first eval "
               f"{t_eval:.2f} s (concurrent), steady epoch "
               f"{t_epoch * 1e3:.1f} ms, mean loss {loss.mean():.5f}")
        if name in ("safer2", "safer2pp"):
            msg += ", mean dual " + _dual_converges(m, dd, cfg.alpha)
        res = m.evaluate_dataset(fold, k_list=(20,))
        assert np.isfinite(res.ndcg).all(), f"{name}: nonfinite NDCG"
        msg += (f", NDCG@20 {float(res.ndcg.mean(0)[0]):.4f}, peak device "
                f"bytes {_peak_bytes()}")
        say("full width", msg)
        if name == "safer2" or "safer2" not in models:
            keep = (m, ds)
        del m
    say("full width", f"ok: {len(models)} models at dim {dim}")
    return keep


def _dual_converges(model, dd, alpha: float, max_epochs: int = 10) -> str:
    """Mean dual weight after each further epoch until it is within
    ``ALPHA_BAND`` of alpha (Proposition C.1; the tests' gate), for at
    most ``max_epochs`` epochs in all. Early epochs lag: xi follows the
    fast-falling losses a few Newton steps at a time."""
    trail = [model.get_mean_weight()]
    epochs = int(np.asarray(model.state.steps))
    while abs(trail[-1] - alpha) > ALPHA_BAND and epochs < max_epochs:
        model.train_epochs(dd, 1)
        epochs += 1
        trail.append(model.get_mean_weight())
    assert abs(trail[-1] - alpha) <= ALPHA_BAND, (
        f"{model.name}: mean dual {trail} never within {ALPHA_BAND} of "
        f"alpha {alpha} in {max_epochs} epochs")
    return " -> ".join(f"{x:.4f}" for x in trail) + f" (epoch {epochs})"


# ---- phase 6 --------------------------------------------------------------


def _fixed_batch(n_users: int, hist: int, num_items: int, seed: int,
                 long_user: int = 0):
    """n_users users of ``hist`` distinct items each; with ``long_user``
    the first user's history is that long instead."""
    from safer2_recommender_tpu import Dataset

    rng = np.random.default_rng(seed)
    lens = np.full(n_users, hist)
    if long_user:
        lens[0] = long_user
    items = np.concatenate([rng.choice(num_items, h, replace=False)
                            for h in lens]).astype(np.int32)
    users = np.repeat(np.arange(n_users, dtype=np.int32), lens)
    return Dataset(users, items)


def _check_topk(model, req, users, id_lists, k: int,
                rel_tol: float = 1e-3) -> None:
    """Each list in ``id_lists`` ([n, k] original item ids, rows aligned
    with ``users``) must be a top-k of the float64 rescoring of the
    model's own fold-in of ``req`` (the path ``model.recommend`` takes),
    history excluded, up to near-ties: every returned item scores at
    least the k-th best minus ``rel_tol`` times the row's largest
    |score|. Two f32 fold-in paths (the Server's fixed-width bucket and
    recommend's width buckets) legitimately swap items that tie that
    closely."""
    from safer2_recommender_tpu import Dataset, FoldInData
    from safer2_recommender_tpu.parallel.mesh import to_host

    empty = Dataset(np.zeros(0, np.int32), np.zeros(0, np.int32))
    fold = FoldInData.build(req, empty, num_items=model.num_items,
                            dim=model.cfg.dim)
    fold = model._permute_fold(fold, cache=False)
    ue = to_host(model._fold_in_jit(model.state, fold))[: users.size]
    v = to_host(model.state.item_emb).astype(np.float64)   # solver order
    perm = to_host(model._item_perm)                     # original->solver
    scores = ue.astype(np.float64) @ v.T
    row = np.searchsorted(users, np.asarray(req.user_ids))
    scores[row, perm[np.asarray(req.item_ids)]] = -np.inf
    kth = -np.partition(-scores, k - 1, axis=1)[:, k - 1]
    tol = rel_tol * np.max(np.abs(np.where(np.isfinite(scores), scores, 0)),
                           axis=1)
    for ids in id_lists:
        assert all(np.unique(r).size == k for r in ids), "duplicate ids"
        got = np.take_along_axis(scores, perm[ids], axis=1)
        assert (got >= (kth - tol)[:, None]).all(), (
            "returned items below the k-th best score beyond near-ties")


def phase_serving(model, ds, batch_sizes=(64, 1024), widths=(128, 512),
                  k: int = 100, sizes=(40, 700, 1024)) -> int:
    """Server: warm every rung, then serve fresh batches (bench.py's
    request generator) with zero recompiles, in-catalog ids that avoid
    each user's own history, and the ids ``model.recommend`` returns up
    to near-ties (``_check_topk``).

    Everything here, the Server's programs included, is compiled under
    ``jax.default_matmul_precision("highest")``: the two fold-in paths
    then differ only in f32 summation order, not in TF32 rounding of
    differently shaped products, and the comparison sees the serving
    logic."""
    import jax

    with jax.default_matmul_precision("highest"):
        return _serve_and_compare(model, ds, batch_sizes, widths, k, sizes)


def _serve_and_compare(model, ds, batch_sizes, widths, k, sizes) -> int:
    import jax
    from bench import _serve_batch

    from safer2_recommender_tpu.serving import Server

    srv = Server(model, k=k, batch_sizes=batch_sizes, widths=widths)
    t0 = time.perf_counter()
    for b in srv.batch_sizes:
        for w in srv.widths:
            # one user at the rung's full width, the rest short
            srv.recommend(_fixed_batch(b - 4, min(8, w), ds.num_items,
                                       seed=b + w, long_user=w))
    warm = srv.num_compiles
    assert warm == len(srv.batch_sizes) * len(srv.widths), warm
    say("serving", f"warm-up compiled {warm} programs in "
                   f"{time.perf_counter() - t0:.1f} s")
    reqs = [_serve_batch(ds, n, seed=500 + i) for i, n in enumerate(sizes)]

    def reference(req):
        # jax's config contexts are per thread: set the precision here too
        with jax.default_matmul_precision("highest"):
            return model.recommend(req, k=k, approx=False)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(reqs)) as pool:
        # the dynamic path compiles once per request shape; overlap them
        refs = list(pool.map(reference, reqs))
    say("serving", f"model.recommend references for {len(reqs)} batches "
                   f"in {time.perf_counter() - t0:.1f} s")
    same = total = 0
    for req, (ref_users, ref_ids) in zip(reqs, refs):
        t0 = time.perf_counter()
        users, ids = srv.recommend(req)
        ms = (time.perf_counter() - t0) * 1e3
        assert ids.shape == (users.size, k), ids.shape
        assert ((ids >= 0) & (ids < ds.num_items)).all(), "id outside catalog"
        own = np.zeros((users.size, ds.num_items), bool)
        own[np.searchsorted(users, np.asarray(req.user_ids)),
            np.asarray(req.item_ids)] = True
        assert not np.take_along_axis(own, ids, axis=1).any(), (
            "recommended an item from the user's own history")
        np.testing.assert_array_equal(users, ref_users)
        _check_topk(model, req, users, (ids, ref_ids), k)
        same += int((ids == ref_ids).sum())
        total += ids.size
        say("serving", f"batch of {users.size} users: {ms:.1f} ms; "
                       f"{(ids == ref_ids).mean():.4f} of ids equal "
                       "model.recommend's, the rest near-ties")
    assert srv.num_compiles == warm, (
        f"recompiled after warm-up: {warm} -> {srv.num_compiles}")
    say("serving", f"ok: {len(sizes)} batches, {srv.num_compiles} "
                   f"programs, no recompiles after warm-up; {same}/{total} "
                   "ids identical to model.recommend")
    return srv.num_compiles


# ---- four cards -------------------------------------------------------------


def gathered_square_batches(hlo_text: str, min_side: int):
    """Shapes of all-gather results in a compiled module that look like
    a batch of square systems ``[N, s, s]`` with ``s >= min_side``."""
    out = []
    for m in re.finditer(r"=\s+\w+\[(\d+),(\d+),(\d+)\][^ ]*\s+"
                         r"all-gather(?:-done)?\(", hlo_text):
        n, s1, s2 = (int(x) for x in m.groups())
        if s1 == s2 and s1 >= min_side:
            out.append((n, s1, s2))
    return out


def phase_four_cards(users: int = 50_000, items: int = 40_000,
                     dim: int = 512, fold_users: int = 5_000,
                     models=("safer2", "safer2pp"), n_cards: int = 4,
                     seed: int = 0) -> dict:
    """Data-parallel training on a 1-D mesh of ``n_cards`` devices
    against the same model with the same seed on one device: tables and
    losses after 2 epochs, and the sharded evaluate_dataset, agree; the
    compiled sharded epoch all-gathers no [N, d, d] solve batch.

    Both sides assemble in f32 at HIGHEST matmul precision, so the
    comparison sees the partitioning and not TF32/bf16 rounding of
    differently shaped products."""
    import jax

    from safer2_recommender_tpu import DeviceData, FoldInData, get_model
    from safer2_recommender_tpu.parallel import get_mesh

    devices = jax.devices()[:n_cards]
    assert len(devices) == n_cards, f"{len(devices)} devices"
    mesh = get_mesh(devices)
    ds, fold_tr, fold_te = workload(users, items, fold_users, seed)
    cfg = msd_config(dim).replace(compute_dtype="f32")
    placements = {
        "1": (None, DeviceData.build(ds, dim=dim),
              FoldInData.build(fold_tr, fold_te, num_items=ds.num_items,
                               dim=dim)),
        str(n_cards): (mesh, DeviceData.build(ds, dim=dim, mesh=mesh),
                       FoldInData.build(fold_tr, fold_te,
                                        num_items=ds.num_items, dim=dim,
                                        mesh=mesh)),
    }

    def run(job):
        name, label = job
        msh, dd, fold = placements[label]
        with jax.default_matmul_precision("highest"):
            m = get_model(name, cfg, ds.num_users, ds.num_items, mesh=msh)
            t0 = time.perf_counter()
            m.initialize(dd)
            m.train_epochs(dd, 1)
            _block(m.state)
            t_first = time.perf_counter() - t0
            m.train_epochs(dd, 1)
            _block(m.state)
            ev = m.evaluate_dataset(fold, k_list=(20,))
            hlo = None
            if msh is not None:
                # the program train_epochs ran (a persistent-cache hit)
                hlo = (m._epochs_scan_jit.lower(m.state, dd, 1)
                       .compile().as_text())
        return (m.export_state(dd), ev.mean_ndcg(), ev.mean_recall(),
                m.get_mean_weight(), t_first, hlo)

    jobs = [(name, label) for name in models for label in placements]
    t0 = time.perf_counter()
    # independent programs: overlap their compiles
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        res = dict(zip(jobs, pool.map(run, jobs)))
    say("four cards", f"{len(jobs)} runs (2 epochs + evaluation each) in "
                      f"{time.perf_counter() - t0:.1f} s, concurrent")
    out = {}
    for name in models:
        one, many = res[(name, "1")], res[(name, str(n_cards))]
        bad = gathered_square_batches(many[5], min_side=dim)
        assert not bad, f"{name}: solve batch all-gathered {bad}"
        for key in ("user_emb", "item_emb", "user_loss"):
            np.testing.assert_allclose(many[0][key], one[0][key],
                                       rtol=MESH_RTOL, atol=MESH_ATOL,
                                       err_msg=f"{name} {key}")
        np.testing.assert_allclose(many[1], one[1], rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(many[2], one[2], rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(many[3], one[3], rtol=MESH_RTOL)
        out[name] = float(np.max(np.abs(many[0]["user_emb"]
                                        - one[0]["user_emb"])))
        say("four cards", f"{name}: {n_cards}-card tables, losses, mean "
                          f"dual and evaluation match 1 card (max |du| "
                          f"{out[name]:.2e}; init + first epoch "
                          f"{one[4]:.1f} s on 1, {many[4]:.1f} s on "
                          f"{n_cards}); no solve batch all-gathered")
    return out


# ---- driver -----------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 4-card mesh check (needs 4 GPUs)")
    args = p.parse_args(argv)

    device, card = phase_device()
    from safer2_recommender_tpu.cli import enable_compilation_cache

    say("device", f"compilation cache: {enable_compilation_cache()}")
    t_start = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        for name, run in (("solver", phase_solver),
                          ("oracles", phase_oracles),
                          ("cli", phase_cli)):
            t0 = time.perf_counter()
            run()
            say(name, f"phase took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        model, ds = phase_full_width()
        say("full width", f"phase took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_serving(model, ds)
        say("serving", f"phase took {time.perf_counter() - t0:.1f} s")
    import jax

    say("done", f"{time.perf_counter() - t_start:.1f} s after the device "
                "phase")
    print(card, flush=True)
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

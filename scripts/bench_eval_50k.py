"""Evaluation engine at REFERENCE HELDOUT SCALE (VERDICT r4 missing #3).

The reference's MSD protocol evaluates 50,000 held-out users against a
~41k-item catalog (reference scripts/generate_data.py:164-226:
n_heldout_users=50000); every recorded eval number here previously used
the 1k-user ML-1M fold. This probe builds a synthetic 50k-heldout-user
fold at the MSD shape (power-law histories, 80/20 tr/te per user), runs
``evaluate_dataset`` at dim 256/512 on the default device, and reports
wall time + device memory stats.

Usage: python scripts/bench_eval_50k.py [dims...]   (default: 256 512)
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from safer2_recommender_tpu import (Config, Dataset, DeviceData,  # noqa: E402
                                    FoldInData, get_model)
from safer2_recommender_tpu.data.synth import powerlaw_dataset  # noqa: E402

N_HELDOUT, N_ITEMS = 50_000, 41_000
DIMS = [int(a) for a in sys.argv[1:]] or [256, 512]


def heldout_fold(num_items: int, dim: int) -> FoldInData:
    users, items = powerlaw_dataset(N_HELDOUT, num_items, seed=123)
    # per-user 80/20 split (the reference's split_train_test_proportion
    # shape; membership drawn uniformly — only the SIZES matter here)
    rng = np.random.default_rng(5)
    te_mask = rng.random(users.size) < 0.2
    tr = Dataset(users[~te_mask], items[~te_mask])
    te = Dataset(users[te_mask], items[te_mask])
    print(f"fold: {N_HELDOUT} heldout users, {tr.nnz} tr / {te.nnz} te "
          f"tuples, catalog {num_items}")
    return FoldInData.build(tr, te, num_items=num_items, dim=dim)


def mem_stats():
    import jax

    try:
        s = jax.local_devices()[0].memory_stats() or {}
        return {k: s.get(k) for k in ("bytes_in_use", "peak_bytes_in_use")}
    except Exception:
        return {}


def main():
    from safer2_recommender_tpu.cli import enable_compilation_cache

    enable_compilation_cache()
    # model tables at MSD scale (571k users x dim) so the fold-in
    # solves run against realistically-sized frozen item tables
    train_u, train_i = powerlaw_dataset(50_000, N_ITEMS, seed=0)
    train = Dataset(train_u, train_i)
    for dim in DIMS:
        dd = DeviceData.build(train, dim=dim)
        fold = heldout_fold(N_ITEMS, dim)
        cfg = Config(dim=dim, uobs_weight=0.0004, l2_reg=0.0012,
                     alpha=0.3, bandwidth=0.1)
        m = get_model("safer2", cfg, train.num_users, train.num_items)
        m.initialize(dd)
        m.train_epochs(dd, 1)

        def once():
            t0 = time.perf_counter()
            res = m.evaluate_dataset(fold)
            dt = time.perf_counter() - t0
            return dt, res

        once()                          # compile
        best, res = min((once() for _ in range(3)), key=lambda x: x[0])
        print(f"dim {dim}: evaluate_dataset(50k heldout) = "
              f"{best * 1000:.0f} ms  (NDCG@20 {res.ndcg.mean(0)[2]:.4f} "
              f"over {res.ndcg.shape[0]} users)  mem={mem_stats()}")
        del m, dd, fold


if __name__ == "__main__":
    main()

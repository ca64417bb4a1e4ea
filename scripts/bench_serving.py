"""Serving throughput: recommend() users/s at catalog scale.

The reference can only *score* held-out users inside its evaluation
loop; `Recommender.recommend` is this framework's serving surface
(fold-in from raw interaction histories + full-catalog scoring +
history-masked top-k + solver-order id decode). This measures
end-to-end serving throughput for batches of NEW users against an
MSD-scale catalog on one chip — the number a deployment plans capacity
with.

Usage: python scripts/bench_serving.py [model] [dim] [batch_users]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

MODEL = sys.argv[1] if len(sys.argv) > 1 else "safer2"
DIM = int(sys.argv[2]) if len(sys.argv) > 2 else 512
BATCH = int(sys.argv[3]) if len(sys.argv) > 3 else 8192


def main():
    import jax

    from safer2_recommender_tpu import (Config, Dataset, DeviceData,
                                        FoldInData, get_model)
    from safer2_recommender_tpu.cli import enable_compilation_cache
    from safer2_recommender_tpu.data.synth import powerlaw_dataset

    enable_compilation_cache()
    users, items = powerlaw_dataset(50_000, 40_000, seed=0)
    ds = Dataset(users, items)
    dd = DeviceData.build(ds, dim=DIM)
    cfg = Config(dim=DIM, uobs_weight=0.0004, l2_reg=0.0012, alpha=0.3,
                 bandwidth=0.1, use_snr=True, sampling_ratio=0.1,
                 block_size=64)
    model = get_model(MODEL, cfg, ds.num_users, ds.num_items)
    model.initialize(dd)
    model.train_epochs(dd, 1)
    jax.block_until_ready(model.state)

    # fresh serving users: power-law histories over the trained catalog
    rng = np.random.default_rng(7)
    hist_len = np.clip(rng.lognormal(np.log(20), 0.8, BATCH), 3,
                       500).astype(np.int64)
    pop = 1.0 / (np.arange(1, ds.num_items + 1) ** 0.8)
    pop /= pop.sum()
    su = np.repeat(np.arange(BATCH, dtype=np.int32), hist_len)
    si = rng.choice(ds.num_items, size=int(hist_len.sum()),
                    p=pop).astype(np.int32)
    serve = Dataset(su, si)

    def once(approx):
        t0 = time.perf_counter()
        u, ids = model.recommend(serve, k=100, approx=approx)
        # to_host inside recommend is the true barrier
        assert ids.shape == (BATCH, 100)
        return time.perf_counter() - t0

    for approx in (False, True):
        once(approx)            # compile
        best = min(once(approx) for _ in range(3))
        label = "approx" if approx else "exact"
        print(f"{MODEL} dim={DIM} [{label}]: recommend({BATCH} new "
              f"users, k=100, catalog={ds.num_items}) = {best*1e3:.0f} "
              f"ms -> {BATCH/best:,.0f} users/s/chip (incl. fold-in + "
              f"top-k + id decode + host transfer)")


if __name__ == "__main__":
    main()

"""Synthetic MSD-scale smoke benchmark: SAFER2 dim=512 on one device.

Generates a power-law implicit-feedback dataset approximating MSD's shape
(configurable), builds the chunked device layout, and measures
steady-state epoch time + users/s/chip. Zero-egress environments cannot
download MSD itself; this proves the memory plan and measures the
device-rate at the north-star dimension.

Usage: python scripts/bench_scale.py [num_users] [num_items] [dim] [model]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

NUM_USERS = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
NUM_ITEMS = int(sys.argv[2]) if len(sys.argv) > 2 else 40_000
DIM = int(sys.argv[3]) if len(sys.argv) > 3 else 512
MODEL = sys.argv[4] if len(sys.argv) > 4 else "safer2"
MEAN_HIST = 40


def synth(num_users, num_items, mean_hist, seed=0):
    rng = np.random.default_rng(seed)
    # log-normal history sizes (5..capped), zipf-ish item popularity
    hist = np.clip(rng.lognormal(np.log(mean_hist * 0.6), 0.9,
                                 num_users).astype(np.int64), 5, 3000)
    total = int(hist.sum())
    pop = 1.0 / (np.arange(1, num_items + 1) ** 0.8)
    pop /= pop.sum()
    users = np.repeat(np.arange(num_users, dtype=np.int32),
                      hist).astype(np.int32)
    items = rng.choice(num_items, size=total, p=pop).astype(np.int32)
    return users, items


def main():
    import jax
    import jax.numpy as jnp

    from safer2_recommender_tpu import Config, Dataset, DeviceData, get_model
    from safer2_recommender_tpu.cli import enable_compilation_cache

    enable_compilation_cache()

    users, items = synth(NUM_USERS, NUM_ITEMS, MEAN_HIST)
    ds = Dataset(users, items)
    t0 = time.perf_counter()
    dd = DeviceData.build(ds, dim=DIM)
    print(f"layout: {time.perf_counter()-t0:.1f}s, "
          f"by_user buckets={len(dd.by_user)} by_item={len(dd.by_item)}",
          flush=True)

    cfg = Config(dim=DIM, uobs_weight=0.0004, l2_reg=0.0012, alpha=0.3,
                 bandwidth=0.1, use_snr=True, sampling_ratio=0.1,
                 xi_iterations=5, pd_iterations=1)
    model = get_model(MODEL, cfg, ds.num_users, ds.num_items)
    t0 = time.perf_counter()
    model.initialize(dd)
    model.train_epochs(dd, 1)
    float(jnp.sum(model.state.user_loss))
    print(f"compile+first epoch: {time.perf_counter()-t0:.0f}s", flush=True)

    def run(k):
        t0 = time.perf_counter()
        model.train_epochs(dd, k)
        float(jnp.sum(model.state.user_loss))
        return time.perf_counter() - t0

    t1 = min(run(1) for _ in range(2))
    t3 = min(run(3) for _ in range(2))
    epoch_s = (t3 - t1) / 2
    print(f"epoch: {epoch_s*1e3:.0f} ms  "
          f"users/s/chip: {NUM_USERS/epoch_s:,.0f}  "
          f"mean_dual={float(jnp.mean(model.state.dual_weight)):.3f}  "
          f"loss_finite={bool(jnp.isfinite(model.state.user_loss).all())}")


if __name__ == "__main__":
    main()

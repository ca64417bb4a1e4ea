"""Multi-device scaling harness: epoch time vs mesh size.

Runs the flagship SAFER2 epoch on the bundled ML-1M split over 1, 2,
4, ... N-device meshes (bucket rows sharded over the "data" axis,
tables replicated, Gramians all-reduced by XLA) and reports the epoch
time and scaling relative to the 1-device run. Each time is the host
clock around ``train_epochs`` plus ``jax.block_until_ready``.

On the CPU backend (virtual devices,
``XLA_FLAGS=--xla_force_host_platform_device_count=8``) the numbers
validate function, not scaling.

Usage: python scripts/bench_multichip.py [dim] [epochs_per_measure]
"""
import os
import sys
import time

DIM = int(sys.argv[1]) if len(sys.argv) > 1 else 32
K = int(sys.argv[2]) if len(sys.argv) > 2 else 5
ML1M = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "tests", "ml-1m")


def main():
    import jax

    from safer2_recommender_tpu import Config, Dataset, DeviceData, get_model
    from safer2_recommender_tpu.parallel import get_mesh

    train = Dataset.from_csv(f"{ML1M}/train.csv")
    cfg = Config(dim=DIM, uobs_weight=0.004, l2_reg=0.004, alpha=0.3,
                 bandwidth=0.15, xi_iterations=5, pd_iterations=1)

    if jax.default_backend() == "cpu":
        print("WARNING: CPU backend — virtual devices share one core; "
              "numbers below validate function, not scaling.")

    n_dev = jax.device_count()
    sizes = []
    s = 1
    while s <= n_dev:
        sizes.append(s)
        s *= 2

    base = None
    for n in sizes:
        mesh = get_mesh(jax.devices()[:n]) if n > 1 else None
        dd = DeviceData.build(train, mesh=mesh, dim=DIM)
        model = get_model("safer2", cfg, train.num_users, train.num_items,
                          mesh=mesh)
        model.initialize(dd)

        def run(k):
            t0 = time.perf_counter()
            model.train_epochs(dd, k)
            jax.block_until_ready(model.state)
            return time.perf_counter() - t0

        run(K)                               # compile
        epoch_s = min(run(K) for _ in range(2)) / K
        if base is None:
            base = epoch_s
        eff = base / (epoch_s * n)
        print(f"devices={n:3d}  epoch={epoch_s*1e3:8.1f} ms  "
              f"speedup={base/epoch_s:5.2f}x  efficiency={eff*100:5.1f}%")


if __name__ == "__main__":
    main()

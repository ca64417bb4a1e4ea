"""Benchmark harness (needs a GPU). Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Primary metric: SAFER2 at dim=512 on an
MSD-shaped synthetic workload (50k users / 40k items / ~1.65M tuples,
power-law popularity — MSD itself is not downloadable here; the README's
MSD config is dim=512, uobs=0.0004, l2=0.0012, bandwidth=0.1, use_snr),
measuring steady-state epoch time and users/s/chip. ``vs_baseline``
compares against an IDEAL 64-core run of the C++ reference on the SAME
workload: the measured single-core epoch time recorded in BASELINE.md
(line ``measured_cpp_synth50k_dim512_epoch_s: N``) divided by 64 — i.e.
assuming perfect reference scaling, so the number is conservative.

The same JSON object also carries the round-1 metric (SAFER2, bundled
ML-1M split, README dim=32 config) as ``ml1m_dim32_users_per_s_chip`` /
``ml1m_dim32_vs_cpp_1core`` so the small-dim dispatch-bound regime stays
tracked round over round.

Every epoch time is the host clock around ``train_epochs`` plus
``jax.block_until_ready`` on the state. The JSON names the device (JAX's
platform, device kind and count) and the card's name and power limit as
``nvidia-smi`` reports them.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ML1M_DIR = os.environ.get("FRECSYS_ML1M_DIR",
                          os.path.join(REPO, "tests", "ml-1m"))

# North-star workload (matches BASELINE.md's measured table row and the
# head-to-head CSV fed to the C++ reference).
NS_USERS, NS_ITEMS, NS_DIM, NS_SEED = 50_000, 40_000, 512, 0


def read_baseline(key: str) -> float:
    path = os.path.join(REPO, "BASELINE.md")
    if os.path.exists(path):
        m = re.search(key + r":\s*([0-9.]+)", open(path).read())
        if m:
            return float(m.group(1))
    return 0.0


def time_epochs(model, dd, bench_epochs: int, reps: int) -> float:
    """Steady-state seconds per epoch: the best of ``reps`` timed chains
    of ``bench_epochs`` epochs (one dispatch each), after a warm-up
    chain of the same length compiles the program."""
    import jax

    def run() -> float:
        t0 = time.perf_counter()
        model.train_epochs(dd, bench_epochs)
        jax.block_until_ready(model.state)
        return time.perf_counter() - t0

    run()
    return min(run() for _ in range(reps)) / bench_epochs


def bench_northstar():
    """dim=512 on the MSD-shaped 50k-user synthetic workload: ALL SIX
    models (VERDICT r3 item 6) — the exact SAFER2 north-star, the
    blockwise engines (safer2pp/ialspp, block 64), and the baselines
    (ials, erm_mf, cvar_mf) so any solver-path regression shows in the
    round artifact."""
    from safer2_recommender_tpu import Config, Dataset, DeviceData, get_model
    from safer2_recommender_tpu.data.synth import powerlaw_dataset

    users, items = powerlaw_dataset(NS_USERS, NS_ITEMS, seed=NS_SEED)
    ds = Dataset(users, items)
    dim = NS_DIM
    dd = DeviceData.build(ds, dim=dim)
    cfg = Config(dim=dim, uobs_weight=0.0004, l2_reg=0.0012, alpha=0.3,
                 bandwidth=0.1, use_snr=True, sampling_ratio=0.1,
                 xi_iterations=5, pd_iterations=1, block_size=64,
                 stepsize=0.1)
    n_users = None
    out = {}
    serve_rate, serve_fixed = None, {}
    for name in ("safer2", "safer2pp", "ialspp", "ials", "erm_mf",
                 "cvar_mf"):
        model = get_model(name, cfg, ds.num_users, ds.num_items)
        model.initialize(dd)
        model.train_epochs(dd, 1)
        out[name] = time_epochs(model, dd, bench_epochs=4, reps=2)
        if n_users is None:
            n_users = int((dd.user_hist_size > 0).sum())
        if name == "safer2":
            serve_rate = bench_serving(model, ds)
            serve_fixed = bench_serving_fixed(model, ds)
        del model
    return out, n_users, dim, serve_rate, serve_fixed


def _serve_batch(ds, batch: int, seed: int):
    """One request batch of brand-new users with power-law histories."""
    import numpy as np

    from safer2_recommender_tpu import Dataset

    rng = np.random.default_rng(seed)
    hl = np.clip(rng.lognormal(np.log(20), 0.8, batch), 3,
                 500).astype(np.int64)
    pop = 1.0 / (np.arange(1, ds.num_items + 1) ** 0.8)
    pop /= pop.sum()
    su = np.repeat(np.arange(batch, dtype=np.int32), hl)
    si = rng.choice(ds.num_items, size=int(hl.sum()),
                    p=pop).astype(np.int32)
    return Dataset(su, si)


def bench_serving(model, ds, batch: int = 4096) -> float:
    """End-to-end recommend() users/s for a batch of new users against
    the north-star catalog (fold-in + scoring + exact top-k + id
    decode + host transfer) — the serving surface BASELINE.md records."""
    serve = _serve_batch(ds, batch, seed=7)

    def once():
        t0 = time.perf_counter()
        model.recommend(serve, k=100)
        return time.perf_counter() - t0

    once()
    return batch / min(once() for _ in range(3))


def bench_serving_fixed(model, ds) -> dict:
    """The compile-once Server (serving.py) under PRODUCTION conditions:
    steady-state throughput over VARYING request batches (different
    sizes and history draws every call — the case the dynamic path
    recompiles on), asserting zero recompiles after warmup, plus
    small-batch p50 latency (VERDICT r4 next-round #2)."""
    import numpy as np

    from safer2_recommender_tpu.serving import Server

    srv = Server(model, k=100, batch_sizes=(64, 1024, 4096),
                 widths=(128, 512))
    # warmup: touch every rung the measured traffic will use
    for b in (48, 900, 4096, 2500):
        srv.recommend(_serve_batch(ds, b, seed=100 + b))
    warm_compiles = srv.num_compiles

    sizes = [int(s) for s in
             np.random.default_rng(11).integers(256, 4096, 16)]
    batches = [_serve_batch(ds, b, seed=200 + i)
               for i, b in enumerate(sizes)]
    t0 = time.perf_counter()
    served = sum(u.size for u, _ in srv.recommend_stream(batches))
    varying_rate = served / (time.perf_counter() - t0)
    assert srv.num_compiles == warm_compiles, (
        f"serving recompiled: {warm_compiles} -> {srv.num_compiles}")

    small = [_serve_batch(ds, 64, seed=400 + i) for i in range(8)]
    lat = []
    for _ in range(6):
        for b in small:
            t0 = time.perf_counter()
            srv.recommend(b)
            lat.append(time.perf_counter() - t0)
    p50_ms = float(np.median(lat) * 1000)
    return {"serving_varying_users_per_s_chip": varying_rate,
            "serving_p50_ms_batch64": p50_ms,
            "serving_compiled_programs": srv.num_compiles}


def bench_ml1m():
    """SAFER2, bundled ML-1M split, README dim=32 config (round-1 metric)
    plus a mechanically-checked QUALITY number: fixed-seed 10-epoch
    NDCG@20 on the bundled validation fold (VERDICT r4 next-round #5 —
    quality drift shows up in the regressions field, not just in manual
    head-to-heads)."""
    from safer2_recommender_tpu import (Config, Dataset, DeviceData,
                                        FoldInData, get_model)

    train = Dataset.from_csv(os.path.join(ML1M_DIR, "train.csv"))
    dd = DeviceData.build(train, dim=32)
    cfg = Config(dim=32, uobs_weight=0.004, l2_reg=0.004, alpha=0.3,
                 bandwidth=0.15, xi_iterations=5, pd_iterations=1,
                 stdev=0.1, seed=0)
    model = get_model("safer2", cfg, train.num_users, train.num_items)
    model.initialize(dd)
    model.train_epochs(dd, 1)
    # 20-epoch chains: a dim-32 epoch is short next to one dispatch
    epoch_s = time_epochs(model, dd, bench_epochs=20, reps=2)
    n_users = int((dd.user_hist_size > 0).sum())

    ndcg20 = None
    vtr = os.path.join(ML1M_DIR, "validation_tr.csv")
    if os.path.exists(vtr) or os.path.exists(vtr + ".gz"):
        fold = FoldInData.build(Dataset.from_csv(vtr),
                                Dataset.from_csv(os.path.join(
                                    ML1M_DIR, "validation_te.csv")),
                                num_items=train.num_items)
        m2 = get_model("safer2", cfg, train.num_users, train.num_items)
        m2.initialize(dd)
        m2.train_epochs(dd, 10)
        res = m2.evaluate_dataset(fold, k_list=(20,))
        ndcg20 = float(res.ndcg.mean(0)[0])
    return epoch_s, n_users / epoch_s, ndcg20


def main() -> int:
    import jax

    from safer2_recommender_tpu.cli import enable_compilation_cache
    from safer2_recommender_tpu.utils.device import (
        card_name_and_power_limit,
        require_gpu,
    )

    device = require_gpu()
    card = card_name_and_power_limit()
    enable_compilation_cache()

    ns_times, ns_users, ns_dim, serve_rate, serve_fixed = bench_northstar()
    ns_epoch_s = ns_times["safer2"]
    ns_rate = ns_users / ns_epoch_s
    ml_epoch_s, ml_rate, ml_ndcg20 = bench_ml1m()

    cpp_1core_s = read_baseline("measured_cpp_synth50k_dim512_epoch_s")
    vs_ideal_64core = (cpp_1core_s / 64.0) / ns_epoch_s if (
        cpp_1core_s and ns_dim == NS_DIM) else 0.0
    ml_base_ms = read_baseline("measured_cpp_ml1m_safer2_epoch_ms")
    ml_vs = (ml_base_ms / 1000.0) / ml_epoch_s if ml_base_ms else 0.0

    print(json.dumps({
        "metric": "safer2_dim512_msd50k_users_per_s_per_chip",
        "value": ns_rate,
        "unit": "users/s/chip",
        # vs an IDEAL (perfectly scaling) 64-core run of the reference's
        # measured single-core time on the same workload
        "vs_baseline": vs_ideal_64core,
        "epoch_ms": ns_epoch_s * 1000,
        # the other five models on the SAME workload/dim
        **{f"{name}_dim512_epoch_ms": ns_times[name] * 1000
           for name in ("safer2pp", "ialspp", "ials", "erm_mf",
                        "cvar_mf")},
        "serving_users_per_s_chip": serve_rate,
        # compile-once Server: varying-batch steady state + p50 latency
        **serve_fixed,
        "ml1m_dim32_users_per_s_chip": ml_rate,
        "ml1m_safer2_dim32_ndcg20_10ep": ml_ndcg20,
        "ml1m_dim32_vs_cpp_1core": ml_vs,
        "ml1m_dim32_epoch_ms": ml_epoch_s * 1000,
        "dim": ns_dim,
        "platform": device["platform"],
        "device_kind": device["kind"],
        "device_count": device["count"],
        "card": card,
        "jax_version": jax.__version__,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

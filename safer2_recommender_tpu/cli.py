"""CLI driver — the equivalent of the reference's ``run_model`` binary
(reference tools/run_model.cc:125-274), flag-for-flag:

    python -m safer2_recommender_tpu.cli \
        --model_name safer2 --train_data ml-1m/train.csv \
        --test_train_data ml-1m/validation_tr.csv \
        --test_test_data ml-1m/validation_te.csv \
        --dim 32 --uobs_weight 0.004 --l2_reg 0.004 --alpha 0.3 \
        --bandwidth 0.15 --epoch 50

Additions over the reference: --mesh (shard over N devices), --seed
(reproducible runs), --checkpoint_dir (save/restore, a capability the
reference lacks entirely — SURVEY.md section 5).
"""

from __future__ import annotations

import argparse
import sys

from safer2_recommender_tpu.config import Config
from safer2_recommender_tpu.evaluation.metrics import (
    DEFAULT_ALPHA_LIST,
    DEFAULT_K_LIST,
)
from safer2_recommender_tpu.utils.logging import Timer, setup

MODEL_CHOICES = ("ials", "ialspp", "safer2", "safer2pp", "cvar_mf",
                 "erm_mf")


def _existing_file(path: str) -> str:
    """Path validation (reference CLI::ExistingFile, run_model.cc:218).
    ``foo.csv`` with only ``foo.csv.gz`` present passes — Dataset.from_csv
    reads the gzipped twin (the in-repo ML-1M fixture ships gzipped)."""
    import os

    if not os.path.isfile(path) and not os.path.isfile(path + ".gz"):
        raise argparse.ArgumentTypeError(f"File does not exist: {path}")
    return path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="safer2_recommender_tpu",
        description="frecsys experimentation utility on JAX")
    # reference flags (run_model.cc:129-231)
    p.add_argument("-n", "--model_name", required=True,
                   type=str.lower, choices=MODEL_CHOICES)
    p.add_argument("--train_data", required=True, type=_existing_file)
    p.add_argument("--test_train_data", required=True, type=_existing_file)
    p.add_argument("--test_test_data", required=True, type=_existing_file)
    p.add_argument("-d", "--dim", type=int, default=8)
    p.add_argument("--uobs_weight", type=float, default=0.1)
    p.add_argument("-r", "--l2_reg", type=float, default=0.002)
    p.add_argument("--l2_reg_exp", type=float, default=1.0)
    p.add_argument("-s", "--stdev", type=float, default=0.1)
    p.add_argument("-e", "--epoch", type=int, default=50)
    p.add_argument("--block_size", type=int, default=64)
    p.add_argument("--alpha", type=float, default=0.3)
    p.add_argument("--bandwidth", type=float, default=1.0)
    p.add_argument("--stepsize", type=float, default=0.1)
    p.add_argument("--xi_iterations", type=int, default=5)
    p.add_argument("--pd_iterations", type=int, default=1)
    p.add_argument("--sampling_ratio", type=float, default=0.1)
    p.add_argument("--use_epanechnikov", type=int, default=0)
    p.add_argument("--use_snr", type=int, default=0)
    p.add_argument("--use_cg", type=int, default=0)
    p.add_argument("--cg_error_tolerance", type=float, default=1e-10)
    p.add_argument("--cg_max_iterations", type=int, default=100)
    p.add_argument("--print_train_stats", type=int, default=1)
    p.add_argument("--print_evaluation_stats", type=int, default=0)
    # accepted-but-unused, matching the reference exactly: its CLI11
    # option binds no variable (run_model.cc:155) and nothing reads it
    p.add_argument("--print_test_results", type=int, default=0)
    p.add_argument("--print_residual_stats", type=int, default=0)
    p.add_argument("--print_var_stats", type=int, default=0)
    # additions over the reference
    p.add_argument("--distributed", type=int, default=0,
                   help="call jax.distributed.initialize() for multi-host "
                        "runs (the coordinator and process ids come from "
                        "the environment JAX reads, e.g. a cluster "
                        "launcher); combine with --mesh 0 to span all "
                        "global devices")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard over this many devices (0 = single device)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eig_refresh_tol", type=float, default=8e-2,
                   help="warm-started Woodbury eigh refresh tolerance "
                        "(0 = always full eigh)")
    p.add_argument("--block_interleaved", type=int, default=0,
                   help="++ models: reference-order per-block U/V "
                        "interleaving with live Gramians "
                        "(ialspp.h:208-261, safer2pp.h:303-319) instead "
                        "of the faster phase-separated frozen sweep; "
                        "needs dim %% block_size == 0")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--profile_dir", default=None,
                   help="write a jax.profiler device trace of the "
                        "training loop to this directory (the reference "
                        "only has wall-clock timers, run_model.cc:258-266)")
    p.add_argument("--epochs_per_dispatch", type=int, default=1,
                   help="chain this many epochs on-device per dispatch "
                        "(lax.scan); >1 disables per-epoch stats lines "
                        "but removes the per-call host round trip")
    p.add_argument("--compute_dtype", choices=("auto", "f32", "bf16"),
                   default="auto",
                   help="normal-equation assembly input dtype: 'bf16' "
                        "gathers and multiplies history slabs in bf16 "
                        "with f32 accumulation; 'auto' and 'f32' keep "
                        "f32")
    return p


def compilation_cache_dir() -> str:
    """Where the persistent compilation cache lives:
    ``JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache/`` at the
    root of the checkout (a fixed path, so a later run in the same
    checkout finds what an earlier one compiled)."""
    import os

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    pkg = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache (dim-512 programs take
    minutes to compile cold) in ``compilation_cache_dir()``; returns
    the directory. With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already
    reads it and no other directory is set here."""
    import os

    import jax

    path = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    log = setup()

    import jax

    if args.distributed:
        # Must run before first backend use; the coordinator address and
        # process ids come from the environment JAX's cluster detection
        # reads. A host embedding this CLI (tests/distributed_worker.py)
        # may have initialized the runtime already — that's fine.
        import jax._src.distributed as _dist

        if _dist.global_state.client is None:
            jax.distributed.initialize()
        log.info("distributed: process %d/%d, %d global devices",
                 jax.process_index(), jax.process_count(),
                 len(jax.devices()))

    enable_compilation_cache()

    from safer2_recommender_tpu.data.dataset import (
        Dataset,
        DeviceData,
        FoldInData,
    )
    from safer2_recommender_tpu.models import get_model
    from safer2_recommender_tpu.parallel import get_mesh

    cfg = Config(
        dim=args.dim, uobs_weight=args.uobs_weight, l2_reg=args.l2_reg,
        l2_reg_exp=args.l2_reg_exp, stdev=args.stdev,
        block_size=args.block_size, alpha=args.alpha,
        bandwidth=args.bandwidth, stepsize=args.stepsize,
        xi_iterations=args.xi_iterations,
        sampling_ratio=args.sampling_ratio,
        pd_iterations=args.pd_iterations,
        use_epanechnikov=bool(args.use_epanechnikov),
        use_snr=bool(args.use_snr), use_cg=bool(args.use_cg),
        cg_error_tolerance=args.cg_error_tolerance,
        cg_max_iterations=args.cg_max_iterations,
        eig_refresh_tol=args.eig_refresh_tol,
        compute_dtype=args.compute_dtype,
        block_interleaved=bool(args.block_interleaved),
        epochs=args.epoch, seed=args.seed,
    )

    mesh = None
    if args.mesh:
        if args.mesh > len(jax.devices()):
            raise SystemExit(
                f"--mesh {args.mesh} exceeds the {len(jax.devices())} "
                "available devices")
        mesh = get_mesh(jax.devices()[: args.mesh])
    elif args.distributed:
        mesh = get_mesh()          # all global devices across hosts

    train = Dataset.from_csv(args.train_data)
    test_tr = Dataset.from_csv(args.test_train_data)
    test_te = Dataset.from_csv(args.test_test_data)
    for name, ds in (("--test_train_data", test_tr),
                     ("--test_test_data", test_te)):
        # an out-of-range item id would silently clamp in the device
        # gather (wrong embedding) or collide with the padding sentinel
        if ds.item_ids.size and int(ds.item_ids.max()) >= train.num_items:
            raise SystemExit(
                f"{name} contains item id {int(ds.item_ids.max())} "
                f">= the training catalog size {train.num_items}")

    dd = DeviceData.build(train, mesh=mesh, dim=args.dim)
    fold = FoldInData.build(test_tr, test_te, num_items=train.num_items,
                            mesh=mesh, dim=args.dim)

    model = get_model(args.model_name, cfg, train.num_users,
                      train.num_items, mesh=mesh)
    model.set_print_train_stats(bool(args.print_train_stats))
    model.set_print_residual_stats(bool(args.print_residual_stats))
    model.set_print_var_stats(bool(args.print_var_stats))

    ckpt, restored, start_epoch = None, None, 0
    if args.checkpoint_dir:
        from safer2_recommender_tpu.checkpoint import CheckpointManager

        ckpt = CheckpointManager(args.checkpoint_dir)
        restored, start_epoch, meta = ckpt.restore_with_meta(model.state)
    if restored is not None:
        model.state = restored
        model.load_checkpoint_meta(meta)
        log.info("Restored checkpoint at epoch %d", start_epoch)
    else:
        # the SAFER-family warm start is a full-dataset device pass —
        # skip it when a checkpoint overwrites the state anyway
        model.initialize(dd)

    def evaluate(epoch: int) -> None:
        metrics = model.evaluate_dataset(fold, DEFAULT_K_LIST,
                                         DEFAULT_ALPHA_LIST)
        log.info("Epoch %d:", epoch)
        metrics.show()

    import contextlib

    prof = (jax.profiler.trace(args.profile_dir) if args.profile_dir
            else contextlib.nullcontext())
    step = max(1, args.epochs_per_dispatch)
    last_saved = start_epoch
    with prof:
        epoch = start_epoch
        while epoch < cfg.epochs:
            n = min(step, cfg.epochs - epoch)
            if ckpt is not None and args.checkpoint_every:
                # land a dispatch boundary on every checkpoint multiple
                # (a chained dispatch cannot stop mid-scan to save)
                k = args.checkpoint_every
                n = min(n, k - epoch % k)
            with Timer() as t:
                if n == 1:
                    model.train_epoch(dd)
                else:
                    model.train_epochs(dd, n)
                    # chained dispatch is async — the Timer must cover
                    # the device work, not the enqueue
                    jax.block_until_ready(model.state)
            log.info("Epoch: %d, Timer: Train=%d", epoch + n - 1,
                     t.ms // n)
            if args.print_evaluation_stats:
                evaluate(epoch + n - 1)
            if ckpt is not None and args.checkpoint_every and (
                    (epoch + n) % args.checkpoint_every == 0):
                ckpt.save(model.state, epoch + n,
                          meta=model.checkpoint_meta())
                last_saved = epoch + n
            epoch += n

    # persist the final state: --checkpoint_every may not divide
    # --epoch (or may be unset while --checkpoint_dir is given)
    if ckpt is not None and cfg.epochs > start_epoch and (
            last_saved != cfg.epochs):
        ckpt.save(model.state, cfg.epochs, meta=model.checkpoint_meta())

    log.info("Validation Results")
    evaluate(cfg.epochs)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Worker process for the REAL 2-process ``jax.distributed`` test.

Launched by tests/test_distributed.py as::

    python tests/distributed_worker.py <coordinator> <num_procs> <proc_id> \
        <devices_per_proc> <out_npz> [--cli <data_dir>]

Each process initializes the JAX distributed runtime (gloo collectives on
the CPU backend), builds the GLOBAL mesh over all processes' devices,
loads the same dataset on every host (the framework's multi-host
contract: every host parses the full CSV — parallel/mesh.py::put), runs
one SAFER2 epoch through the real sharded path, and writes the
replicated result tables from process 0. With ``--cli`` it instead
drives the full ``--distributed`` CLI entry point end-to-end.

This is the multi-process execution the reference never had (its
parallelism is pthread-only, SURVEY.md section 2 P7); the mocked
``put`` signature test this replaces pinned the call, not the behavior.
"""

import os
import sys

# Order matters: XLA_FLAGS before jax import; platform + distributed
# init before first backend use.
DEV_PER_PROC = int(sys.argv[4])
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={DEV_PER_PROC}")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

COORD, NUM_PROCS, PROC_ID = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
OUT = sys.argv[5]


def make_tiny():
    """Same deterministic dataset as tests/conftest.py::tiny."""
    from safer2_recommender_tpu import Dataset

    rng = np.random.default_rng(42)
    n, num_u, num_i = 4000, 150, 80
    u = rng.integers(0, num_u, n).astype(np.int32)
    i = rng.integers(0, num_i, n).astype(np.int32)
    pairs = np.unique(np.stack([u, i], 1), axis=0)
    return Dataset(pairs[:, 0], pairs[:, 1])


def main() -> int:
    jax.distributed.initialize(coordinator_address=COORD,
                               num_processes=NUM_PROCS,
                               process_id=PROC_ID)
    assert jax.process_count() == NUM_PROCS
    assert len(jax.devices()) == NUM_PROCS * DEV_PER_PROC

    if "--cli" in sys.argv:
        return run_cli(sys.argv[sys.argv.index("--cli") + 1])

    from jax.sharding import NamedSharding, PartitionSpec as P

    from safer2_recommender_tpu import Config, DeviceData, get_model
    from safer2_recommender_tpu.parallel import get_mesh

    ds = make_tiny()
    mesh = get_mesh()                      # all global devices
    # exercises parallel/mesh.py::put's REAL multi-process branch
    # (make_array_from_process_local_data with global_shape)
    dd = DeviceData.build(ds, mesh=mesh)
    m = get_model("safer2", Config(dim=8), ds.num_users, ds.num_items,
                  mesh=mesh)
    m.initialize(dd)
    m.train_epoch(dd)

    # Replicate outputs so every process holds the full arrays.
    rep = jax.jit(lambda s: (s.user_emb, s.user_loss),
                  out_shardings=NamedSharding(mesh, P()))
    ue, ul = rep(m.state)
    if PROC_ID == 0:
        np.savez(OUT, user_emb=np.asarray(ue), user_loss=np.asarray(ul))
    # every process must reach the end together (collectives)
    jax.effects_barrier()
    return 0


def run_cli(data_dir: str) -> int:
    """Drive the real `--distributed` CLI path end-to-end."""
    from safer2_recommender_tpu import cli

    argv = [
        "--model_name", "safer2", "--dim", "8", "--epoch", "2",
        "--bandwidth", "0.3", "--print_train_stats", "0",
        "--print_evaluation_stats", "1", "--compute_dtype", "f32",
        "--distributed", "1",
        "--train_data", os.path.join(data_dir, "train.csv"),
        "--test_train_data", os.path.join(data_dir, "tr.csv"),
        "--test_test_data", os.path.join(data_dir, "te.csv"),
    ]
    rc = cli.main(argv)
    if PROC_ID == 0:
        np.savez(OUT, rc=np.int32(rc))
    return rc


if __name__ == "__main__":
    sys.exit(main())

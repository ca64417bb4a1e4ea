"""Time each ``spd_solve`` implementation at the sweeps' solve shapes.

For every (N, d) below, each path in ``block_chol.SOLVERS`` is jitted on
its own, compiled, checked against a float64 numpy solve, and timed with
the host clock around ``block_until_ready`` (median of ``REPS`` calls).
Prints one JSON line per (path, shape) and names the path that
``solver_for`` picks for the shape on this backend.

Usage: python scripts/time_solver.py [reps]
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SHAPES = ((4096, 32), (2048, 128), (1024, 256), (256, 512), (16, 512))


def _spd(rng, n, d):
    g = rng.normal(size=(n, d, d)).astype(np.float32)
    return np.einsum("nij,nkj->nik", g, g) / d


def main():
    import jax
    import jax.numpy as jnp

    from safer2_recommender_tpu.ops import block_chol

    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    backend = jax.default_backend()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip() if backend == "gpu" else "none"
    print(f"# backend={backend} kind={jax.devices()[0].device_kind} "
          f"card={card}", flush=True)
    rng = np.random.default_rng(0)
    for n, d in SHAPES:
        a = _spd(rng, n, d)
        b = rng.normal(size=(n, d)).astype(np.float32)
        ridge = rng.uniform(0.01, 0.5, n).astype(np.float32)
        want = np.linalg.solve(
            a.astype(np.float64) + ridge[:, None, None] * np.eye(d),
            b.astype(np.float64)[..., None])[..., 0]
        da, db, dr = jnp.asarray(a), jnp.asarray(b), jnp.asarray(ridge)
        for name, fn in block_chol.SOLVERS.items():
            f = jax.jit(fn)
            t0 = time.perf_counter()
            x = np.asarray(jax.block_until_ready(f(da, db, dr)))
            compile_s = time.perf_counter() - t0
            err = float(np.max(np.abs(x - want)
                               / (np.abs(want) + 1e-3 * np.abs(want).max())))
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(f(da, db, dr))
                ts.append(time.perf_counter() - t0)
            print(json.dumps({
                "path": name, "n": n, "d": d,
                "median_ms": float(np.median(ts) * 1e3),
                "min_ms": float(np.min(ts) * 1e3),
                "first_call_s": compile_s, "max_rel_err": err,
                "chosen": block_chol.solver_for(backend, d) == name,
            }), flush=True)


if __name__ == "__main__":
    main()

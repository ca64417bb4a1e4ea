"""Device mesh and sharding helpers.

The reference has **no** communication backend — its "parallel runtime" is a
POSIX-thread work queue with a mutex-guarded iterator copy-pasted into every
model (e.g. reference ials.h:326-361, safer2.h:445-490). The
replacement here is SPMD over a 1-D `jax.sharding.Mesh`:

  * axis "data": users (or items) rows. All per-row independent work — the
    normal-equation assembly einsums, the batched Cholesky solves, the
    per-user loss/dual computations, and evaluation scoring — shards over
    this axis.
  * d x d Gramians and quantile statistics are tiny and latency-bound;
    XLA inserts `psum`-style all-reduces for them automatically when the
    batch inputs are sharded and the outputs are replicated.

Single-device execution degrades to no-ops: every helper accepts
``mesh=None`` and then simply places arrays on the default device.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def get_mesh(devices: Optional[Sequence[Any]] = None,
             axis_name: str = DATA_AXIS) -> Mesh:
    """Build a 1-D mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def row_sharding(mesh: Optional[Mesh], ndim: int,
                 axis_name: str = DATA_AXIS) -> Optional[NamedSharding]:
    """Sharding that splits the leading (row) axis over the mesh."""
    if mesh is None:
        return None
    return NamedSharding(mesh, P(axis_name, *([None] * (ndim - 1))))


def replicated(mesh: Optional[Mesh]) -> Optional[NamedSharding]:
    if mesh is None:
        return None
    return NamedSharding(mesh, P())


# Working-set budgets elsewhere in the package (bucket row caps, solve
# groups, slab fusion, wide-history streaming) are written as bytes on a
# 16 GiB device; ``memory_budget`` scales them to the device at hand.
_BUDGET_REFERENCE_BYTES = 16 << 30


def memory_budget(bytes_on_16gib: int) -> int:
    """``bytes_on_16gib`` as the same share of this process's device
    memory (``memory_stats()["bytes_limit"]`` of the first device). A
    backend that reports no memory stats (the CPU) keeps the value."""
    stats = jax.devices()[0].memory_stats()
    if not stats or not stats.get("bytes_limit"):
        return int(bytes_on_16gib)
    return int(bytes_on_16gib * stats["bytes_limit"]
               / _BUDGET_REFERENCE_BYTES)


def put(x, sharding):
    """device_put honoring ``sharding=None`` (single-device).

    When the sharding spans multiple processes (a multi-host mesh from
    ``jax.distributed.initialize``), ``jax.device_put`` cannot target
    non-addressable devices; every process holds the same full host
    array (each host parses the full CSV), so the global array is
    assembled from each process's addressable shards instead.
    """
    if (jax.process_count() > 1 and sharding is not None
            and not sharding.is_fully_addressable):
        # global_shape must be passed explicitly: without it the helper
        # assumes each process holds only ITS slice and scales the
        # sharded dimension by process_count — but every host here has
        # the same full array, so that would concatenate the copies
        # (every bucket process_count-times too long).
        x = np.asarray(x)
        return jax.make_array_from_process_local_data(
            sharding, x, global_shape=x.shape)
    if sharding is None:
        return jax.device_put(x)
    return jax.device_put(x, sharding)


def to_host(x) -> np.ndarray:
    """``np.asarray`` that also works for multi-process global arrays.

    A jitted program over a multi-host mesh can return row-sharded
    outputs whose shards live partly on other processes' devices;
    ``np.asarray`` on those raises. Replicate first (an all-gather over
    the array's own mesh), then convert."""
    if isinstance(x, jax.Array) and not (x.is_fully_addressable
                                         or x.is_fully_replicated):
        sh = NamedSharding(x.sharding.mesh, P())
        x = jax.jit(lambda a: a, out_shardings=sh)(x)
    return np.asarray(x)


def shard_pytree_rows(tree, mesh: Optional[Mesh]):
    """Shard every array leaf of a pytree along its leading axis;
    scalar (0-d) leaves replicate."""
    if mesh is None:
        return jax.tree_util.tree_map(lambda x: put(x, None), tree)

    def _shard(x):
        nd = np.ndim(x)
        sh = row_sharding(mesh, nd) if nd else replicated(mesh)
        return put(x, sh)

    return jax.tree_util.tree_map(_shard, tree)


def num_shards(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else int(np.prod(list(mesh.shape.values())))

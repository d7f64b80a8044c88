"""Multi-process (multi-controller) array placement and synchronization.

The reference's only true multi-process component is Spark node2vec: a
driver hands partitioned RDD work to executor JVMs and every walk step is a
cluster-wide shuffle (`node2vec_spark/.../Node2vec.scala:24-61, 103-124`).
The equivalent here is JAX multi-controller: every host runs the SAME
program, `jax.distributed.initialize` barriers them into one job, and global
arrays span all hosts' devices. This module provides the placement helpers
that make the single-process training steps run unchanged across processes:

- `global_put(mesh, spec, tree)` — build global jax.Arrays from
  host-replicated numpy data (every process holds the full value, as with
  Spark broadcast variables); each process materializes only its
  addressable shards via `jax.make_array_from_callback`.
- `fetch_replicated(tree)` — read back a fully-replicated result on any
  process (the inverse boundary crossing).
- `sync()` — cross-host barrier (used around checkpoint save/restore, the
  checkpoint-restart failure model of SURVEY.md §5).

Placement contracts are shared with the single-process path:
`dp.twowl_split_specs` / `dp.seal_batch_spec` produce the PartitionSpecs,
and `jax.device_put` (single process) or `global_put` (multi process)
realize them. The actual training-step code is identical in both regimes —
only array construction differs.
"""

from __future__ import annotations

from typing import Any

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_cpu(
    coordinator_address: str, num_processes: int, process_id: int,
    local_devices: int,
) -> None:
    """Initialize a multi-process CPU job with `local_devices` virtual
    devices per process. Must run before any other jax call in the process
    (the XLA_FLAGS env var must already name the device count)."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=list(range(local_devices)),
    )


def global_mesh(
    shape: tuple[int, ...], axis_names: tuple[str, ...]
) -> Mesh:
    """Mesh over ALL global devices (every process's), leading axis over
    processes — the hosts-outer/devices-inner layout of
    `distributed.hybrid_mesh`, built from the global device list (which
    jax orders process-major, so a plain reshape puts the process boundary
    on the leading axis)."""
    devs = jax.devices()
    n = int(np.prod(shape))
    assert len(devs) >= n, f"need {n} devices, have {len(devs)}"
    return Mesh(np.array(devs[:n]).reshape(shape), axis_names)


def global_put(mesh: Mesh, spec: Any, tree: Any):
    """Place host-replicated numpy/jax data as global arrays on the mesh.

    `spec` is a PartitionSpec applied to every leaf, or a pytree of specs
    matching `tree`'s structure (dict keyed like the leaves). Works in both
    single- and multi-process regimes; in multi-process each host only
    materializes its addressable shards.
    """
    is_spec = lambda s: isinstance(s, P)  # noqa: E731

    def one(leaf, s):
        arr = np.asarray(leaf)
        sharding = NamedSharding(mesh, s)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx, a=arr: a[idx]
        )

    if is_spec(spec):
        return jax.tree_util.tree_map(lambda l: one(l, spec), tree)
    return jax.tree_util.tree_map(one, tree, spec, is_leaf=is_spec)


def global_twowl_split(mesh: Mesh, arrays):
    """`dp.shard_twowl_split` for the multi-process regime: same placement
    contract (`dp.twowl_split_specs`), arrays built globally."""
    from linkpred.parallel.dp import twowl_split_specs

    specs = twowl_split_specs(arrays)
    return type(arrays)(
        **{
            k: global_put(mesh, specs[k], v)
            for k, v in arrays._asdict().items()
        }
    )


def fetch_replicated(tree: Any):
    """Host numpy values of fully-replicated global arrays (each process
    reads its local copy — no collective)."""

    def one(x):
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            shard = x.addressable_shards[0]
            if shard.index != (slice(None),) * x.ndim:
                # GSPMD left the output sharded: re-replicate with a
                # collective identity, then read the local full copy
                mesh = x.sharding.mesh
                x = jax.jit(
                    lambda a: a, out_shardings=NamedSharding(mesh, P())
                )(x)
                shard = x.addressable_shards[0]
            return np.asarray(shard.data)
        return np.asarray(x)

    return jax.tree_util.tree_map(one, tree)


def sync(name: str = "sync") -> None:
    """Cross-process barrier (no-op single-process)."""
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)

"""Multi-host initialization and hybrid intra-/inter-host mesh construction.

The reference's only multi-host component is Spark node2vec (driver +
executors over the JVM, `Node2vec.scala`); its training never leaves one
process. The multi-host story here is `jax.distributed` + GSPMD:

- every host calls `initialize()` (coordinator address from the env or
  args) — the barrier-at-init that Spark gets from its driver handshake;
- the global device list then spans all hosts, and
  `hybrid_mesh(ici_axes, dcn_axes)` lays out a mesh whose inner axes map to
  the fast links within a host (NVLink between the GPUs of one machine)
  and outer axes to the network between hosts (JAX's "DCN"), using
  `jax.experimental.mesh_utils.create_hybrid_device_mesh`;
- shardings over the inner axes ride the fast links (edge-partitioned
  SpMM psum, `linkpred.parallel.spmm_shard`), outer axes carry
  data-parallel gradient reduction — keep the chatty collectives inside
  a host.

Single-host (or CPU-mesh test) callers can skip `initialize()` entirely;
every helper degrades to the local device list. Fault handling follows the
checkpoint-restart model: `jax.distributed.initialize` re-barriers a
restarted host, and trainers restore from `utils.checkpoint` artifacts.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize `jax.distributed` if multi-process env vars/args are
    present; returns True when running distributed. Safe to call on a
    single host (no-op)."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def hybrid_mesh(
    ici_shape: Sequence[int],
    dcn_shape: Sequence[int] = (1,),
    axis_names: Sequence[str] = ("host", "data", "edge"),
) -> Mesh:
    """Mesh with outer axes across hosts and inner axes within a host.

    `ici_shape` factorizes the per-host devices (e.g. (2, 2) for
    data x edge on 4 GPUs); `dcn_shape` the host count. Falls back to a
    plain reshape when the hybrid helper is unavailable (CPU test meshes).
    """
    shape = tuple(dcn_shape) + tuple(ici_shape)
    try:
        from jax.experimental import mesh_utils

        devices = mesh_utils.create_hybrid_device_mesh(
            mesh_shape=tuple(ici_shape),
            dcn_mesh_shape=tuple(dcn_shape) + (1,) * (len(ici_shape) - 1),
        )
        devices = devices.reshape(shape)
    except (ValueError, AssertionError, AttributeError) as e:
        # CPU/virtual devices carry no slice topology — the hybrid helper
        # rejects them. Fall back to a process-major reshape (jax orders
        # the global device list by process, so the DCN axis still lands
        # on the process boundary). On real multi-host jobs any other
        # failure here must surface, not silently degrade the layout.
        import logging

        logging.getLogger(__name__).info(
            "hybrid mesh unavailable (%s); using process-major reshape", e
        )
        devices = np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape)
    return Mesh(devices, tuple(axis_names[: len(shape)]))

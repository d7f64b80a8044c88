"""Device mesh construction helpers.

Axes:
- ``data``  — data parallelism: batches of enclosing subgraphs (SEAL),
  minibatches of target pairs (TwoWL), walker blocks (node2vec).
- ``edge``  — graph/model parallelism: partitions of the edge set for
  SpMM / segment aggregation; partial row-sums are combined with a
  ``psum`` over this axis (the interconnect analog of Spark's partitioned
  aggregate, reference `Node2vec.scala:52-61`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data", "edge"),
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    """Build a mesh over the first `n_devices` devices.

    Default factorization puts the larger factor on ``data`` (subgraph
    batches dominate at fb-pages-food scale) and the rest on ``edge``.
    """
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    if shape is None:
        # largest power-of-two split: data gets n / edge, edge gets 2 if possible
        edge = 2 if n % 2 == 0 and n > 1 else 1
        shape = (n // edge, edge)
    arr = np.array(devs).reshape(tuple(shape))
    return Mesh(arr, tuple(axis_names))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) dimension over the ``data`` axis."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())

"""Mesh-parallel training steps for the model families.

Two orthogonal axes (SURVEY.md §2.7 consequence table):

- **SEAL**: pure data parallelism — the padded subgraph stack is sharded
  over the whole mesh on the batch dimension; parameters stay replicated
  and XLA inserts the gradient `psum` (GSPMD). This is the device version of
  "data-parallel subgraph training" the reference never had (its trainer
  feeds one subgraph per `sess.run`, `SEAL/model/gnn.py:172-181`).
- **TwoWL**: the heavy arrays are the ei2 edge-pair columns; they are
  sharded over the ``edge`` axis while the (small) node/edge-row states
  stay replicated, so the 2-WL segment-sums become partial sums + psum —
  edge partitioning with collective combine.

Both helpers produce placed (device_put) inputs and call the family's
existing jit-compiled step — the single-chip and multi-chip code paths are
the same traced function, only shardings differ.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _put(tree: Any, sharding: NamedSharding):
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sharding), tree)


def seal_batch_spec(mesh: Mesh) -> P:
    """PartitionSpec sharding the subgraph-batch axis over every mesh axis."""
    return P(tuple(mesh.axis_names))


def shard_seal_batch(mesh: Mesh, d_inv, a_tilde, x, node_mask, y):
    """Shard the subgraph-batch axis over every mesh axis (full DP)."""
    batch_sharding = NamedSharding(mesh, seal_batch_spec(mesh))
    return tuple(
        jax.device_put(a, batch_sharding) for a in (d_inv, a_tilde, x, node_mask, y)
    )


def replicate(mesh: Mesh, tree: Any):
    return _put(tree, NamedSharding(mesh, P()))


def twowl_split_specs(arrays) -> dict:
    """Placement contract for a TwoWL `SplitArrays` on a mesh with an
    ``edge`` axis: the ei2 direction columns (`e1_*`/`e2_*`) shard over
    ``edge``, everything else replicates (node count and edge-row count are
    small relative to the ei2 cartesian products). The SegmentPlan operand
    tuples (`*_plan`) and the composed-gather structures (`*_cops`) are
    index plans with bucket-shaped arrays — they replicate (GSPMD handles
    the gathers). Returns {field: PartitionSpec}."""
    return {
        k: (P("edge")
            if k.startswith(("e1_", "e2_"))
            and not k.endswith(("_plan", "_cops"))
            else P())
        for k in arrays._asdict()
    }


def shard_twowl_split(mesh: Mesh, arrays):
    """Place a TwoWL `SplitArrays` on the mesh per `twowl_split_specs`.
    Sharding a sorted axis keeps per-device shards sorted, so the
    `indices_are_sorted` fast path survives partitioning."""
    specs = twowl_split_specs(arrays)
    return type(arrays)(
        **{
            k: jax.device_put(v, NamedSharding(mesh, specs[k]))
            for k, v in arrays._asdict().items()
        }
    )


def shard_twowl_trials(mesh: Mesh, params, opt_state, lrs, rates,
                       axis: str = "data"):
    """Sweep parallelism for the trial-major TwoWL engine: shard the TRIAL
    axis over a mesh axis, so N devices train N x T trials in one program.

    The trial axis sits at a different position per leaf (the degree
    embedding keeps its index axis leading — `models.twowl._trial_axes`),
    so each leaf gets its own PartitionSpec. Graph arrays stay replicated;
    all trial-major compute is batched over trailing trial dims, which
    GSPMD splits cleanly along the trial axis with zero collectives until
    the (tiny) final AUC reduction.
    """
    from linkpred.models.twowl import _trial_axes

    def put(tree):
        axes = _trial_axes(tree)

        def one(leaf, ax):
            spec = [None] * leaf.ndim
            spec[ax] = axis
            return jax.device_put(leaf, NamedSharding(mesh, P(*spec)))

        return jax.tree_util.tree_map(one, tree, axes)

    params = put(params)
    opt_state = _put_opt_like_params(mesh, opt_state, params, axis)
    vec = NamedSharding(mesh, P(axis))
    lrs = jax.device_put(lrs, vec)
    rates = jax.tree_util.tree_map(lambda r: jax.device_put(r, vec), rates)
    return params, opt_state, lrs, rates


def _put_opt_like_params(mesh: Mesh, opt_state, params, axis: str):
    """Place optimizer-state leaves with the param leaf's trial sharding
    when shapes match (adam mu/nu mirror params); scalars replicate."""
    from linkpred.models.twowl import _trial_axes

    axes = _trial_axes(params)
    by_shape = {}
    jax.tree_util.tree_map(
        lambda leaf, ax: by_shape.setdefault(leaf.shape, ax), params, axes
    )

    def one(leaf):
        ax = by_shape.get(getattr(leaf, "shape", None))
        if ax is None:
            return jax.device_put(leaf, NamedSharding(mesh, P()))
        spec = [None] * leaf.ndim
        spec[ax] = axis
        return jax.device_put(leaf, NamedSharding(mesh, P(*spec)))

    return jax.tree_util.tree_map(one, opt_state)

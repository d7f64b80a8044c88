"""Edge-partitioned sparse aggregation over a device mesh.

The multi-chip SpMM design (SURVEY.md §7 step 8): the edge set is sharded
over the ``edge`` mesh axis; every device computes a *partial* segment-sum
of its edge shard into a full-height [N, F] accumulator, and partials are
combined with one `psum` over the ``edge`` axis — XLA rides this collective
over the device interconnect. This carries the behavioral contract of the Spark walk/aggregate
partitioning (`Node2vec.scala:52-61, 103-124`: partition edges, aggregate
locally, exchange) without any RDD shuffle.

For feature dims that don't fit replicated, the same kernel composes with a
sharded feature axis (`P(None, "data")`) — GSPMD then splits the psum into
reduce-scatters automatically.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from linkpred.ops.segment import segment_sum


def spmm_edge_partitioned(
    mesh: Mesh,
    src: jnp.ndarray,  # [E] int32 (E divisible by mesh axis size, pad+mask)
    dst: jnp.ndarray,  # [E]
    x: jnp.ndarray,  # [N, F] node features (replicated)
    num_nodes: int,
    edge_weight: jnp.ndarray | None = None,
    mask: jnp.ndarray | None = None,
    sorted_dst: bool = False,
) -> jnp.ndarray:
    """out[i] = sum_{e: dst_e = i} w_e x[src_e], edges sharded over ``edge``.

    Pass `sorted_dst=True` when each shard's dst ids are presorted (sort
    the edge list by dst on the host BEFORE padding/partitioning —
    contiguous shards of a sorted list stay sorted). Without it XLA sorts
    the full [E_shard, F] message payload on every call, which dominates
    everything at scale."""

    def local(src_l, dst_l, x_l, w_l, m_l):
        msgs = x_l[src_l]
        if w_l is not None:
            msgs = msgs * w_l[:, None]
        part = segment_sum(msgs, dst_l, num_nodes, m_l,
                           indices_are_sorted=sorted_dst)
        return jax.lax.psum(part, "edge")

    espec = P("edge")
    has_w = edge_weight is not None
    has_m = mask is not None

    fn = shard_map(
        lambda s, d, xx, w, mm: local(s, d, xx, w if has_w else None, mm if has_m else None),
        mesh=mesh,
        in_specs=(espec, espec, P(), espec if has_w else P(), espec if has_m else P()),
        out_specs=P(),
    )
    w = edge_weight if has_w else jnp.zeros((src.shape[0],), x.dtype)
    mm = mask if has_m else jnp.ones((src.shape[0],), bool)
    return fn(src, dst, x, w, mm)


def build_node_sharded_buckets(g, n_shards: int):
    """Host-side layout for `spmm_node_sharded`: contiguous node blocks per
    device, each with its own degree-bucketed ELL (`ops.spmm.BucketedEll`),
    bucket arrays padded to equal shapes across shards and stacked on a
    leading device axis.

    Local row ids within a shard are offsets into its block; padding rows
    point past the block (row `rows_per_shard + j`) so every `.set` target
    stays unique and sorted — the local aggregation keeps the scatter-free
    path.

    Returns `(rows_per_shard, bucket_widths, stacked)` where `stacked` is a
    flat tuple of numpy arrays: per bucket `(ids [S, m], nbr [S, m, w],
    wgt [S, m, w])`.
    """
    import numpy as np

    from linkpred.ops.spmm import BucketedEll

    n = g.num_nodes
    rows = -(-n // n_shards)
    per_shard = []
    for k in range(n_shards):
        lo, hi = k * rows, min((k + 1) * rows, n)
        nbr = g.nbr[lo:hi]
        mask = g.nbr_mask[lo:hi]
        w = g.nbr_weight[lo:hi] if g.nbr_weight is not None else None
        per_shard.append(BucketedEll.build(nbr, mask, w))
    # unify bucket width sets across shards
    widths = sorted({nb.shape[1] for lay in per_shard for _, nb, _ in lay.buckets})
    stacked = []
    # per-shard local-row -> concat-of-bucket-aggregates position (the
    # scatter-free assembly of ops.spmm.spmm_bucketed; uncovered rows ->
    # the appended zero row); shipped as the FIRST stacked operand
    out_inv = np.full((n_shards, rows), -1, np.int64)
    offset = 0
    for wd in widths:
        sizes = []
        for lay in per_shard:
            m = next((b[0].shape[0] for b in lay.buckets
                      if b[1].shape[1] == wd), 0)
            sizes.append(m)
        m_max = max(max(sizes), 1)
        ids_s = np.zeros((n_shards, m_max), np.int32)
        nbr_s = np.zeros((n_shards, m_max, wd), np.int32)
        wgt_s = np.zeros((n_shards, m_max, wd), np.float32)
        for k, lay in enumerate(per_shard):
            b = next((b for b in lay.buckets if b[1].shape[1] == wd), None)
            m = 0
            if b is not None:
                ids, nb, wg = b
                m = ids.shape[0]
                ids_s[k, :m] = ids
                nbr_s[k, :m] = nb
                wgt_s[k, :m] = wg
                out_inv[k, ids] = offset + np.arange(m)
            # padding rows target rows beyond the block -> unique + sorted
            ids_s[k, m:] = rows + np.arange(m_max - m, dtype=np.int32)
        offset += m_max
        stacked.extend((ids_s, nbr_s, wgt_s))
    out_inv[out_inv < 0] = offset
    return rows, widths, (out_inv.astype(np.int32),) + tuple(stacked)


def spmm_node_sharded(
    mesh: Mesh,
    x: jnp.ndarray,  # [N_pad? no: N, F] node features (replicated)
    num_nodes: int,
    rows_per_shard: int,
    *stacked,  # build_node_sharded_buckets(...)[2], as device arrays
    axis: str = "edge",
) -> jnp.ndarray:
    """Node(row)-partitioned bucketed SpMM over the mesh.

    Each device aggregates its own contiguous row block with the
    scatter-free bucketed-ELL kernel, gathering from the replicated `x`
    with *global* neighbor ids; out rows assemble across the `axis` mesh
    dimension (out_specs `P(axis)` — GSPMD inserts the collective when a
    consumer needs other rows). Local compute is gather+einsum only, so
    the per-chip rate matches the single-chip fast path; the collective
    is [N, F]-sized, independent of E.
    """
    n_shards = mesh.shape[axis]
    pad_rows = rows_per_shard * n_shards

    def local(x_rep, out_inv, *ops):
        prec = (jax.lax.Precision.HIGHEST
                if x_rep.dtype == jnp.float32 else jax.lax.Precision.DEFAULT)
        f = x_rep.shape[1]
        aggs = []
        for i in range(0, len(ops), 3):
            nb, wg = ops[i + 1][0], ops[i + 2][0]
            g = x_rep[nb.reshape(-1)].reshape(*nb.shape, f)
            aggs.append(jnp.einsum("nd,ndf->nf", wg.astype(x_rep.dtype), g,
                                   precision=prec))
        # scatter-free assembly (ops.spmm.spmm_bucketed): inverse-perm
        # gather instead of per-bucket `.set` copies of the accumulator
        aggs.append(jnp.zeros((1, f), x_rep.dtype))
        return jnp.concatenate(aggs, axis=0)[out_inv[0]]

    in_specs = (P(),) + (P(axis),) * len(stacked)
    fn = shard_map(local, mesh=mesh, in_specs=in_specs, out_specs=P(axis))
    out = fn(x, *stacked)
    return out[:num_nodes] if pad_rows > num_nodes else out


def spmm_node_sharded_pipelined(
    mesh,
    x: jnp.ndarray,  # [N, F] node features, ROW-sharded over `axis`
    num_nodes: int,
    rows_per_shard: int,
    *stacked,
    axis: str = "edge",
    chunks: int = 4,
) -> jnp.ndarray:
    """Node-sharded SpMM with EXPLICIT collective/compute overlap.

    `spmm_node_sharded` keeps x replicated and leaves the row assembly to
    GSPMD — one [N, F] collective per layer, scheduled however the
    compiler likes. This variant keeps x row-sharded (P(axis)) and
    double-buffers on the FEATURE axis: the aggregation is linear over
    features, so each F/chunks stripe needs only its own rows. Per stripe:
    `all_gather` the stripe inside shard_map, then run the bucket einsums
    for that stripe. Consecutive stripes give XLA's async-collective
    scheduler a gather to issue while the previous stripe's einsums run —
    the all-to-all-overlapped-with-local-aggregation design of SURVEY §5 /
    BASELINE north star (the Spark analog: the per-step frontier `join`
    of `Node2vec.scala:103-124` overlapped instead of barriered).

    `chunks=1` is the explicit no-overlap baseline (one monolithic gather,
    then all compute) for A/B measurement. Output is row-sharded P(axis).
    Overlap materializes on a real interconnect; on the virtual CPU mesh
    this only validates numerics + shapes.
    """
    n_shards = mesh.shape[axis]
    f = x.shape[1]
    assert f % chunks == 0, (f, chunks)
    fc = f // chunks

    def local(x_l, out_inv, *ops):
        out = jnp.zeros((rows_per_shard, f), x_l.dtype)
        prec = (jax.lax.Precision.HIGHEST
                if x_l.dtype == jnp.float32 else jax.lax.Precision.DEFAULT)
        for c in range(chunks):
            sl = slice(c * fc, (c + 1) * fc)
            xg = jax.lax.all_gather(x_l[:, sl], axis, tiled=True)
            aggs = []
            for i in range(0, len(ops), 3):
                nb, wg = ops[i + 1][0], ops[i + 2][0]
                g = xg[nb.reshape(-1)].reshape(*nb.shape, fc)
                aggs.append(jnp.einsum("nd,ndf->nf", wg.astype(x_l.dtype),
                                       g, precision=prec))
            aggs.append(jnp.zeros((1, fc), x_l.dtype))
            stripe = jnp.concatenate(aggs, axis=0)[out_inv[0]]
            out = out.at[:, sl].set(stripe)
        return out

    in_specs = (P(axis),) + (P(axis),) * len(stacked)
    fn = shard_map(local, mesh=mesh, in_specs=in_specs, out_specs=P(axis))
    pad_rows = rows_per_shard * n_shards
    if x.shape[0] < pad_rows:
        x = jnp.pad(x, ((0, pad_rows - x.shape[0]), (0, 0)))
    out = fn(x, *stacked)
    return out[:num_nodes] if pad_rows > num_nodes else out


def spmm_node_sharded_sym(mesh, x, num_nodes, rows_per_shard, stacked,
                          axis: str = "edge"):
    """`spmm_node_sharded` with a custom VJP for SYMMETRIC aggregation
    matrices (undirected graph + symmetric normalization, w_ij = w_ji):
    d/dx (A x) = A^T g = A g, so the backward pass is the same
    gather+einsum kernel — no scatter-add in either direction. This is what
    makes end-to-end GCN *training* at scale run at the aggregation
    kernel's speed (the default VJP of the gather is a scatter-add over
    every edge slot).

    `stacked` is the tuple from `build_node_sharded_buckets(...)[2]` as
    device arrays."""

    @partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3))
    def run(x, num_nodes_, rows_, axis_, stacked_):
        return spmm_node_sharded(mesh, x, num_nodes_, rows_, *stacked_,
                                 axis=axis_)

    def fwd(x, num_nodes_, rows_, axis_, stacked_):
        return run(x, num_nodes_, rows_, axis_, stacked_), stacked_

    def bwd(num_nodes_, rows_, axis_, stacked_, g):
        dx = spmm_node_sharded(mesh, g, num_nodes_, rows_, *stacked_,
                               axis=axis_)
        # operand arrays get zero cotangents (float0 for the int layouts)
        import numpy as np

        zeros = tuple(
            np.zeros(a.shape, jax.dtypes.float0)
            if not jnp.issubdtype(a.dtype, jnp.inexact) else jnp.zeros_like(a)
            for a in stacked_
        )
        return (dx, zeros)

    run.defvjp(fwd, bwd)
    return run(x, num_nodes, rows_per_shard, axis, stacked)


def pad_edges_for_mesh(arrs, axis_size: int, pad_value=0):
    """Pad 1-D edge arrays to a multiple of the mesh axis size; returns
    (padded_arrays, valid_mask)."""
    e = arrs[0].shape[0]
    target = -(-e // axis_size) * axis_size
    pad = target - e
    out = [jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1), constant_values=pad_value) for a in arrs]
    mask = jnp.arange(target) < e
    return out, mask

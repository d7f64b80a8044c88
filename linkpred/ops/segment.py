"""Segment/scatter aggregation primitives.

These replace the reference's torch-scatter C++/CUDA kernels
(`TwoWL/utils.py:8-10` computes degrees with `scatter_add`; every PyG
`GCNConv` in `TwoWL/model/model.py` scatters messages by destination).
Here the form is `jax.ops.segment_sum` over *static-capacity* edge arrays
with validity masks, so everything stays jit-compatible when edges are
masked/dropped dynamically (e.g. TwoWL's `sample_block` leakage masking).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def take_rows(x: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Row gather as one 2-D [rows, cols] take: flattens trailing dims,
    gathers whole rows, reshapes back. `idx` may be any integer shape."""
    tail = x.shape[1:]
    flat = x.reshape(x.shape[0], -1) if len(tail) != 1 else x
    out = flat[idx]
    return out.reshape(idx.shape + tail)


def segment_sum(
    data: jnp.ndarray,
    segment_ids: jnp.ndarray,
    num_segments: int,
    mask: jnp.ndarray | None = None,
    indices_are_sorted: bool = False,
) -> jnp.ndarray:
    """Masked segment sum. `data` [E, ...], `segment_ids` [E] -> [S, ...].

    Pass `indices_are_sorted=True` when the ids are presorted (static edge
    structures sorted once on the host) — XLA then skips the per-call
    sort. Ids >= num_segments
    (capacity padding) are dropped.
    """
    if mask is not None:
        data = data * mask.reshape((-1,) + (1,) * (data.ndim - 1)).astype(data.dtype)
    return jax.ops.segment_sum(
        data,
        segment_ids,
        num_segments=num_segments,
        indices_are_sorted=indices_are_sorted,
    )


def segment_mean(
    data: jnp.ndarray,
    segment_ids: jnp.ndarray,
    num_segments: int,
    mask: jnp.ndarray | None = None,
    eps: float = 1e-12,
) -> jnp.ndarray:
    ones = jnp.ones((data.shape[0],), dtype=data.dtype)
    cnt = segment_sum(ones, segment_ids, num_segments, mask)
    tot = segment_sum(data, segment_ids, num_segments, mask)
    return tot / jnp.maximum(cnt, eps).reshape((-1,) + (1,) * (data.ndim - 1))


def segment_max(
    data: jnp.ndarray, segment_ids: jnp.ndarray, num_segments: int
) -> jnp.ndarray:
    return jax.ops.segment_max(data, segment_ids, num_segments=num_segments)


@partial(jax.jit, static_argnames=("num_nodes",))
def degree_from_edges(
    dst: jnp.ndarray, num_nodes: int, mask: jnp.ndarray | None = None
) -> jnp.ndarray:
    """In-degree by destination — the equivalent of reference
    `TwoWL/utils.py:8-10` (`scatter_add(ones, ei[1])`). With `mask`, masked
    edges do not count (used by `sample_block`-style leakage removal)."""
    ones = jnp.ones_like(dst, dtype=jnp.float32)
    return segment_sum(ones, dst, num_nodes, mask)


def gcn_norm_coefficients(
    src: jnp.ndarray,
    dst: jnp.ndarray,
    num_nodes: int,
    mask: jnp.ndarray | None = None,
    add_self_loops: bool = True,
    indices_are_sorted: bool = False,
    plan: tuple | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Symmetric GCN normalization `1/sqrt(d_u d_v)` per edge.

    Matches PyG's `gcn_norm` semantics used inside the reference's `GCNConv`
    layers: degrees count incoming edge weight by `dst` (+1 when self-loops
    are added), and each edge weight becomes
    `deg_inv_sqrt[src] * deg_inv_sqrt[dst]`.

    Returns (edge_coeff [E], self_loop_coeff [N]); the self-loop contribution
    is applied densely by the caller (keeps the edge arrays static).
    """
    ones = jnp.ones_like(dst, dtype=jnp.float32)
    if mask is not None:
        ones = ones * mask.astype(jnp.float32)
    if plan is not None:
        deg = segment_sum_planned(num_nodes, ones, *plan)
    else:
        deg = segment_sum(
            ones, dst, num_nodes, indices_are_sorted=indices_are_sorted
        )
    if add_self_loops:
        deg = deg + 1.0
    dinv = jax.lax.rsqrt(jnp.maximum(deg, 1e-12))
    coeff = dinv[src] * dinv[dst]
    if mask is not None:
        coeff = coeff * mask.astype(coeff.dtype)
    self_coeff = dinv * dinv if add_self_loops else jnp.zeros_like(dinv)
    return coeff, self_coeff


# ---------------------------------------------------------------------------
# planned (scatter-free) segment sum for static segment structures
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Host-built, scatter-free plan for a *static* segment structure.

    The plan replaces the scatter-add inside `segment_sum` (and its
    vmapped form) with gathers. When segment ids are known on the host
    (TwoWL's message/ei2 structures; any static graph), the sum can be
    planned as pure gathers:

    - slots grouped per segment into degree-bucketed `[m_b, w_b]` position
      matrices (power-of-two widths, sentinel `num_slots` pads),
    - forward: gather + width-axis reduce per bucket, concatenate, then
      one gather by a precomputed inverse permutation reorders segment
      rows (count-0 segments point at a zero row) — no scatter anywhere,
    - backward (custom VJP): the slots partition the segment rows, so the
      cotangent is exactly `g[segment_id]` per slot — one gather; JAX's
      default would emit a scatter here too.

    Both directions are gathers, so `jax.vmap` batches them natively.
    Masking composes by zeroing message rows (weights) before the sum.
    """

    num_segments: int
    num_slots: int
    dst_clipped: np.ndarray  # [S] int32 ids, >= num_segments -> sentinel
    inv_perm: np.ndarray  # [num_segments] int32 into concat-of-buckets
    slot_buckets: tuple  # of int32 [m_b, w_b] slot-position matrices

    @staticmethod
    def build(segment_ids: np.ndarray, num_segments: int,
              min_width: int = 4) -> "SegmentPlan":
        ids = np.asarray(segment_ids, dtype=np.int64).reshape(-1)
        s = ids.shape[0]
        valid = (ids >= 0) & (ids < num_segments)
        counts = np.bincount(ids[valid], minlength=num_segments)
        order = np.argsort(ids[valid], kind="stable")
        slot_pos = np.nonzero(valid)[0][order].astype(np.int32)
        starts = np.concatenate([[0], np.cumsum(counts)])

        max_c = int(counts.max()) if num_segments else 0
        widths = []
        w = max(1, min_width)
        while True:
            widths.append(min(w, max(max_c, 1)))
            if w >= max_c:
                break
            w *= 2
        inv_perm = np.full(num_segments, -1, dtype=np.int64)
        slot_buckets = []
        offset = 0
        prev = 0
        for wd in widths:
            segs = np.nonzero((counts > prev) & (counts <= wd))[0]
            prev = wd
            if len(segs) == 0:
                continue
            m = len(segs)
            # vectorized ragged-to-padded fill (no per-segment Python loop)
            pos = starts[segs][:, None] + np.arange(wd)[None, :]
            ok = np.arange(wd)[None, :] < counts[segs][:, None]
            mat = np.where(
                ok,
                slot_pos[np.minimum(pos, len(slot_pos) - 1)],
                np.int32(s),
            ).astype(np.int32)
            inv_perm[segs] = offset + np.arange(m)
            offset += m
            slot_buckets.append(mat)
        inv_perm[inv_perm < 0] = offset  # count-0 segments -> zero row
        return SegmentPlan(
            num_segments=num_segments,
            num_slots=s,
            dst_clipped=np.minimum(ids, num_segments).astype(np.int32),
            inv_perm=inv_perm.astype(np.int32),
            slot_buckets=tuple(slot_buckets),
        )

    def operands(self):
        """Flat tuple of device arrays for `segment_sum_planned` — valid
        pytree leaves, so plans ride inside jitted containers."""
        return (
            jnp.asarray(self.dst_clipped),
            jnp.asarray(self.inv_perm),
            tuple(jnp.asarray(b) for b in self.slot_buckets),
        )


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def segment_sum_planned(num_segments: int, msgs, dst, inv_perm, slot_buckets):
    """Scatter-free segment sum over a `SegmentPlan`.

    `msgs` [S, ...] -> [num_segments, ...]; `(dst, inv_perm, slot_buckets)`
    come from `SegmentPlan.operands()` (slot_buckets is a tuple).
    Equivalent to `segment_sum(msgs, ids, num_segments)` for the plan's
    static ids, but both forward and backward are pure gathers
    (vmap-friendly — see class docstring).
    """
    return _planned_fwd_impl(msgs, inv_perm, slot_buckets)


def _planned_fwd_impl(msgs, inv_perm, slot_buckets):
    # all gathers in flattened-2-D form (see take_rows), indices
    # flattened to 1-D
    tail = msgs.shape[1:]
    flat = msgs.reshape(msgs.shape[0], -1)
    f = flat.shape[1]
    ext = jnp.concatenate(
        [flat, jnp.zeros((1, f), flat.dtype)], axis=0
    )
    parts = [
        ext[b.reshape(-1)].reshape(*b.shape, -1).sum(axis=1)
        for b in slot_buckets
    ]
    parts.append(jnp.zeros((1, f), flat.dtype))
    out = jnp.concatenate(parts, axis=0)[inv_perm]
    return out.reshape((out.shape[0],) + tail)


def _planned_fwd(num_segments, msgs, dst, inv_perm, slot_buckets):
    return _planned_fwd_impl(msgs, inv_perm, slot_buckets), (dst,)


def _planned_bwd(num_segments, res, g):
    (dst,) = res
    tail = g.shape[1:]
    flat = g.reshape(g.shape[0], -1)
    g_ext = jnp.concatenate(
        [flat, jnp.zeros((1, flat.shape[1]), flat.dtype)], axis=0
    )
    out = g_ext[dst]
    return (out.reshape((dst.shape[0],) + tail), None, None, None)


segment_sum_planned.defvjp(_planned_fwd, _planned_bwd)


@jax.custom_vjp
def gather_rows_planned(x, idx, plan):
    """Row gather `x[idx]` whose BACKWARD is the scatter-free planned
    segment-sum instead of XLA's default scatter-add.

    The default VJP of a gather is `zeros.at[idx].add(g)` — an unsorted
    scatter over every slot of the 2-WL training backward. When `idx` is
    STATIC (host-known
    edge structure), pass `plan = SegmentPlan.build(idx, x.shape[0])
    .operands()`: the cotangent becomes per-row bucket gathers + reduces
    — pure gathers both directions."""
    del plan
    return _gather_rows_impl(x, idx)


def _gather_rows_impl(x, idx):
    tail = x.shape[1:]
    flat = x.reshape(x.shape[0], -1)
    out = flat[idx]
    return out.reshape(idx.shape + tail)


def _gather_planned_fwd(x, idx, plan):
    return _gather_rows_impl(x, idx), (idx, plan)


def _gather_planned_bwd(res, g):
    idx, plan = res
    _, inv_perm, slot_buckets = plan
    dx = _planned_fwd_impl(g, inv_perm, slot_buckets)

    def f0(a):
        if jnp.issubdtype(a.dtype, jnp.inexact):
            return jnp.zeros_like(a)
        return np.zeros(a.shape, jax.dtypes.float0)

    return (dx, f0(idx), jax.tree_util.tree_map(f0, plan))


gather_rows_planned.defvjp(_gather_planned_fwd, _gather_planned_bwd)


# ---------------------------------------------------------------------------
# composed gather-sum: one gather per aggregation (fwd AND bwd)
# ---------------------------------------------------------------------------


def composed_operands(plan: "SegmentPlan", values: np.ndarray,
                      sentinel: int):
    """Composed bucket matrices for `gather_sum_composed`: the plan's
    slot-position buckets with `values[slotpos]` substituted (pads and
    invalid slots -> `sentinel`, the caller's zero row).

    Motivation: the planned aggregation `segment_sum_planned(h[src] *
    coeff)` costs TWO S-slot gathers — h by src, then the messages by
    bucket position. Composing `src` into the bucket positions on the
    host gathers h DIRECTLY in bucket order: one S-gather. The GCN edge
    coefficient folds into row-wise multiplies because its dst factor
    is constant within a segment (dinv[dst] applied on the output rows,
    dinv[src]*mask applied on the input rows).
    """
    values_ext = np.append(
        np.asarray(values, np.int64), sentinel).astype(np.int32)
    buckets = tuple(
        jnp.asarray(values_ext[b]) for b in plan.slot_buckets)
    return (jnp.asarray(plan.inv_perm), buckets)


@jax.custom_vjp
def gather_sum_composed(x, fwd_ops, bwd_ops):
    """out[r] = sum over the r-th segment's slots of x[idx_slot], with
    slot->row indices composed on the host (`composed_operands`).

    `x` is [N, F] with row N reserved implicitly as zero (indices equal
    to N hit the appended zero row). `fwd_ops` aggregates by segment;
    `bwd_ops` is the TRANSPOSE structure (slots grouped by the gathered
    row, destination rows composed in) so the VJP is also one gather:
    dx[s] = sum over slots sourced at s of g[dst_slot].
    """
    del bwd_ops
    return _gather_sum_impl(x, fwd_ops)


def _gather_sum_impl(x, ops):
    inv_perm, buckets = ops
    tail = x.shape[1:]
    flat = x.reshape(x.shape[0], -1)
    f = flat.shape[1]
    ext = jnp.concatenate([flat, jnp.zeros((1, f), flat.dtype)], axis=0)
    parts = [
        ext[b.reshape(-1)].reshape(*b.shape, -1).sum(axis=1)
        for b in buckets
    ]
    parts.append(jnp.zeros((1, f), flat.dtype))
    out = jnp.concatenate(parts, axis=0)[inv_perm]
    return out.reshape((out.shape[0],) + tail)


def _gather_sum_fwd(x, fwd_ops, bwd_ops):
    return _gather_sum_impl(x, fwd_ops), (fwd_ops, bwd_ops, x.shape[0])


def _gather_sum_bwd(res, g):
    fwd_ops, bwd_ops, n_rows = res
    dx = _gather_sum_impl(g, bwd_ops)
    # the transpose structure covers n_rows source rows by construction
    assert dx.shape[0] == n_rows, (dx.shape, n_rows)

    def f0(a):
        if jnp.issubdtype(a.dtype, jnp.inexact):
            return jnp.zeros_like(a)
        return np.zeros(a.shape, jax.dtypes.float0)

    return (dx,
            jax.tree_util.tree_map(f0, fwd_ops),
            jax.tree_util.tree_map(f0, bwd_ops))


gather_sum_composed.defvjp(_gather_sum_fwd, _gather_sum_bwd)

"""XLA-compiled 2nd-order (node2vec) biased random walks.

The reference has two walk engines with the same sampling semantics: a pure
Python one (`node2vec/src/node2vec.py:13-53` — per-node and per-directed-edge
alias tables, drawn with `alias_draw`) and a distributed Scala/Spark one
(`node2vec_spark/.../Node2vec.scala:87-138` — one cluster-wide RDD join per
walk step). This module is the on-device redesign:

- Alias tables are built **once on the host** over the padded ELL neighbor
  matrix (`AliasTables.build`), exactly reproducing `alias_setup`
  (`node2vec.py:107-137`) per row, including the p/q edge bias of
  `get_alias_edge` (`node2vec.py:55-74`).
- The walk itself is a single jit-compiled `lax.scan` over steps, vmapped
  over all walkers at once — every step is one gather + one alias draw on
  device, no host round-trips. Walker state carries the *directed edge id*
  of the last hop, so the 2nd-order edge table lookup is a plain row gather.

Multi-device scaling shards the walker axis (see
`linkpred.parallel.walks`), the mesh analog of Spark's partitioned
frontier (`Node2vec.scala:103-124`).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from linkpred.data.graph import Graph


def alias_setup_rows(probs: np.ndarray, valid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized-over-rows alias construction.

    `probs` [R, D] rows of (unnormalized) probabilities, `valid` [R, D] bool.
    Returns (J [R, D] int32, q [R, D] float32) such that drawing slot
    `k ~ U{0..deg-1}` and accepting `k` with prob `q[k]` (else jumping to
    `J[k]`) samples slot k with probability probs[k]/sum(probs) — the alias
    method of reference `node2vec.py:107-137`.
    """
    R, D = probs.shape
    J = np.zeros((R, D), dtype=np.int32)
    q = np.zeros((R, D), dtype=np.float32)
    deg = valid.sum(axis=1)
    for r in range(R):
        K = int(deg[r])
        if K == 0:
            continue
        p = probs[r, :K].astype(np.float64)
        s = p.sum()
        if s <= 0:
            p = np.ones(K) / K
        else:
            p = p / s
        qr = K * p
        Jr = np.zeros(K, dtype=np.int64)
        smaller = [k for k in range(K) if qr[k] < 1.0]
        larger = [k for k in range(K) if qr[k] >= 1.0]
        while smaller and larger:
            small, large = smaller.pop(), larger.pop()
            Jr[small] = large
            qr[large] = qr[large] + qr[small] - 1.0
            if qr[large] < 1.0:
                smaller.append(large)
            else:
                larger.append(large)
        J[r, :K] = Jr
        q[r, :K] = qr
    return J, q


@dataclasses.dataclass(frozen=True)
class AliasTables:
    """Per-node (1st step) and per-directed-edge (2nd-order) alias tables.

    node_J/node_q: [N, D] over each node's neighbor slots.
    edge_J/edge_q: [E, D] — row e is the table over `nbr[dst_of_e]` slots,
    biased by p (return) / q (in-out) exactly as `get_alias_edge`
    (reference `node2vec.py:55-74`).
    """

    node_J: np.ndarray
    node_q: np.ndarray
    edge_J: np.ndarray
    edge_q: np.ndarray

    @staticmethod
    def build(g: Graph, p: float = 1.0, q: float = 1.0) -> "AliasTables":
        from linkpred import native

        N, D = g.nbr.shape
        w = (
            g.nbr_weight.astype(np.float64)
            if g.nbr_weight is not None
            else g.nbr_mask.astype(np.float64)  # unweighted: weight 1/edge
        )
        node_J, node_q = native.build_alias_rows(w, g.nbr_mask)

        if p == 1.0 and q == 1.0 and g.nbr_weight is None:
            # 1st-order unweighted walk: every edge table equals the dst
            # node table.
            edge_J = node_J[g.dst]
            edge_q = node_q[g.dst]
            return AliasTables(node_J, node_q, edge_J, edge_q)

        valid = g.nbr_mask[g.dst]
        if native.available():
            # C++ path: binary-search membership over CSR rows, threaded;
            # edge weights (when present) scale the bias in the same pass,
            # so weighted graphs share the unweighted scale ceiling
            probs = native.edge_bias_probs(
                g.src, g.dst, g.nbr, g.nbr_mask, g.indptr, g.indices, p, q,
                nbr_weight=g.nbr_weight,
            )
        else:
            # numpy fallback: dense has-edge lookup (fine up to ~20k nodes);
            # weighted graphs scale the bias by the edge weight like the
            # reference's `get_alias_edge` (`node2vec.py:55-74`)
            has_edge = g.has_edge_matrix()
            nbrs = g.nbr[g.dst]  # [E, D]
            pe = np.where(
                nbrs == g.src[:, None],
                1.0 / p,
                np.where(has_edge[nbrs, g.src[:, None]], 1.0, 1.0 / q),
            )
            probs = np.where(valid, pe, 0.0)
            if g.nbr_weight is not None:
                probs = probs * g.nbr_weight[g.dst]
        edge_J, edge_q = native.build_alias_rows(probs, valid)
        return AliasTables(node_J, node_q, edge_J, edge_q)


def _alias_draw_batch(key, J_rows, q_rows, deg):
    """Vectorized alias draw: J_rows/q_rows [W, D], deg [W] -> slots [W]."""
    w = deg.shape[0]
    u = jax.random.uniform(key, (2, w))
    kk = jnp.minimum((u[0] * deg).astype(jnp.int32), jnp.maximum(deg - 1, 0))
    take = jnp.take_along_axis  # gather chosen slot per row
    qk = take(q_rows, kk[:, None], axis=1)[:, 0]
    jk = take(J_rows, kk[:, None], axis=1)[:, 0]
    return jnp.where(u[1] < qk, kk, jk)


@partial(jax.jit, static_argnames=("walk_length",))
def simulate_walks(
    key: jax.Array,
    starts: jnp.ndarray,
    nbr: jnp.ndarray,
    indptr: jnp.ndarray,
    degree: jnp.ndarray,
    node_J: jnp.ndarray,
    node_q: jnp.ndarray,
    edge_J: jnp.ndarray,
    edge_q: jnp.ndarray,
    walk_length: int,
) -> jnp.ndarray:
    """Batched biased walks: returns int32 [num_starts, walk_length].

    One `lax.scan` over steps with all walkers advancing together — each
    step is a handful of batched gathers on device (the frontier-advance
    that Spark does with a cluster-wide join per step,
    `Node2vec.scala:103-124`). Walkers at degree-0 nodes stay in place (the
    reference truncates the walk, `node2vec.py:34-35`; a stalled walker
    produces the same skip-gram pairs as a truncated one when the pair
    generator masks self-pairs).
    """
    starts = starts.astype(jnp.int32)

    # first hop: per-node alias tables
    k0, krest = jax.random.split(key)
    deg0 = degree[starts]
    slot0 = _alias_draw_batch(k0, node_J[starts], node_q[starts], deg0)
    stalled0 = deg0 == 0
    cur = jnp.where(stalled0, starts, nbr[starts, slot0])
    eid = jnp.where(stalled0, 0, indptr[starts] + slot0)

    def step(carry, k):
        cur, eid, stalled = carry
        deg = degree[cur]
        slot = _alias_draw_batch(k, edge_J[eid], edge_q[eid], deg)
        stop = stalled | (deg == 0)
        nxt = jnp.where(stop, cur, nbr[cur, slot])
        new_eid = jnp.where(stop, eid, indptr[cur] + slot)
        return (nxt, new_eid, stop), nxt

    if walk_length > 2:
        step_keys = jax.random.split(krest, walk_length - 2)
        _, rest = jax.lax.scan(step, (cur, eid, stalled0), step_keys)
        return jnp.concatenate(
            [starts[None, :], cur[None, :], rest], axis=0
        ).T
    return jnp.stack([starts, cur], axis=1)


class WalkEngine:
    """Convenience wrapper: build tables from a Graph, run walks on device.

    Equivalent public surface to reference `node2vec.Graph` +
    `simulate_walks(num_walks, walk_length)` (`node2vec.py:39-53`): each of
    the `num_walks` rounds starts one walk from every node (shuffling start
    order is irrelevant here since all walks run in parallel).
    """

    def __init__(self, g: Graph, p: float = 1.0, q: float = 1.0):
        self.graph = g
        tables = AliasTables.build(g, p=p, q=q)
        self.nbr = jnp.asarray(g.nbr)
        self.indptr = jnp.asarray(g.indptr[:-1])
        self.degree = jnp.asarray(g.degree)
        self.node_J = jnp.asarray(tables.node_J)
        self.node_q = jnp.asarray(tables.node_q)
        self.edge_J = jnp.asarray(tables.edge_J)
        self.edge_q = jnp.asarray(tables.edge_q)

    def walks(self, key: jax.Array, num_walks: int, walk_length: int) -> jnp.ndarray:
        """[num_walks * N, walk_length] int32 walk matrix."""
        n = self.graph.num_nodes
        starts = jnp.tile(jnp.arange(n, dtype=jnp.int32), num_walks)
        return simulate_walks(
            key,
            starts,
            self.nbr,
            self.indptr,
            self.degree,
            self.node_J,
            self.node_q,
            self.edge_J,
            self.edge_q,
            walk_length,
        )

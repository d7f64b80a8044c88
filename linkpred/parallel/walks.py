"""Sharded random-walk generation — the mesh analog of Spark node2vec.

The reference's distributed walks shuffle the whole walk frontier through
an RDD `join` against edge attributes once per step
(`node2vec_spark/.../Node2vec.scala:103-124`, 200 partitions). Two regimes:

- **Replicated tables, sharded walkers** (`sharded_walks`): alias tables
  and the neighbor matrix are the broadcast variables of
  `Node2vec.scala:32-35`; the walker axis is sharded across every device
  and each step is purely local gathers — zero collectives. The
  speed-of-light layout whenever the tables fit one device's memory
  (fb-pages-food through ogbl-collab scale).
- **Sharded tables, routed frontier** (`TableShardedWalker`): for graphs
  whose ELL + alias tables exceed one device, the node blocks (and their
  edge-table rows) are partitioned over a mesh axis and the walker
  frontier is ROUTED to the owner of its current node each step with one
  `lax.all_to_all` — exactly the per-step frontier join of
  `Node2vec.scala:103-124`, over the device interconnect instead of an
  RDD shuffle.

The table-sharded step needs every lookup to be owner-local. Key trick:
the 2nd-order alias table of directed edge e=(u -> v) (drawn when standing
at v having arrived from u, reference `node2vec.py:55-74`) is re-keyed on
the host by the REVERSE edge id rev(e)=(v -> u), which lives in v's CSR row
range — so a walker standing at v carries `rev` and finds its table, its
neighbor row, and the next hop's carried key (`rev_next[f] = rev(f)` for
the chosen edge f=(v -> w), stored at owner(v)) all in the local shard.
Requires a symmetric (undirected-doubled) edge set.

Routing uses per-destination buckets of static capacity
(`capacity_per_dest`); walkers beyond a bucket's capacity in one step are
dropped and counted (returned as `overflow` — zero in every measured
workload at the default 2x-mean capacity; raise it for adversarially
skewed frontiers).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from linkpred.data.graph import Graph
from linkpred.ops.walk import AliasTables, WalkEngine, simulate_walks


def sharded_walks(
    mesh: Mesh,
    engine: WalkEngine,
    key: jax.Array,
    num_walks: int,
    walk_length: int,
) -> jnp.ndarray:
    """Run `num_walks` walks from every node with the walker axis sharded
    over the whole mesh. Returns [num_walks * N, walk_length] int32."""
    n = engine.graph.num_nodes
    total = num_walks * n
    axis_sizes = [mesh.shape[a] for a in mesh.axis_names]
    n_dev = 1
    for s in axis_sizes:
        n_dev *= s
    pad = (-total) % n_dev
    starts = jnp.tile(jnp.arange(n, dtype=jnp.int32), num_walks)
    starts = jnp.pad(starts, (0, pad))  # padded walkers start at node 0

    walker_sharding = NamedSharding(mesh, P(tuple(mesh.axis_names)))
    repl = NamedSharding(mesh, P())
    starts = jax.device_put(starts, walker_sharding)
    tables = [
        jax.device_put(a, repl)
        for a in (
            engine.nbr, engine.indptr, engine.degree,
            engine.node_J, engine.node_q, engine.edge_J, engine.edge_q,
        )
    ]
    out = simulate_walks(key, starts, *tables, walk_length)
    return out[: total]


# ---------------------------------------------------------------------------
# table-sharded regime
# ---------------------------------------------------------------------------


def _reverse_edge_ids(g: Graph) -> np.ndarray:
    """rev[e] = edge id of (dst_e -> src_e). Edges are CSR-sorted by
    (src, dst), so ids resolve with one searchsorted. Requires every
    reverse edge to exist (undirected-doubled edge sets)."""
    n = np.int64(g.num_nodes)
    key = g.src.astype(np.int64) * n + g.dst.astype(np.int64)
    rev_key = g.dst.astype(np.int64) * n + g.src.astype(np.int64)
    rev = np.searchsorted(key, rev_key)
    if not (key[rev] == rev_key).all():
        raise ValueError("table-sharded walks need a symmetric edge set")
    return rev.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class TableShardedWalker:
    """Host-built sharded table layout + the routed-frontier walk program.

    Per shard k (node block [k*rows, (k+1)*rows)): its ELL rows, degrees,
    global CSR offsets, node alias tables, and the edge-table rows REKEYED
    by reverse id (see module docstring), padded to the max shard edge
    count. All lookups during a step are local to the owner shard; one
    int32 `all_to_all` per step moves the frontier.
    """

    num_nodes: int
    rows: int  # nodes per shard
    n_shards: int
    nbr: np.ndarray  # [S, rows, D]
    degree: np.ndarray  # [S, rows]
    indptr: np.ndarray  # [S, rows] global edge-id offset of each node
    node_J: np.ndarray  # [S, rows, D]
    node_q: np.ndarray  # [S, rows, D] f32
    edge_J2: np.ndarray  # [S, e_cap, D] rekeyed by reverse id
    edge_q2: np.ndarray  # [S, e_cap, D] f32
    rev_next: np.ndarray  # [S, e_cap] rev(e) per locally-owned edge e
    edge_start: np.ndarray  # [S] global edge-id offset of each shard

    @staticmethod
    def build(g: Graph, n_shards: int, p: float = 1.0, q: float = 1.0
              ) -> "TableShardedWalker":
        tables = AliasTables.build(g, p=p, q=q)
        rev = _reverse_edge_ids(g)
        n, d = g.nbr.shape
        rows = -(-n // n_shards)

        # rekey: the table for edge e=(u->v) is stored at slot rev(e),
        # which lies in v's CSR range — the owner a walker standing at v
        # is routed to
        edge_J2 = np.zeros_like(tables.edge_J)
        edge_q2 = np.zeros_like(tables.edge_q)
        edge_J2[rev] = tables.edge_J
        edge_q2[rev] = tables.edge_q

        node_pad = rows * n_shards - n
        def pad_nodes(a, fill=0):
            w = ((0, node_pad),) + ((0, 0),) * (a.ndim - 1)
            return np.pad(a, w, constant_values=fill)

        nbr_s = pad_nodes(g.nbr).reshape(n_shards, rows, d)
        deg_s = pad_nodes(g.degree).reshape(n_shards, rows)
        indptr_s = pad_nodes(g.indptr[:-1]).reshape(n_shards, rows)
        nodeJ_s = pad_nodes(tables.node_J).reshape(n_shards, rows, d)
        nodeq_s = pad_nodes(tables.node_q).reshape(n_shards, rows, d)

        # edge rows: contiguous CSR ranges per node block, padded to max
        bounds = g.indptr[np.minimum(np.arange(n_shards + 1) * rows, n)]
        e_cap = max(int(np.diff(bounds).max()), 1)
        eJ = np.zeros((n_shards, e_cap, d), tables.edge_J.dtype)
        eq = np.zeros((n_shards, e_cap, d), tables.edge_q.dtype)
        rv = np.zeros((n_shards, e_cap), np.int32)
        for k in range(n_shards):
            lo, hi = int(bounds[k]), int(bounds[k + 1])
            eJ[k, : hi - lo] = edge_J2[lo:hi]
            eq[k, : hi - lo] = edge_q2[lo:hi]
            rv[k, : hi - lo] = rev[lo:hi]
        return TableShardedWalker(
            num_nodes=n, rows=rows, n_shards=n_shards,
            nbr=nbr_s, degree=deg_s, indptr=indptr_s,
            node_J=nodeJ_s, node_q=nodeq_s,
            edge_J2=eJ, edge_q2=eq, rev_next=rv,
            edge_start=bounds[:-1].astype(np.int32),
        )

    def walks(
        self,
        mesh: Mesh,
        key: jax.Array,
        num_walks: int,
        walk_length: int,
        axis: str = "edge",
        capacity_per_dest: int | None = None,
    ) -> tuple[np.ndarray, int]:
        """[num_walks * N, walk_length] int32 walks + dropped-walker count.

        One `all_to_all` per step routes the frontier to owner shards
        (the Spark join, `Node2vec.scala:103-124`). Output row order
        matches `WalkEngine.walks` (walk r of node v at row r*N + v)."""
        S = self.n_shards
        assert mesh.shape[axis] == S, (mesh.shape, S)
        n = self.num_nodes
        total = num_walks * n
        starts = np.tile(np.arange(n, dtype=np.int32), num_walks)
        owners = starts // self.rows
        # default: 4x the mean per-destination load plus fixed headroom —
        # absorbs hub-node skew on small graphs; tune down at scale where
        # the frontier is statistically flat (overflow is reported)
        cap = capacity_per_dest or (4 * (-(-total // S) // S) + 16)
        C = S * cap  # per-device walker buffer

        # place walkers in their start-owner's buffer (host side)
        buf = np.full((S, C, 4 + walk_length), -1, dtype=np.int32)
        fill = np.zeros(S, dtype=np.int64)
        dropped_init = 0
        for wid, (s0, o) in enumerate(zip(starts, owners)):
            i = fill[o]
            if i >= C:
                dropped_init += 1
                continue
            buf[o, i, 0] = s0  # cur
            buf[o, i, 1] = -1  # rev (-1 = first hop, node table)
            buf[o, i, 2] = 1  # alive
            buf[o, i, 3] = wid
            buf[o, i, 4] = s0  # traj[0]
            fill[o] += 1

        out_traj, out_ids, overflow = _routed_walk(
            mesh, axis, jnp.asarray(buf), key,
            jnp.asarray(self.nbr), jnp.asarray(self.degree),
            jnp.asarray(self.indptr),
            jnp.asarray(self.node_J), jnp.asarray(self.node_q),
            jnp.asarray(self.edge_J2), jnp.asarray(self.edge_q2),
            jnp.asarray(self.rev_next), jnp.asarray(self.edge_start),
            walk_length, self.rows,
        )
        traj = np.asarray(out_traj).reshape(-1, walk_length)
        ids = np.asarray(out_ids).reshape(-1)
        walks = np.zeros((total, walk_length), dtype=np.int32)
        got = ids >= 0
        walks[ids[got]] = traj[got]
        missing = total - int(got.sum()) + dropped_init
        return walks, int(np.asarray(overflow)) + missing


def _route(dest, payload, cap, S, axis):
    """Bucket `payload` rows by `dest` shard (capacity `cap` per bucket),
    all_to_all over `axis`, return (new payload [S*cap, Pw], dropped)."""
    C = dest.shape[0]
    alive = payload[:, 2] > 0
    dest = jnp.where(alive, dest, S)  # dead walkers route nowhere
    oh = (dest[:, None] == jnp.arange(S)[None, :]).astype(jnp.int32)
    rank = (jnp.cumsum(oh, axis=0) - oh)[jnp.arange(C), jnp.minimum(dest, S - 1)]
    over = alive & (rank >= cap)
    slot = jnp.where(alive & ~over, dest * cap + rank, S * cap)
    send = jnp.full((S * cap + 1, payload.shape[1]), -1, payload.dtype)
    send = send.at[slot].set(payload)[: S * cap]
    send = send.reshape(S, cap, payload.shape[1])
    recv = jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0,
                              tiled=False)
    return recv.reshape(S * cap, payload.shape[1]), over.sum()


def _make_routed_step(axis, rows, cap, S):
    def step(carry, t):
        (payload, key, dropped,
         nbr, deg, indptr, nJ, nq, eJ2, eq2, rev_next, e_start) = carry
        k = jax.random.fold_in(key, t)
        me = jax.lax.axis_index(axis)
        C = payload.shape[0]
        cur = payload[:, 0]
        rev = payload[:, 1]
        alive = payload[:, 2] > 0

        cur_l = jnp.clip(cur - me * rows, 0, rows - 1)
        rev_l = jnp.clip(rev - e_start[me], 0, eJ2.shape[0] - 1)
        first = rev < 0
        J = jnp.where(first[:, None], nJ[cur_l], eJ2[rev_l])
        q = jnp.where(first[:, None], nq[cur_l], eq2[rev_l])
        d = deg[cur_l]

        u = jax.random.uniform(k, (2, C))
        kk = jnp.minimum((u[0] * d).astype(jnp.int32), jnp.maximum(d - 1, 0))
        take = jnp.take_along_axis
        qk = take(q, kk[:, None], axis=1)[:, 0]
        jk = take(J, kk[:, None], axis=1)[:, 0]
        slot = jnp.where(u[1] < qk, kk, jk)

        stalled = d == 0
        nxt = jnp.where(stalled, cur, take(nbr[cur_l], slot[:, None], axis=1)[:, 0])
        eid_l = jnp.clip(indptr[cur_l] - e_start[me] + slot, 0,
                         rev_next.shape[0] - 1)
        new_rev = jnp.where(stalled, rev, rev_next[eid_l])

        traj = payload[:, 4:]
        traj = jax.lax.dynamic_update_slice(traj, nxt[:, None], (0, t))
        payload = jnp.concatenate(
            [nxt[:, None], new_rev[:, None], payload[:, 2:4], traj], axis=1
        )
        dest = nxt // rows
        payload, over = _route(dest, payload, cap, S, axis)
        carry = (payload, key, dropped + over,
                 nbr, deg, indptr, nJ, nq, eJ2, eq2, rev_next, e_start)
        return carry, None

    return step


@partial(jax.jit, static_argnames=("mesh", "axis", "walk_length", "rows"))
def _routed_walk(mesh, axis, buf, key, nbr, deg, indptr, nJ, nq,
                 eJ2, eq2, rev_next, e_start, walk_length: int, rows: int):
    S = mesh.shape[axis]
    cap = buf.shape[1] // S
    spec = P(axis)
    rep = P()

    def local(buf_l, key, nbr, deg, indptr, nJ, nq, eJ2, eq2, rev_next,
              e_start):
        payload = buf_l[0]
        step = _make_routed_step(axis, rows, cap, S)
        carry = (payload, key, jnp.zeros((), jnp.int32),
                 nbr[0], deg[0], indptr[0], nJ[0], nq[0],
                 eJ2[0], eq2[0], rev_next[0], e_start)
        carry, _ = jax.lax.scan(
            step, carry, jnp.arange(1, walk_length, dtype=jnp.int32)
        )
        payload, dropped = carry[0], carry[2]
        # dead rows never route; their ids stay -1
        return (payload[None, :, 4:], payload[None, :, 3],
                jax.lax.psum(dropped, axis)[None])

    in_specs = (spec, rep) + (spec,) * 8 + (rep,)
    out_specs = (spec, spec, spec)
    fn = shard_map(local, mesh=mesh, in_specs=in_specs,
                   out_specs=out_specs, check_vma=False)
    traj, ids, over = fn(buf, key, nbr, deg, indptr, nJ, nq, eJ2, eq2,
                         rev_next, e_start)
    return traj, ids, over[0]

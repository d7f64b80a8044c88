"""Halo-exchange node-sharded SpMM: collective traffic ∝ edge-cut, not N.

The node-sharded designs of `parallel.spmm_shard` either keep the
feature matrix replicated or all-gather the full [N, F] per layer — an
O(N·F) per-layer collective regardless of partition quality. This module
carries the actual Spark behavioral contract — the walk step exchanges
only the *frontier* each step (`Node2vec.scala:103-124`), i.e. only data
the consumer actually needs — to feature aggregation:

1. **Locality-aware ordering** (host): nodes are re-ordered by reverse
   Cuthill-McKee over the symmetrized adjacency, so contiguous row blocks
   have most of their edges inside the block and the block-to-block
   edge cut (the halo) is small.
2. **Ghost-row index** (host): for every shard pair (j → k), the sorted
   unique rows owned by j that k's edges reference. Padded to the max
   pair capacity C so shapes are static.
3. **Boundary-only exchange** (device): each shard gathers its send rows
   into an [S, C, F] buffer and one `lax.all_to_all` delivers every
   shard exactly the ghost rows it needs — `S*C*F*dtype` bytes per
   device per layer, proportional to the edge cut. Local aggregation is
   the scatter-free bucketed-ELL gather+einsum over [local block ‖ ghosts].

`spmm_halo_sym` adds the symmetric-adjacency custom VJP (same kernel in
the backward pass — relabeling preserves symmetry), so end-to-end
training runs both directions at aggregation-kernel speed, like
`spmm_node_sharded_sym`, but with cut-proportional collectives.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


def _label_prop_clusters(src, dst, n, rounds: int = 15,
                         seed: int = 0) -> np.ndarray:
    """Vectorized label propagation: each round, a sampled subset of
    nodes adopts the most frequent label among its neighbors (ties ->
    smallest label via the stable sort). Partial asynchronous updates
    (70%% of nodes per round) avoid the 2-coloring oscillation of fully
    synchronous propagation. O(E log E) numpy work per round — the host
    partitioner behind `HaloLayout`'s cluster ordering."""
    rng = np.random.default_rng(seed)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    labels = np.arange(n, dtype=np.int64)
    for _ in range(rounds):
        key = src * n + labels[dst]
        order = np.argsort(key, kind="stable")
        ks = key[order]
        starts = np.flatnonzero(np.r_[True, np.diff(ks) != 0])
        counts = np.diff(np.r_[starts, len(ks)])
        run_src = ks[starts] // n
        run_lab = ks[starts] % n
        # per src, the run with the max count (lexsort: last wins)
        o2 = np.lexsort((counts, run_src))
        rs = run_src[o2]
        last = np.r_[np.flatnonzero(np.diff(rs) != 0), len(rs) - 1]
        best_src = rs[last]
        best_lab = run_lab[o2][last]
        upd = rng.random(len(best_src)) < 0.7
        new_labels = labels.copy()
        new_labels[best_src[upd]] = best_lab[upd]
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
    return labels


@dataclasses.dataclass(frozen=True)
class HaloLayout:
    """Host-built layout for `spmm_halo` (module docstring).

    All node ids in `stacked` are LOCAL to their shard: [0, rows) is the
    shard's own block, [rows, rows + S*C) addresses the ghost area
    (shard j's rows at offset rows + j*C), and [rows + S*C,
    rows + S*C + S*H) the replicated HUB area (owner j's hub rows at
    offset rows + S*C + j*H). The graph is RELABELED by `order` (new id
    i == old node `order[i]`); callers must map node-id inputs through
    `inv_perm` (old → new) and outputs back via `order`.

    **Hub replication**: rows referenced by >= `hub_min_refs` OTHER
    shards can leave the pairwise exchange and be delivered by ONE
    `all_gather` of each owner's hub rows — O(H*F) bytes per device,
    bandwidth-optimal on a ring, independent of reader fan-out.
    Measured honestly (tests/test_halo.py): at S=8 on undirected graphs
    this is near-BREAKEVEN in volume (a row read by r <= S-1 shards
    costs r pairwise copies vs S all_gather copies), so the `"auto"`
    rule scores each threshold on delivered rows `S*(C + H_cap)` and
    usually keeps replication off; it pays off when per-pair capacity
    is IMBALANCED (one hot pair inflates the padding all pairs share)
    or at larger S. The measured power-law fix is instead the
    `"balance"` ordering + the cost-based ordering auto-pick in
    `build` (a 9x per-shard edge imbalance and 5.5x padded-slot waste at
    collab scale made load balance, not byte compression, the fix).
    """

    num_nodes: int
    n_shards: int
    rows_per_shard: int
    ghost_capacity: int  # C = max non-hub rows any shard needs from any other
    order: np.ndarray  # [N] new position -> old node id (RCM order)
    inv_perm: np.ndarray  # [N] old node id -> new position
    send_idx: np.ndarray  # [S, S, C] shard-local rows j sends to k
    # per bucket: (ids [S, m], nbr_local [S, m, w], wgt [S, m, w])
    stacked: tuple
    pad_rows: int  # max bucket rows (diagnostic; the kernel's
    # output assembly is the out_inv gather)
    edge_cut: int  # directed edges crossing shard blocks (diagnostic)
    hub_capacity: int = 0  # H = max hub rows owned by any one shard
    # [S, H] shard-local positions of each owner's hub rows (pad 0)
    hub_send: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((1, 1), np.int32))
    num_hubs: int = 0  # total replicated rows (diagnostic)
    # [S, rows] local row -> position in the concat of bucket aggregates
    # (scatter-free output assembly; uncovered rows -> the zero row)
    out_inv: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((1, 1), np.int32))

    def collective_bytes_per_layer(self, feats: int, dtype_bytes: int = 4):
        """Collective payload per device per aggregation: the pairwise
        ghost all_to_all plus the hub all_gather receive volume."""
        a2a = self.n_shards * self.ghost_capacity * feats * dtype_bytes
        ag = self.n_shards * self.hub_capacity * feats * dtype_bytes
        return a2a + ag

    @staticmethod
    def build(g, n_shards: int,
              reorder: bool | str = True,
              hub_min_refs: "int | None | str" = "auto",
              hub_budget: int | None = None,
              feats_hint: int = 128) -> "HaloLayout":
        """Build from a `data.graph.Graph`.

        `hub_min_refs`: rows referenced by at least this many OTHER
        shards are replicated via the hub all_gather instead of riding
        the pairwise ghost exchange (None disables replication).
        `"auto"` (default) evaluates the candidate thresholds on the
        exchange-volume cost `S*ghost_cap + S*hub_cap` (rows delivered
        per device per layer — replication costs S deliveries per hub,
        so low-fan-out rows must NOT be replicated) and keeps the
        cheapest, which on locality-rich graphs is usually None.
        `hub_budget` caps the hub count (highest-fan-out rows win).

        `reorder` picks the ordering:
        - `True` (default): build the candidate layouts below and keep
          the one minimizing a per-layer COST = padded aggregation-slot
          traffic + collective bytes (at `feats_hint` features). Cut
          alone is the wrong objective on hub-heavy graphs: a block
          partition of a power-law graph leaves one shard with ~9x the
          edges and every shard padding its buckets to the hub shard's
          sizes (measured 5.5x padded-slot waste at collab scale) — so
          load balance must be in the objective.
        - `"cluster"`: label-propagation community detection, nodes
          ordered cluster-contiguously — the min-cut objective; on
          community graphs with scrambled labels this rediscovers the
          blocks.
        - `"rcm"`: reverse Cuthill-McKee (bandwidth objective — wins on
          banded/mesh-like graphs, poor at shuffled communities).
        - `"balance"`: degree-sorted snake striping — every shard gets
          the same degree profile, so per-shard edges and bucket sizes
          equalize (padding waste -> ~1x) at the price of zero
          locality. The right regime for structureless hub graphs,
          where the cut saturates no matter the order and hub
          replication + all_gather carry the exchange.
        - `False`: keep input order (A/B baseline).
        """
        n = g.num_nodes

        def rcm_order():
            import scipy.sparse as sp
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            ones = np.ones(len(g.src), np.int8)
            a = sp.csr_matrix((ones, (g.src, g.dst)), shape=(n, n))
            return np.asarray(
                reverse_cuthill_mckee(a + a.T, symmetric_mode=True),
                dtype=np.int64)

        def cluster_order():
            labels = _label_prop_clusters(g.src, g.dst, n)
            # cluster-contiguous; at most S-1 clusters straddle a block
            # boundary, so cut ≈ inter-cluster edges
            return np.argsort(labels, kind="stable").astype(np.int64)

        def balance_order():
            # degree-desc snake deal: node ranked r goes to shard
            # snake(r % 2S) — each shard's degree profile is a uniform
            # sample of the whole graph's
            deg = np.asarray(g.nbr_mask.sum(axis=1))
            ranked = np.argsort(deg, kind="stable")[::-1]
            lane = np.arange(len(ranked)) % (2 * n_shards)
            shard = np.where(lane < n_shards, lane, 2 * n_shards - 1 - lane)
            order_ = np.concatenate(
                [ranked[shard == s] for s in range(n_shards)])
            return order_.astype(np.int64)

        def build_one(order_):
            return HaloLayout._build_for_order(
                g, order_, n_shards, hub_min_refs, hub_budget)

        def cost_of(lay: "HaloLayout"):
            # per-layer, per-device: padded einsum slots read+write F
            # floats each; a collectively-delivered byte is ~10x a
            # locally-read byte (measured on the 8-device host mesh:
            # 143 ns/slot local vs 747 ns/row exchanged at F=128 —
            # 0.14 vs 1.46 ns/byte; a real interconnect is cheaper, but
            # never cheaper than a local read)
            slots = sum(
                lay.stacked[i + 1].shape[1] * lay.stacked[i + 1].shape[2]
                for i in range(0, len(lay.stacked), 3))
            return (slots * feats_hint * 4 * 2
                    + 10 * lay.collective_bytes_per_layer(feats_hint))

        if reorder == "rcm":
            return build_one(rcm_order())
        if reorder == "cluster":
            return build_one(cluster_order())
        if reorder == "balance":
            return build_one(balance_order())
        if not reorder:
            return build_one(np.arange(n, dtype=np.int64))
        return min((build_one(cluster_order()), build_one(rcm_order()),
                    build_one(balance_order())), key=cost_of)

    @staticmethod
    def _build_for_order(g, order, n_shards, hub_min_refs, hub_budget,
                         allow_redeal: bool = True):
        from linkpred.ops.spmm import BucketedEll

        n = g.num_nodes
        inv = np.empty(n, dtype=np.int64)
        inv[order] = np.arange(n)

        # relabeled ELL views
        nbr = inv[g.nbr[order]].astype(np.int32)
        mask = g.nbr_mask[order]
        wgt = g.nbr_weight[order] if g.nbr_weight is not None else None

        rows = -(-n // n_shards)
        owner_of = lambda ids: ids // rows  # noqa: E731

        # pass 1: raw ghost needs per (receiver k, owner j) + per-row
        # reader fan-out (how many other shards reference each row)
        need = [[None] * n_shards for _ in range(n_shards)]
        cut = 0
        refs = np.zeros(n, np.int32)
        for k in range(n_shards):
            lo, hi = k * rows, min((k + 1) * rows, n)
            ids = nbr[lo:hi][mask[lo:hi]]
            own = owner_of(ids)
            cut += int((own != k).sum())
            for j in range(n_shards):
                if j == k:
                    continue
                uniq = np.unique(ids[own == j])
                need[k][j] = uniq
                refs[uniq] += 1

        # hub selection (class docstring): high-fan-out rows leave the
        # pairwise exchange and are replicated by one all_gather
        def hub_set(mr):
            is_h = np.zeros(n, bool)
            if n_shards > 1 and mr is not None:
                cand = np.flatnonzero(refs >= mr)
                if hub_budget is not None and len(cand) > hub_budget:
                    top = np.argsort(
                        refs[cand], kind="stable")[::-1][:hub_budget]
                    cand = cand[top]
                is_h[cand] = True
            return is_h

        def volume(is_h):
            # rows delivered per device per layer: the pairwise exchange
            # pads to the MAX residual need; every hub costs one
            # all_gather row on each of the S devices. Hub ownership is
            # re-dealt round-robin below, so score the balanced
            # hub_cap ~ ceil(H / S), not the pre-redeal concentration.
            cap_ = 1
            for k in range(n_shards):
                for j in range(n_shards):
                    if j != k:
                        cap_ = max(cap_, int((~is_h[need[k][j]]).sum()))
            hc = max(1, -(-int(is_h.sum()) // n_shards))
            return n_shards * (cap_ + hc)

        if hub_min_refs == "auto":
            cands = [None] + list(range(2, max(n_shards, 3)))
            is_hub = min((hub_set(mr) for mr in cands), key=volume)
        else:
            is_hub = hub_set(hub_min_refs)
        num_hubs = int(is_hub.sum())

        # ownership re-deal: a locality ordering tends to CONCENTRATE the
        # hubs (they form their own cluster), making one shard own nearly
        # all of them — hub_cap, and with it the all_gather payload, stays
        # at the concentrated max. Replicated rows are read from the hub
        # area, never from their owner's block, so ownership placement is
        # free: deal the hub rows round-robin across blocks (non-hub
        # locality order preserved as the fill) and rebuild once.
        if num_hubs and allow_redeal:
            owned = [int(is_hub[j * rows: (j + 1) * rows].sum())
                     for j in range(n_shards)]
            ideal = -(-num_hubs // n_shards)
            if max(owned) > ideal + max(2, ideal // 4):
                hub_new = np.flatnonzero(is_hub)
                non_new = np.flatnonzero(~is_hub)
                blocks, ptr = [], 0
                for b in range(n_shards):
                    hb = hub_new[b::n_shards]
                    take = rows - len(hb)
                    blocks.append(
                        np.concatenate([hb, non_new[ptr:ptr + take]]))
                    ptr += take
                perm2 = np.concatenate(blocks)[:n]
                return HaloLayout._build_for_order(
                    g, order[perm2], n_shards, hub_min_refs, hub_budget,
                    allow_redeal=False)

        # per-owner hub tables: positions within the owner's block.
        # hub_cap stays 0 when nothing is replicated — the kernel then
        # SKIPS the all_gather entirely (an empty collective still costs
        # per-call sync latency; measured it cut the community halo from
        # 0.80x to 0.72x of single-device on the virtual mesh)
        hub_cap = 0
        hub_pos = np.zeros(n, np.int64)
        hub_local = []
        for j in range(n_shards):
            lo = j * rows
            ids = np.flatnonzero(is_hub[lo:lo + rows]) + lo
            hub_pos[ids] = np.arange(len(ids))
            hub_local.append(ids - lo)
            hub_cap = max(hub_cap, len(ids))
        hub_send = np.zeros((n_shards, hub_cap), np.int32)
        for j, ids in enumerate(hub_local):
            hub_send[j, : len(ids)] = ids

        # pass 2: ghost capacity over the NON-hub needs only
        cap = 1
        for k in range(n_shards):
            for j in range(n_shards):
                if j == k:
                    continue
                need[k][j] = need[k][j][~is_hub[need[k][j]]]
                cap = max(cap, len(need[k][j]))

        send_idx = np.zeros((n_shards, n_shards, cap), np.int32)
        # per-shard remap old-new-id -> local table position
        remap = np.zeros((n_shards, rows * n_shards), np.int32)
        hub_base = rows + n_shards * cap
        for k in range(n_shards):
            m = np.zeros(rows * n_shards, np.int32)
            lo = k * rows
            m[lo:lo + rows] = np.arange(rows)
            # replicated hubs owned elsewhere read from the hub area
            other_hubs = is_hub.copy()
            other_hubs[lo:lo + rows] = False
            oh = np.flatnonzero(other_hubs)
            m[oh] = hub_base + owner_of(oh) * hub_cap + hub_pos[oh]
            for j in range(n_shards):
                if j == k:
                    continue
                ids = need[k][j]
                send_idx[j, k, : len(ids)] = ids - j * rows
                m[ids] = rows + j * cap + np.arange(len(ids))
            remap[k] = m

        # per-shard bucketed layouts over remapped neighbors, stacked
        per_shard = []
        for k in range(n_shards):
            lo, hi = k * rows, min((k + 1) * rows, n)
            nbr_k = remap[k][np.minimum(nbr[lo:hi], rows * n_shards - 1)]
            per_shard.append(
                BucketedEll.build(nbr_k, mask[lo:hi],
                                  wgt[lo:hi] if wgt is not None else None))
        widths = sorted({b[1].shape[1] for lay in per_shard
                         for b in lay.buckets})
        stacked = []
        pad_rows = 1
        # per-shard local-row -> concat-of-bucket-aggregates position (the
        # scatter-free assembly of ops.spmm.spmm_bucketed carried into the
        # shard-local kernel; uncovered rows -> the appended zero row)
        offset = 0
        out_inv = np.full((n_shards, rows), -1, np.int64)
        for wd in widths:
            sizes = [next((b[0].shape[0] for b in lay.buckets
                           if b[1].shape[1] == wd), 0) for lay in per_shard]
            m_max = max(max(sizes), 1)
            pad_rows = max(pad_rows, m_max)
            ids_s = np.zeros((n_shards, m_max), np.int32)
            nbr_s = np.zeros((n_shards, m_max, wd), np.int32)
            wgt_s = np.zeros((n_shards, m_max, wd), np.float32)
            for k, lay in enumerate(per_shard):
                b = next((b for b in lay.buckets if b[1].shape[1] == wd),
                         None)
                m = 0
                if b is not None:
                    ids, nb, wg = b
                    m = ids.shape[0]
                    ids_s[k, :m] = ids
                    nbr_s[k, :m] = nb
                    wgt_s[k, :m] = wg
                    out_inv[k, ids] = offset + np.arange(m)
                # padding rows write past the block — unique + sorted
                ids_s[k, m:] = rows + np.arange(m_max - m, dtype=np.int32)
            offset += m_max
            stacked.extend((ids_s, nbr_s, wgt_s))
        out_inv[out_inv < 0] = offset  # zero row
        return HaloLayout(
            num_nodes=n, n_shards=n_shards, rows_per_shard=rows,
            ghost_capacity=cap, order=order, inv_perm=inv,
            send_idx=send_idx, stacked=tuple(stacked), pad_rows=pad_rows,
            edge_cut=cut, hub_capacity=hub_cap, hub_send=hub_send,
            num_hubs=num_hubs, out_inv=out_inv.astype(np.int32),
        )

    def operands(self):
        """Device-array tuple: (send_idx, hub_send, out_inv, *stacked)."""
        return (jnp.asarray(self.send_idx),
                jnp.asarray(self.hub_send),
                jnp.asarray(self.out_inv)) + tuple(
            jnp.asarray(a) for a in self.stacked)


def spmm_halo(
    mesh: Mesh,
    x: jnp.ndarray,  # [rows*S, F] node features in RELABELED order
    num_nodes: int,
    rows_per_shard: int,
    ghost_capacity: int,
    *ops,  # HaloLayout.operands()
    axis: str = "edge",
    exchange_dtype=None,
) -> jnp.ndarray:
    """Boundary-exchange node-sharded SpMM (module docstring).

    `exchange_dtype` (e.g. jnp.bfloat16) compresses ONLY the collective
    payloads (ghost all_to_all + hub all_gather) — the standard
    activation-compression move over the interconnect; local compute stays in
    `x.dtype`, so boundary rows pass through one rounding while owned
    rows are exact. None = exchange in `x.dtype`.

    Returns [num_nodes, F] in relabeled order, row-sharded over `axis`.
    """
    s = mesh.shape[axis]
    rows, cap = rows_per_shard, ghost_capacity
    pad_total = rows * s

    def local(x_l, send_idx, hub_send, out_inv, *buckets):
        send_idx = send_idx[0]  # [S, C]... sharded leading dim
        hub_idx = hub_send[0]  # [H] this shard's hub rows (H may be 0)
        f = x_l.shape[1]
        xd = exchange_dtype or x_l.dtype
        send = x_l[send_idx.reshape(-1)].astype(xd).reshape(s, cap, f)
        ghosts = jax.lax.all_to_all(
            send, axis, split_axis=0, concat_axis=0, tiled=True)
        parts = [x_l, ghosts.reshape(s * cap, f).astype(x_l.dtype)]
        if hub_idx.shape[0]:
            # hub replicas: every shard broadcasts its owned hub rows
            # once — O(num_hubs * F) receive volume regardless of reader
            # fan-out. Statically skipped when nothing is replicated
            # (an empty all_gather still pays per-call sync latency).
            parts.append(jax.lax.all_gather(
                x_l[hub_idx].astype(xd), axis, axis=0,
                tiled=True).astype(x_l.dtype))
        table = jnp.concatenate(parts, axis=0)
        prec = (jax.lax.Precision.HIGHEST
                if x_l.dtype == jnp.float32 else jax.lax.Precision.DEFAULT)
        aggs = []
        for i in range(0, len(buckets), 3):
            nb, wg = buckets[i + 1][0], buckets[i + 2][0]
            g = table[nb.reshape(-1)].reshape(*nb.shape, f)
            aggs.append(jnp.einsum("nd,ndf->nf", wg.astype(x_l.dtype), g,
                                   precision=prec))
        # scatter-free assembly (ops.spmm.spmm_bucketed): one inverse-
        # permutation gather instead of per-bucket `.set` copies of the
        # whole local accumulator
        aggs.append(jnp.zeros((1, f), x_l.dtype))
        return jnp.concatenate(aggs, axis=0)[out_inv[0]]

    in_specs = (P(axis),) * (1 + len(ops))
    fn = shard_map(local, mesh=mesh, in_specs=(P(axis),) + in_specs[:-1],
                   out_specs=P(axis))
    if x.shape[0] < pad_total:
        x = jnp.pad(x, ((0, pad_total - x.shape[0]), (0, 0)))
    out = fn(x, *ops)
    return out[:num_nodes] if pad_total > num_nodes else out


def spmm_halo_sym(mesh, x, num_nodes, rows_per_shard, ghost_capacity, ops,
                  axis: str = "edge"):
    """`spmm_halo` with the symmetric-adjacency custom VJP: for w_ij = w_ji
    the backward pass is the same halo kernel applied to the cotangent
    (A^T = A; RCM relabeling is a symmetric permutation). `ops` is the
    tuple from `HaloLayout.operands()`."""

    @partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3, 4))
    def run(x, num_nodes_, rows_, cap_, axis_, ops_):
        return spmm_halo(mesh, x, num_nodes_, rows_, cap_, *ops_,
                         axis=axis_)

    def fwd(x, num_nodes_, rows_, cap_, axis_, ops_):
        # zero-width sentinel carries the PRIMAL row count as a static
        # shape (a Python int in residuals would get traced)
        shape_tag = jnp.zeros((x.shape[0], 0), x.dtype)
        return run(x, num_nodes_, rows_, cap_, axis_, ops_), (
            ops_, shape_tag)

    def bwd(num_nodes_, rows_, cap_, axis_, res, g):
        ops_, shape_tag = res
        x_rows = shape_tag.shape[0]
        dx = spmm_halo(mesh, g, num_nodes_, rows_, cap_, *ops_, axis=axis_)
        if dx.shape[0] < x_rows:  # mirror the PRIMAL input's padding
            dx = jnp.pad(dx, ((0, x_rows - dx.shape[0]), (0, 0)))
        zeros = tuple(
            np.zeros(a.shape, jax.dtypes.float0)
            if not jnp.issubdtype(a.dtype, jnp.inexact) else jnp.zeros_like(a)
            for a in ops_
        )
        return (dx, zeros)

    run.defvjp(fwd, bwd)
    return run(x, num_nodes, rows_per_shard, ghost_capacity, axis, ops)

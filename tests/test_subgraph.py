"""Tests for batched enclosing-subgraph extraction + DRNL labeling.

The DRNL property test checks the batched BFS tags against an independent
shortest-path oracle, reproducing the tag semantics of the reference
(`SEAL/utils/utils.py:35-54`): tag = 1 + min(dx,dy) + (d//2)*((d//2)+(d%2)-1)
on the target-masked subgraph, unreachable -> 0, endpoints -> 1.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from linkpred.data import subgraph as sg


def bfs_dists(adj: np.ndarray, source: int) -> np.ndarray:
    """Oracle: BFS distances on a boolean adjacency (INF = unreachable)."""
    n = adj.shape[0]
    dist = np.full(n, np.iinfo(np.int32).max // 4, dtype=np.int64)
    dist[source] = 0
    frontier = [source]
    d = 0
    while frontier:
        d += 1
        nxt = []
        for u in frontier:
            for v in np.nonzero(adj[u])[0]:
                if dist[v] > d:
                    dist[v] = d
                    nxt.append(v)
        frontier = nxt
    return dist


def oracle_drnl(adj: np.ndarray, n: int) -> np.ndarray:
    dx = bfs_dists(adj[:n, :n], 0)
    dy = bfs_dists(adj[:n, :n], 1)
    INF = np.iinfo(np.int32).max // 4
    tags = np.zeros(n, dtype=np.int64)
    for i in range(2, n):
        if dx[i] >= INF or dy[i] >= INF:
            tags[i] = 0
        else:
            d = dx[i] + dy[i]
            div, mod = divmod(d, 2)
            tags[i] = 1 + min(dx[i], dy[i]) + div * (div + mod - 1)
    tags[0] = tags[1] = 1
    return tags


def random_subgraph_batch(rng, P=16, K=24, p_edge=0.12):
    adj = np.zeros((P, K, K), dtype=np.uint8)
    mask = np.zeros((P, K), dtype=bool)
    sizes = rng.integers(2, K + 1, size=P)
    for i in range(P):
        n = int(sizes[i])
        a = (rng.random((n, n)) < p_edge).astype(np.uint8)
        a = np.triu(a, 1)
        a = a + a.T
        a[0, 1] = a[1, 0] = 0  # target link masked
        adj[i, :n, :n] = a
        mask[i, :n] = True
    return adj, mask, sizes


class TestDRNL:
    def test_matches_shortest_path_oracle(self, rng):
        adj, mask, sizes = random_subgraph_batch(rng)
        tags = np.asarray(sg.drnl_tags(jnp.asarray(adj), jnp.asarray(mask), adj.shape[1]))
        for i in range(adj.shape[0]):
            n = int(sizes[i])
            expect = oracle_drnl(adj[i], n)
            np.testing.assert_array_equal(tags[i, :n], expect)
            assert (tags[i, n:] == 0).all()

    def test_path_graph_tags(self):
        # 0 - 2 - 1 chain: node 2 has dx=dy=1, d=2 -> tag 1+1+1*(1+0-1)=2
        adj = np.zeros((1, 4, 4), dtype=np.uint8)
        adj[0, 0, 2] = adj[0, 2, 0] = 1
        adj[0, 1, 2] = adj[0, 2, 1] = 1
        mask = np.array([[True, True, True, False]])
        tags = np.asarray(sg.drnl_tags(jnp.asarray(adj), jnp.asarray(mask), 4))
        np.testing.assert_array_equal(tags[0], [1, 1, 2, 0])

    def test_unreachable_gets_zero(self):
        adj = np.zeros((1, 3, 3), dtype=np.uint8)  # no edges at all
        mask = np.array([[True, True, True]])
        tags = np.asarray(sg.drnl_tags(jnp.asarray(adj), jnp.asarray(mask), 3))
        np.testing.assert_array_equal(tags[0], [1, 1, 0])


class TestExtraction:
    def _toy_adj(self):
        # 6-cycle + one chord
        n = 6
        adj = np.zeros((n, n), dtype=bool)
        for i in range(n):
            adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = True
        adj[0, 3] = adj[3, 0] = True
        return adj

    def test_nodes_start_with_endpoints(self, rng):
        adj = self._toy_adj()
        pairs = np.array([[0, 1], [2, 5]])
        nodes, mask, sub, sizes = sg.extract_subgraphs(pairs, adj, hop=1, max_neighbors=6, rng=rng)
        assert nodes[0, 0] == 0 and nodes[0, 1] == 1
        assert nodes[1, 0] == 2 and nodes[1, 1] == 5
        assert mask.sum(axis=1).tolist() == sizes.tolist()

    def test_hop1_is_neighbor_union(self, rng):
        adj = self._toy_adj()
        nodes, mask, sub, sizes = sg.extract_subgraphs(
            np.array([[0, 1]]), adj, hop=1, max_neighbors=6, rng=rng
        )
        got = set(nodes[0, mask[0]].tolist())
        expect = {0, 1} | set(np.nonzero(adj[0])[0]) | set(np.nonzero(adj[1])[0])
        assert got == expect

    def test_target_link_masked(self, rng):
        adj = self._toy_adj()
        nodes, mask, sub, sizes = sg.extract_subgraphs(
            np.array([[0, 1]]), adj, hop=1, max_neighbors=6, rng=rng
        )
        assert sub[0, 0, 1] == 0 and sub[0, 1, 0] == 0
        # but other adjacency entries are induced from the graph
        order = nodes[0, mask[0]]
        ref = adj[np.ix_(order, order)].astype(np.uint8)
        ref[0, 1] = ref[1, 0] = 0
        np.testing.assert_array_equal(sub[0][: len(order), : len(order)], ref)

    def test_cap_respected(self, rng):
        adj = np.ones((50, 50), dtype=bool)
        np.fill_diagonal(adj, False)
        nodes, mask, sub, sizes = sg.extract_subgraphs(
            np.array([[0, 1]]), adj, hop=2, max_neighbors=10, rng=rng
        )
        assert sizes[0] == 10
        assert mask.sum() == 10

    def test_compact_tags_contiguous(self, rng):
        tags = np.array([[1, 1, 7, 3], [1, 1, 0, 7]])
        mask = np.array([[True] * 4, [True] * 4])
        compact, size = sg.compact_tags(tags, mask)
        assert size == 4  # {0, 1, 3, 7}
        assert set(np.unique(compact)) <= set(range(size))
        # order-preserving: 0<1<3<7 -> 0,1,2,3
        np.testing.assert_array_equal(compact[0], [1, 1, 3, 2])


class TestAutoHop:
    def test_returns_1_or_2(self, rng, fb_graph):
        g, edges = fb_graph
        adj = g.has_edge_matrix()
        pos = np.stack([g.src[g.src < g.dst], g.dst[g.src < g.dst]], axis=1)
        sel = rng.permutation(len(pos))[:100]
        test_pos = pos[sel]
        neg = np.stack(np.nonzero(np.triu(~adj, 1)), axis=1)
        test_neg = neg[rng.permutation(len(neg))[:100]]
        assert sg.auto_hop(adj, test_pos, test_neg) in (1, 2)


class TestGnnInputs:
    def test_shapes_and_padding(self, rng):
        adj, mask, sizes = random_subgraph_batch(rng, P=4, K=8)
        tags = np.asarray(sg.drnl_tags(jnp.asarray(adj), jnp.asarray(mask), 8))
        tags, tsize = sg.compact_tags(tags, mask)
        batch = sg.SubgraphBatch(
            nodes=np.zeros((4, 8), np.int32),
            node_mask=mask, adj=adj, sizes=sizes.astype(np.int32),
            tags=tags, tags_size=tsize,
        )
        emb = rng.standard_normal((1, 16)).astype(np.float32)  # node 0 only
        d_inv, a_tilde, x = sg.gnn_inputs(batch, np.repeat(emb, 1, axis=0))
        assert d_inv.shape == (4, 8) and a_tilde.shape == (4, 8, 8)
        assert x.shape == (4, 8, tsize + 16)
        # padded nodes: zero features, self-loop-only rows
        for i in range(4):
            n = int(sizes[i])
            assert np.all(x[i, n:] == 0)
            np.testing.assert_allclose(d_inv[i, n:], 1.0)


class TestCSRExtraction:
    """CSR (scale-path) extraction vs the dense path — exact set equality
    when the max_neighbors cap is never hit (selection is deterministic),
    structural properties when it is."""

    def _graph(self, seed=0, n=150, e=500):
        from linkpred.data.graph import Graph

        rng = np.random.default_rng(seed)
        pairs = rng.integers(0, n, (e, 2))
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        g = Graph.from_undirected_edges(pairs[:, 0], pairs[:, 1], num_nodes=n)
        adj = np.zeros((n, n), dtype=bool)
        adj[np.asarray(g.src), np.asarray(g.dst)] = True
        return g, adj, rng

    @pytest.mark.parametrize("hop", [1, 2])
    @pytest.mark.parametrize("use_native", [True, False])
    def test_matches_dense_without_cap(self, hop, use_native, monkeypatch):
        from linkpred import native

        if use_native and not native.available():
            pytest.skip("native library unavailable")
        if not use_native:
            monkeypatch.setattr(native, "available", lambda: False)
        g, adj, rng = self._graph()
        n = adj.shape[0]
        pairs = rng.integers(0, n, (40, 2))
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        nd, md, ad, sd = sg.extract_subgraphs(
            pairs, adj, hop, n, np.random.default_rng(1)
        )
        nc, mc, ac, s = sg.extract_subgraphs_csr(
            pairs, np.asarray(g.indptr), np.asarray(g.indices), n, hop, n,
            seed=1,
        )
        assert (sd == s).all()
        for p in range(len(pairs)):
            assert set(nd[p][md[p]].tolist()) == set(nc[p][mc[p]].tolist())
            assert ad[p].sum() == ac[p].sum()  # same induced edge count
            assert ac[p, 0, 1] == 0 and ac[p, 1, 0] == 0  # target masked

    def test_truncation_properties(self):
        g, adj, rng = self._graph(seed=3, n=300, e=2500)
        n = adj.shape[0]
        K = 12
        pairs = rng.integers(0, n, (60, 2))
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        nodes, mask, a, sizes = sg.extract_subgraphs_csr(
            pairs, np.asarray(g.indptr), np.asarray(g.indices), n, 2, K,
            seed=9,
        )
        assert (sizes <= K).all() and (sizes >= 2).all()
        assert (nodes[:, 0] == pairs[:, 0]).all()
        assert (nodes[:, 1] == pairs[:, 1]).all()
        assert (mask.sum(axis=1) == sizes).all()
        # every selected node is adjacent in the induced subgraph only to
        # other selected nodes (adjacency consistent with the global graph)
        for p in range(5):
            sel = nodes[p][mask[p]]
            dense_sub = adj[np.ix_(sel, sel)].copy()
            dense_sub[0, 1] = dense_sub[1, 0] = False
            assert (a[p][: len(sel), : len(sel)] == dense_sub).all()

    def test_auto_hop_csr_matches_dense(self):
        g, adj, rng = self._graph(seed=5)
        n = adj.shape[0]
        tp = rng.integers(0, n, (30, 2))
        tp = tp[tp[:, 0] != tp[:, 1]]
        tn = rng.integers(0, n, (30, 2))
        tn = tn[tn[:, 0] != tn[:, 1]]
        dense = sg.auto_hop(adj, tp, tn)
        csr = sg.auto_hop_csr(np.asarray(g.indptr), np.asarray(g.indices), tp, tn)
        assert dense == csr

    def test_batch_csr_tags_match_dense_batch(self):
        """Full batch build: identical selections (no cap) must produce the
        identical compacted DRNL tag multiset per subgraph."""
        g, adj, rng = self._graph(seed=7)
        n = adj.shape[0]
        pairs = rng.integers(0, n, (20, 2))
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        bd = sg.build_subgraph_batch(pairs, adj, 1, n, np.random.default_rng(1))
        bc = sg.build_subgraph_batch_csr(
            pairs, np.asarray(g.indptr), np.asarray(g.indices), n, 1, n,
            seed=1, drnl_chunk=8,
        )
        assert bd.tags_size == bc.tags_size
        for p in range(len(pairs)):
            td = np.sort(bd.tags[p][bd.node_mask[p]])
            tc = np.sort(bc.tags[p][bc.node_mask[p]])
            assert (td == tc).all()


class TestNativeDRNL:
    def test_matches_jit_bfs(self):
        from linkpred import native

        if not native.available():
            pytest.skip("native library unavailable")
        rng = np.random.default_rng(11)
        P, K = 64, 40
        sizes = rng.integers(2, K + 1, P).astype(np.int32)
        mask = np.arange(K)[None, :] < sizes[:, None]
        adj = rng.random((P, K, K)) < 0.08
        adj = adj | adj.transpose(0, 2, 1)
        adj &= mask[:, :, None] & mask[:, None, :]
        adj = adj.astype(np.uint8)
        adj[:, 0, 1] = adj[:, 1, 0] = 0
        t_native = native.drnl_tags_batch(adj, mask, sizes)
        t_jit = np.asarray(
            sg.drnl_tags(jnp.asarray(adj), jnp.asarray(mask), max_steps=K)
        )
        assert (t_native == t_jit).all()

"""Native C++ host-runtime bindings vs their Python reference paths."""

import numpy as np
import pytest

from linkpred import native
from linkpred.data.graph import Graph
from linkpred.ops.walk import AliasTables, alias_setup_rows

needs_native = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


@needs_native
class TestNative:
    def test_csr_ell_matches_python(self, rng):
        src = rng.integers(0, 40, 200)
        dst = rng.integers(0, 40, 200)
        order, indptr, nbr, mask, deg = native.build_csr_ell(src, dst, 40)
        g = Graph.from_edges(src, dst, num_nodes=40)
        np.testing.assert_array_equal(indptr, g.indptr)
        np.testing.assert_array_equal(deg, g.degree)
        d = min(nbr.shape[1], g.nbr.shape[1])
        np.testing.assert_array_equal(nbr[:, :d], g.nbr[:, :d])
        np.testing.assert_array_equal(mask[:, :d], g.nbr_mask[:, :d])

    def test_alias_rows_match_python(self, rng):
        valid = np.sort(rng.random((30, 6)) < 0.7, axis=1)[:, ::-1]
        probs = rng.random((30, 6)) * valid
        J1, q1 = native.build_alias_rows(probs, valid)
        J2, q2 = alias_setup_rows(probs, valid)
        np.testing.assert_array_equal(J1, J2)
        np.testing.assert_allclose(q1, q2, rtol=1e-6)

    def test_edge_bias_pq_tables(self, rng):
        """Native p/q edge bias == brute-force per-edge computation."""
        pairs = np.stack([rng.integers(0, 20, 60), rng.integers(0, 20, 60)], 1)
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        g = Graph.from_undirected_edges(pairs[:, 0], pairs[:, 1], num_nodes=20)
        p, q = 0.5, 2.0
        probs = native.edge_bias_probs(
            g.src, g.dst, g.nbr, g.nbr_mask, g.indptr, g.indices, p, q
        )
        has = g.has_edge_matrix()
        for e in range(g.num_edges):
            s, t = g.src[e], g.dst[e]
            for k in range(g.max_degree):
                if not g.nbr_mask[t, k]:
                    assert probs[e, k] == 0.0
                    continue
                x = g.nbr[t, k]
                expect = 1.0 / p if x == s else (1.0 if has[x, s] else 1.0 / q)
                assert probs[e, k] == pytest.approx(expect)

    def test_edge_bias_weighted_matches_numpy(self, rng):
        """Weighted C++ edge bias == the numpy dense-fallback formula
        (reference `get_alias_edge` weighted semantics, node2vec.py:55-74)."""
        pairs = np.stack([rng.integers(0, 20, 60), rng.integers(0, 20, 60)], 1)
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        w = rng.random(len(pairs)).astype(np.float32) + 0.1
        g = Graph.from_undirected_edges(
            pairs[:, 0], pairs[:, 1], num_nodes=20, weight=w)
        p, q = 0.5, 2.0
        probs = native.edge_bias_probs(
            g.src, g.dst, g.nbr, g.nbr_mask, g.indptr, g.indices, p, q,
            nbr_weight=g.nbr_weight,
        )
        has = g.has_edge_matrix()
        nbrs = g.nbr[g.dst]
        pe = np.where(
            nbrs == g.src[:, None], 1.0 / p,
            np.where(has[nbrs, g.src[:, None]], 1.0, 1.0 / q),
        )
        expect = np.where(g.nbr_mask[g.dst], pe, 0.0) * g.nbr_weight[g.dst]
        np.testing.assert_allclose(probs, expect, rtol=1e-6)

    def test_weighted_alias_tables_at_scale(self, rng):
        """Weighted p/q alias tables at 235k nodes — impossible for the old
        dense has_edge fallback (~55 GB), routine for the C++ CSR path."""
        from linkpred.ops.walk import AliasTables

        n, e = 235_000, 400_000
        lo = rng.integers(0, n, e).astype(np.int64)
        hi = rng.integers(0, n, e).astype(np.int64)
        keep = lo != hi
        w = (rng.random(int(keep.sum())) + 0.1).astype(np.float32)
        g = Graph.from_undirected_edges(
            lo[keep], hi[keep], num_nodes=n, weight=w)
        tabs = AliasTables.build(g, p=2.0, q=0.5)
        assert tabs.edge_J.shape == (g.num_edges, g.max_degree)
        # every valid row is a proper alias table: q in [0, 1+eps]
        valid = g.nbr_mask[g.dst]
        assert (tabs.edge_q[valid] >= 0).all()
        assert (tabs.edge_q[valid] <= 1.0 + 1e-5).all()

    def test_sgns_ref_learns_cliques(self, rng):
        """The measured-baseline C++ SGNS trainer must actually learn
        (same two-clique oracle as the device trainer's quality test)."""
        import jax

        from linkpred.data.graph import Graph as G
        from linkpred.ops.walk import WalkEngine

        n = 16
        pairs = []
        for a in range(8):
            for b in range(a + 1, 8):
                pairs.append((a, b))
                pairs.append((a + 8, b + 8))
        pairs.append((0, 8))
        pairs = np.asarray(pairs)
        g = G.from_undirected_edges(pairs[:, 0], pairs[:, 1], num_nodes=n)
        walks = np.asarray(WalkEngine(g).walks(jax.random.PRNGKey(0), 40, 12))
        emb, trained = native.sgns_train_ref(
            walks, n, dim=16, window=4, epochs=5, lr=0.05)
        assert trained == walks.size * 5
        e = emb / np.linalg.norm(emb, axis=1, keepdims=True)
        sim = e @ e.T
        intra = (sim[:8, :8].sum() - 8) / (8 * 7) / 2 + (
            sim[8:, 8:].sum() - 8) / (8 * 7) / 2
        inter = sim[:8, 8:].mean()
        assert intra > inter + 0.2, (intra, inter)

    def test_negative_sampling_excludes(self, rng):
        pairs = np.stack([rng.integers(0, 25, 80), rng.integers(0, 25, 80)], 1)
        neg = native.sample_negatives(pairs, 25, 50, seed=3)
        assert neg.shape == (50, 2)
        assert (neg[:, 0] < neg[:, 1]).all()
        ex = set()
        for u, v in pairs:
            ex.add((min(u, v), max(u, v)))
        for u, v in neg:
            assert (u, v) not in ex
        assert len({(u, v) for u, v in neg}) == 50

    def test_walk_engine_uses_native_pq(self, rng):
        """Biased-walk alias tables built through the native path still
        produce valid walks with correct bias structure."""
        import jax

        pairs = np.stack([rng.integers(0, 30, 90), rng.integers(0, 30, 90)], 1)
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        g = Graph.from_undirected_edges(pairs[:, 0], pairs[:, 1], num_nodes=30)
        from linkpred.ops.walk import WalkEngine

        eng = WalkEngine(g, p=0.25, q=4.0)
        w = np.asarray(eng.walks(jax.random.PRNGKey(0), 2, 10))
        has = g.has_edge_matrix()
        for row in w[:30]:
            for a, b in zip(row[:-1], row[1:]):
                assert a == b or has[a, b]

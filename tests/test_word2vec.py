"""SGNS (word2vec) trainer quality and mechanics."""

import numpy as np
import jax
import pytest

from linkpred.data.graph import Graph
from linkpred.models.word2vec import SGNSConfig, _keep_prob, _noise_alias, train_sgns
from linkpred.ops.walk import WalkEngine


class TestSGNS:
    def test_two_cliques_separate(self):
        """Embeddings from walks on two cliques joined by one bridge edge
        should be far more similar within a clique than across."""
        n = 16
        pairs = []
        for a in range(8):
            for b in range(a + 1, 8):
                pairs.append((a, b))
                pairs.append((a + 8, b + 8))
        pairs.append((0, 8))  # bridge
        pairs = np.asarray(pairs)
        g = Graph.from_undirected_edges(pairs[:, 0], pairs[:, 1], num_nodes=n)
        walks = WalkEngine(g).walks(jax.random.PRNGKey(0), 40, 12)
        emb = train_sgns(
            jax.random.PRNGKey(1), walks, n,
            SGNSConfig(dim=16, window=4, negatives=5, epochs=3, batch_size=2048),
        )
        e = emb / np.linalg.norm(emb, axis=1, keepdims=True)
        sim = e @ e.T
        intra = (sim[:8, :8].sum() - 8) / (8 * 7) / 2 + (
            sim[8:, 8:].sum() - 8
        ) / (8 * 7) / 2
        inter = sim[:8, 8:].mean()
        assert intra > inter + 0.2, (intra, inter)

    def test_classic_negatives_path(self):
        """neg_pool=0 selects `step_classic` (per-pair negatives, the
        strict gensim semantics); it must learn the same clique structure
        as the pooled default."""
        n = 16
        pairs = []
        for a in range(8):
            for b in range(a + 1, 8):
                pairs.append((a, b))
                pairs.append((a + 8, b + 8))
        pairs.append((0, 8))
        pairs = np.asarray(pairs)
        g = Graph.from_undirected_edges(pairs[:, 0], pairs[:, 1], num_nodes=n)
        walks = WalkEngine(g).walks(jax.random.PRNGKey(0), 40, 12)
        emb = train_sgns(
            jax.random.PRNGKey(1), walks, n,
            SGNSConfig(dim=16, window=4, negatives=5, epochs=3,
                       batch_size=2048, neg_pool=0),
        )
        e = emb / np.linalg.norm(emb, axis=1, keepdims=True)
        sim = e @ e.T
        intra = (sim[:8, :8].sum() - 8) / (8 * 7) / 2 + (
            sim[8:, 8:].sum() - 8
        ) / (8 * 7) / 2
        inter = sim[:8, 8:].mean()
        assert intra > inter + 0.2, (intra, inter)

    def test_noise_alias_distribution(self, rng):
        counts = np.array([100, 10, 1, 50, 0])
        J, q = _noise_alias(counts, 0.75)
        # empirical draw frequencies approximate counts**0.75 / sum
        p = counts.astype(float) ** 0.75
        p /= p.sum()
        draws = np.zeros(5)
        u = rng.random((20000, 2))
        kk = np.minimum((u[:, 0] * 5).astype(int), 4)
        take = np.where(u[:, 1] < q[kk], kk, J[kk])
        for t in take:
            draws[t] += 1
        draws /= draws.sum()
        np.testing.assert_allclose(draws, p, atol=0.02)

    def test_keep_prob_bounds(self):
        counts = np.array([1000, 100, 1])
        keep = _keep_prob(counts, 1e-3)
        assert ((keep > 0) & (keep <= 1)).all()
        assert keep[0] <= keep[2]  # frequent words downsampled harder
        np.testing.assert_allclose(_keep_prob(counts, 0.0), 1.0)


class TestSGNSPrep:
    def test_prep_path_matches_inline(self):
        """train_sgns(prep=prepare_sgns(...)) must equal the inline path —
        the prep only hoists corpus-dependent host work."""
        import jax
        import numpy as np

        from linkpred.models.word2vec import (
            SGNSConfig,
            prepare_sgns,
            train_sgns,
        )

        walks = np.random.default_rng(3).integers(0, 50, (64, 8), np.int32)
        cfg = SGNSConfig(dim=16, epochs=1, batch_size=256)
        a = train_sgns(jax.random.PRNGKey(5), walks, 50, cfg)
        prep = prepare_sgns(walks, 50, cfg)
        b = train_sgns(jax.random.PRNGKey(5), walks, 50, cfg, prep=prep)
        assert np.allclose(a, b), np.abs(a - b).max()
        assert prep.prep_seconds >= 0

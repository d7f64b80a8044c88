"""Distributed (mesh) SGNS: sharded-equals-single-device and quality."""

import jax
import numpy as np
import pytest

from linkpred.models.word2vec import SGNSConfig
from linkpred.parallel.mesh import make_mesh
from linkpred.parallel.sgns import (
    train_sgns_mesh,
    train_sgns_mesh_reference,
)


class TestMeshSGNS:
    def test_sharded_equals_reference_stream(self):
        """The 8-shard mesh run must reproduce the single-device replay of
        the same sample stream (module docstring: exact data-parallel
        design, no table averaging) up to psum float reassociation."""
        n = 200
        walks = np.random.default_rng(0).integers(
            0, n, (64, 12), dtype=np.int32)
        cfg = SGNSConfig(dim=32, window=4, negatives=5, epochs=1,
                         batch_size=512, ctx_per_center=4, neg_pool=64)
        mesh = make_mesh(shape=(8,), axis_names=("data",))
        a = train_sgns_mesh(jax.random.PRNGKey(3), walks, n, cfg, mesh=mesh)
        b = train_sgns_mesh_reference(jax.random.PRNGKey(3), walks, n, cfg,
                                      n_shards=8)
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=1e-3)

    def test_mesh_embeddings_separate_cliques(self):
        """Distributed fit must learn the same structure the single-device
        trainer does (two cliques + bridge)."""
        from linkpred.data.graph import Graph
        from linkpred.ops.walk import WalkEngine

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
        mesh = make_mesh(shape=(8,), axis_names=("data",))
        emb = train_sgns_mesh(
            jax.random.PRNGKey(1), walks, n,
            SGNSConfig(dim=16, window=4, negatives=5, epochs=3,
                       batch_size=2048, neg_pool=64),
            mesh=mesh,
        )
        e = emb / np.linalg.norm(emb, axis=1, keepdims=True)
        sim = e @ e.T
        intra = (sim[:8, :8].sum() - 8) / (8 * 7) / 2 + (
            sim[8:, 8:].sum() - 8) / (8 * 7) / 2
        inter = sim[:8, 8:].mean()
        assert intra > inter + 0.2, (intra, inter)

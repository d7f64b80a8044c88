"""Tests for the batched DGCNN (SEAL model family).

Includes the per-layer allclose check against an independent numpy
implementation of the reference graph-conv math `Z = tanh(D^-1 A~ Z W)`
(`SEAL/model/gnn.py:46-60`) — the BASELINE.md north-star exactness check.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from linkpred.models import seal


@pytest.fixture
def toy_batch(rng):
    B, K, F = 6, 12, 9
    adj = (rng.random((B, K, K)) < 0.2).astype(np.float32)
    adj = np.triu(adj, 1)
    adj = adj + adj.transpose(0, 2, 1)
    sizes = rng.integers(5, K + 1, size=B)
    mask = np.arange(K)[None, :] < sizes[:, None]
    adj *= (mask[:, :, None] & mask[:, None, :])
    a_tilde = adj + np.eye(K, dtype=np.float32)[None]
    d_inv = 1.0 / a_tilde.sum(axis=2)
    x = rng.standard_normal((B, K, F)).astype(np.float32) * mask[:, :, None]
    y = rng.integers(0, 2, size=B).astype(np.int32)
    return d_inv.astype(np.float32), a_tilde.astype(np.float32), x, mask, y, sizes


class TestGraphConv:
    def test_per_layer_allclose_vs_numpy(self, toy_batch, rng):
        d_inv, a_tilde, x, mask, y, sizes = toy_batch
        params = seal.init_params(jax.random.PRNGKey(0), x.shape[2], 8)
        cat, z4 = seal.graph_conv_layers(
            params, jnp.asarray(d_inv), jnp.asarray(a_tilde), jnp.asarray(x)
        )
        # independent numpy reference of gnn.py:46-60
        zs = []
        for b in range(x.shape[0]):
            z = x[b]
            zb = []
            for w in params.gw:
                z = np.tanh(np.diag(d_inv[b]) @ a_tilde[b] @ (z @ np.asarray(w)))
                zb.append(z)
            zs.append(zb)
        cat_ref = np.stack([np.concatenate(zb[:3], axis=1) for zb in zs])
        z4_ref = np.stack([zb[3] for zb in zs])
        np.testing.assert_allclose(np.asarray(cat), cat_ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(z4), z4_ref, rtol=1e-5, atol=1e-5)

    def test_padded_rows_stay_zero(self, toy_batch):
        d_inv, a_tilde, x, mask, y, sizes = toy_batch
        params = seal.init_params(jax.random.PRNGKey(1), x.shape[2], 8)
        cat, z4 = seal.graph_conv_layers(
            params, jnp.asarray(d_inv), jnp.asarray(a_tilde), jnp.asarray(x)
        )
        cat = np.asarray(cat)
        for b in range(x.shape[0]):
            n = int(sizes[b])
            np.testing.assert_allclose(cat[b, n:], 0.0, atol=1e-6)


class TestSortPool:
    def test_orders_by_score_and_zeroes_padding(self):
        cat = np.arange(24, dtype=np.float32).reshape(1, 4, 6)
        z4 = np.array([[[0.1], [0.9], [-0.5], [0.3]]], dtype=np.float32)
        mask = np.array([[True, True, True, False]])
        out = np.asarray(
            seal.sort_pool(jnp.asarray(cat), jnp.asarray(z4), jnp.asarray(mask), 4)
        )
        # order: node1 (0.9), node3 is masked, so node0 (0.1) beats node2 (-0.5)
        np.testing.assert_allclose(out[0, 0], cat[0, 1])
        np.testing.assert_allclose(out[0, 1], cat[0, 0])
        np.testing.assert_allclose(out[0, 2], cat[0, 2])
        np.testing.assert_allclose(out[0, 3], 0.0)  # padded row zeroed

    def test_truncates_to_threshold(self):
        cat = np.ones((1, 10, 6), dtype=np.float32)
        z4 = np.linspace(1, 0, 10, dtype=np.float32).reshape(1, 10, 1)
        mask = np.ones((1, 10), dtype=bool)
        out = seal.sort_pool(jnp.asarray(cat), jnp.asarray(z4), jnp.asarray(mask), 7)
        assert out.shape == (1, 7, 6)


class TestTraining:
    def test_forward_shapes(self, toy_batch):
        d_inv, a_tilde, x, mask, y, sizes = toy_batch
        params = seal.init_params(jax.random.PRNGKey(0), x.shape[2], 8)
        logits = seal.forward(
            params, jnp.asarray(d_inv), jnp.asarray(a_tilde), jnp.asarray(x),
            jnp.asarray(mask), 8,
        )
        assert logits.shape == (x.shape[0], 2)

    def test_training_reduces_loss(self, toy_batch):
        d_inv, a_tilde, x, mask, y, sizes = toy_batch
        cfg = seal.DGCNNConfig(
            feature_dim=x.shape[2], threshold_k=8, learning_rate=3e-3,
            batch_size=6, epochs=40, dropout=0.0,
        )
        import optax

        params = seal.init_params(jax.random.PRNGKey(0), x.shape[2], 8)
        args = (jnp.asarray(d_inv), jnp.asarray(a_tilde), jnp.asarray(x),
                jnp.asarray(mask), jnp.asarray(y))
        loss0 = float(seal.loss_fn(params, *args[:4], args[4], 8, None, 0.0))
        params = seal.train_dgcnn(cfg, d_inv, a_tilde, x, mask, y)
        loss1 = float(seal.loss_fn(params, *args[:4], args[4], 8, None, 0.0))
        assert loss1 < loss0

    def test_scores_in_unit_interval(self, toy_batch):
        d_inv, a_tilde, x, mask, y, sizes = toy_batch
        params = seal.init_params(jax.random.PRNGKey(0), x.shape[2], 8)
        s = np.asarray(
            seal.predict_scores(
                params, jnp.asarray(d_inv), jnp.asarray(a_tilde), jnp.asarray(x),
                jnp.asarray(mask), 8,
            )
        )
        assert s.shape == (x.shape[0],)
        assert ((s >= 0) & (s <= 1)).all()

    def test_threshold_from_sizes(self):
        sizes = np.array([10, 20, 30, 40, 50, 60, 70, 80, 90, 100])
        k = seal.threshold_from_sizes(sizes, 60.0)
        assert k == int(np.percentile(sizes, 60))
        assert seal.threshold_from_sizes(np.array([2, 3]), 60.0) == seal.CONV1D_2_WIDTH


class TestCompactInputs:
    def test_assemble_matches_host_dense(self, rng):
        """On-device assemble_inputs == host gnn_inputs on the same batch."""
        import jax.numpy as jnp
        from linkpred.data import subgraph as sg

        P, K, N, D = 5, 12, 30, 7
        adj = (rng.random((P, K, K)) < 0.3).astype(np.uint8)
        adj = np.triu(adj, 1); adj = adj + adj.transpose(0, 2, 1)
        sizes = rng.integers(3, K + 1, size=P).astype(np.int32)
        mask = np.arange(K)[None, :] < sizes[:, None]
        adj *= (mask[:, :, None] & mask[:, None, :]).astype(np.uint8)
        tags = rng.integers(0, 4, (P, K)).astype(np.int32) * mask
        nodes = rng.integers(0, N, (P, K)).astype(np.int32) * mask
        emb = rng.standard_normal((N, D)).astype(np.float32)
        batch = sg.SubgraphBatch(nodes=nodes, node_mask=mask, adj=adj,
                                 sizes=sizes, tags=tags, tags_size=4)
        d1, a1, x1 = sg.gnn_inputs(batch, emb)
        d2, a2, x2 = seal.assemble_inputs(
            jnp.asarray(adj), jnp.asarray(tags), jnp.asarray(nodes),
            jnp.asarray(mask), jnp.asarray(emb), 4,
        )
        np.testing.assert_allclose(np.asarray(d2), d1, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(a2), a1, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(x2), x1, rtol=1e-6)

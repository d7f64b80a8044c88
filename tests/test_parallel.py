"""Multi-device tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from linkpred.data.graph import Graph
from linkpred.ops.walk import WalkEngine
from linkpred.parallel import make_mesh
from linkpred.parallel.spmm_shard import pad_edges_for_mesh, spmm_edge_partitioned
from linkpred.parallel.walks import sharded_walks


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


class TestMesh:
    def test_shape(self, mesh):
        assert dict(mesh.shape) == {"data": 4, "edge": 2}


class TestShardedSpMM:
    def test_matches_dense(self, mesh, rng):
        n, e, f = 50, 200, 16
        src = rng.integers(0, n, e).astype(np.int32)
        dst = rng.integers(0, n, e).astype(np.int32)
        x = rng.standard_normal((n, f)).astype(np.float32)
        w = rng.random(e).astype(np.float32)
        (src_p, dst_p, w_p), mask = pad_edges_for_mesh(
            [jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)], mesh.shape["edge"]
        )
        out = np.asarray(
            spmm_edge_partitioned(
                mesh, src_p, dst_p, jnp.asarray(x), n,
                edge_weight=w_p, mask=mask,
            )
        )
        dense = np.zeros((n, f), dtype=np.float32)
        for s, d, ww in zip(src, dst, w):
            dense[d] += ww * x[s]
        np.testing.assert_allclose(out, dense, rtol=1e-4, atol=1e-4)


class TestShardedWalks:
    def test_walks_are_valid_paths(self, mesh, rng):
        pairs = np.stack([rng.integers(0, 30, 80), rng.integers(0, 30, 80)], axis=1)
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        g = Graph.from_undirected_edges(pairs[:, 0], pairs[:, 1], num_nodes=30)
        eng = WalkEngine(g)
        w = np.asarray(sharded_walks(mesh, eng, jax.random.PRNGKey(0), 3, 8))
        assert w.shape == (3 * 30, 8)
        has = g.has_edge_matrix()
        for row in w[:40]:
            for a, b in zip(row[:-1], row[1:]):
                assert a == b or has[a, b]


class TestTableShardedWalks:
    """The routed-frontier (all_to_all) walk engine with sharded tables —
    the Spark per-step frontier join (`Node2vec.scala:103-124`). Must
    produce valid biased walks, lose no walkers, and match the
    replicated-table engine in distribution."""

    def _graph(self, rng, n=30):
        from linkpred.data.graph import Graph

        pairs = np.stack(
            [rng.integers(0, n, 120), rng.integers(0, n, 120)], axis=1
        )
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        return Graph.from_undirected_edges(pairs[:, 0], pairs[:, 1],
                                           num_nodes=n)

    def _cond_freq(self, walks, n):
        c = np.zeros((n, n))
        for row in walks:
            for a, b in zip(row[:-1], row[1:]):
                if a != b:
                    c[a, b] += 1
        tot = c.sum(axis=1, keepdims=True)
        tot[tot == 0] = 1
        return c / tot

    def test_matches_replicated_distribution(self, rng):
        from linkpred.ops.walk import WalkEngine
        from linkpred.parallel import make_mesh
        from linkpred.parallel.walks import TableShardedWalker

        g = self._graph(rng)
        n = g.num_nodes
        mesh = make_mesh(8, axis_names=("edge",), shape=(8,))
        sharded = TableShardedWalker.build(g, 8, p=2.0, q=0.5)
        walks, dropped = sharded.walks(mesh, jax.random.PRNGKey(0), 60, 10)
        assert dropped == 0
        assert walks.shape == (60 * n, 10)
        # every walker id recovered exactly once -> row r*N+v starts at v
        np.testing.assert_array_equal(
            walks[:, 0], np.tile(np.arange(n), 60)
        )
        has = g.has_edge_matrix()
        for row in walks:
            for a, b in zip(row[:-1], row[1:]):
                assert a == b or has[a, b]

        repl = WalkEngine(g, p=2.0, q=0.5)
        wr = np.asarray(repl.walks(jax.random.PRNGKey(1), 60, 10))
        diff = np.abs(self._cond_freq(walks, n) - self._cond_freq(wr, n))
        assert diff.max() < 0.12, diff.max()

    def test_multi_axis_mesh(self, mesh, rng):
        """Tables sharded over `edge` while `data` replicates — the layout
        used when walks coexist with data-parallel training."""
        from linkpred.parallel.walks import TableShardedWalker

        g = self._graph(rng)
        sharded = TableShardedWalker.build(g, mesh.shape["edge"])
        walks, dropped = sharded.walks(mesh, jax.random.PRNGKey(0), 8, 6)
        assert dropped == 0
        has = g.has_edge_matrix()
        for row in walks[:60]:
            for a, b in zip(row[:-1], row[1:]):
                assert a == b or has[a, b]


class TestDryrun:
    def test_dryrun_multichip(self):
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)

    def test_entry_compiles(self):
        import __graft_entry__ as ge

        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        assert out.shape[0] > 0


class TestNodeShardedBucketed:
    def test_matches_dense(self, mesh, rng):
        from linkpred.parallel.spmm_shard import (
            build_node_sharded_buckets,
            spmm_node_sharded,
        )

        n = 77  # not divisible by the edge axis -> exercises row padding
        pairs = np.stack(
            [rng.integers(0, n, 300), rng.integers(0, n, 300)], axis=1
        )
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        g = Graph.from_undirected_edges(pairs[:, 0], pairs[:, 1], num_nodes=n)
        x = rng.standard_normal((n, 16)).astype(np.float32)
        rows, widths, stacked = build_node_sharded_buckets(
            g, mesh.shape["edge"]
        )
        out = np.asarray(
            spmm_node_sharded(
                mesh, jnp.asarray(x), n, rows,
                *[jnp.asarray(a) for a in stacked],
            )
        )
        dense = g.dense_adjacency() @ x
        np.testing.assert_allclose(out, dense, rtol=1e-4, atol=1e-4)


class TestEdgeShardedTwoWLStep:
    def test_sharded_equals_replicated(self, mesh, rng):
        """The edge-sharded `shard_twowl_split` placement must not change
        train_step numerics: params after one step match an unsharded run
        (GSPMD may only alter reduction order, not semantics)."""
        import optax

        from linkpred.data.twowl import build_twowl_data
        from linkpred.models import twowl as m
        from linkpred.parallel import dp

        n = 32
        pairs = np.stack(
            [rng.integers(0, n, 140), rng.integers(0, n, 140)], axis=1
        )
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        d = build_twowl_data(pairs, n, rng=rng, ei2_bucket=16 * 8)
        cfg = m.TwoWLConfig(max_degree=d.max_degree, channels_1wl=16,
                            channels_2wl=8, depth1=2, depth2=2,
                            learning_rate=0.01)
        params = m.init_params(jax.random.PRNGKey(0), cfg)
        # sgd, not adam: adam rescales noise-dominated gradient components
        # to full O(lr) steps, so psum reduction-order noise would flip
        # update signs and mask genuine (in)equality
        opt = optax.sgd(cfg.learning_rate)
        ostate = opt.init(params)
        raw = m.SplitArrays.from_split(d.train)
        P_ = min(6, d.train.num_msg // 2, len(d.train.pred) // 2)
        pos = jnp.arange(P_, dtype=jnp.int32)
        neg = jnp.arange(P_, dtype=jnp.int32)
        key = jax.random.PRNGKey(3)

        ref_p, _, ref_loss, _, _ = m.train_step(
            params, ostate, key, pos, neg, raw, cfg, opt, d.num_nodes
        )
        placed = dp.shard_twowl_split(mesh, raw)
        got_p, _, got_loss, _, _ = m.train_step(
            dp.replicate(mesh, params), dp.replicate(mesh, ostate),
            key, pos, neg, placed, cfg, opt, d.num_nodes,
        )
        np.testing.assert_allclose(
            float(got_loss), float(ref_loss), rtol=1e-5, atol=1e-6
        )
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5
            ),
            got_p, ref_p,
        )


class TestTrialSharding:
    def test_sweep_parallel_matches_replicated(self, mesh, rng):
        """Trial-axis sharding over the mesh must not change the math:
        train_scan_trials gives identical per-trial val AUCs with sharded
        and replicated placements."""
        import optax

        from linkpred.data.twowl import build_twowl_data
        from linkpred.models import twowl as m
        from linkpred.parallel import dp

        n = 30
        pairs = np.stack(
            [rng.integers(0, n, 120), rng.integers(0, n, 120)], axis=1
        )
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        d = build_twowl_data(pairs, n, rng=rng)
        cfg = m.TwoWLConfig(max_degree=d.max_degree, channels_1wl=8,
                            channels_2wl=8, depth1=1, depth2=1)
        T, E = 8, 3
        params = m.init_params_trials(jax.random.PRNGKey(0), cfg, T)
        opt = optax.adam(1.0)
        ostate = opt.init(params)
        lrs = jnp.full((T,), 0.01, jnp.float32)
        rates = m.TrialRates(*[jnp.zeros((T,), jnp.float32)] * 4)
        trn = m.SplitArrays.from_split(d.train)
        val = m.SplitArrays.from_split(d.val)
        npp = d.train.num_msg // 2
        nnp = len(d.train.pred) // 2
        P = min(len(d.val.y), npp, nnp)
        pos = jnp.asarray(np.stack(
            [rng.permutation(npp)[:P] for _ in range(E)]).astype(np.int32))
        neg = jnp.asarray(np.stack(
            [rng.permutation(nnp)[:P] for _ in range(E)]).astype(np.int32))

        def run(p, o, l, r):
            out = m.train_scan_trials(
                p, o, jax.random.PRNGKey(1), pos, neg, trn, val,
                jnp.asarray(d.val.y), jnp.asarray(d.node_deg),
                cfg, opt, l, n, E, r)
            return np.asarray(out[3])

        ref = run(params, ostate, lrs, rates)
        sharded = dp.shard_twowl_trials(mesh, params, ostate, lrs, rates)
        got = run(*sharded)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


class TestNodeShardedSymVJP:
    def test_gradient_matches_dense(self, mesh, rng):
        """`spmm_node_sharded_sym`'s gather-only backward (valid because the
        symmetric-normalized adjacency is its own transpose) must produce
        the same gradient as autodiff through a dense A @ x."""
        import dataclasses

        from linkpred.parallel.spmm_shard import (
            build_node_sharded_buckets,
            spmm_node_sharded_sym,
        )

        n = 61
        pairs = np.stack(
            [rng.integers(0, n, 250), rng.integers(0, n, 250)], axis=1
        )
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        g = Graph.from_undirected_edges(pairs[:, 0], pairs[:, 1], num_nodes=n)
        d = np.asarray(g.degree, np.float64) + 1.0
        inv = (1.0 / np.sqrt(d)).astype(np.float32)
        w = inv[:, None] * inv[np.asarray(g.nbr)]
        g = dataclasses.replace(g, nbr_weight=np.ascontiguousarray(w))
        rows, _, stacked = build_node_sharded_buckets(g, mesh.shape["edge"])
        stacked_j = tuple(jnp.asarray(a) for a in stacked)
        x = rng.standard_normal((n, 8)).astype(np.float32)
        t = rng.standard_normal((n, 8)).astype(np.float32)

        def loss_sharded(xx):
            out = spmm_node_sharded_sym(mesh, xx, n, rows, stacked_j)
            return jnp.sum(out * t)

        a = np.zeros((n, n), np.float32)
        nbr, m = np.asarray(g.nbr), np.asarray(g.nbr_mask)
        for i in range(n):
            a[i, nbr[i][m[i]]] = w[i][m[i]]

        def loss_dense(xx):
            return jnp.sum((jnp.asarray(a) @ xx) * t)

        gs = np.asarray(jax.grad(loss_sharded)(jnp.asarray(x)))
        gd = np.asarray(jax.grad(loss_dense)(jnp.asarray(x)))
        np.testing.assert_allclose(gs, gd, rtol=1e-4, atol=1e-4)

    def test_gradient_capped_hubs(self, mesh, rng):
        """Regression for the round-2 advisor finding: a degree cap applied
        per-orientation breaks A == A^T on hub graphs, and the gather-only
        backward of `spmm_node_sharded_sym` then returns ~90%-wrong
        gradients. The symmetric cap (drop whole undirected pairs) must
        keep the custom-VJP gradient equal to dense autodiff on a hub
        graph whose every hub is over the cap."""
        import dataclasses

        from linkpred.parallel.spmm_shard import (
            build_node_sharded_buckets,
            spmm_node_sharded_sym,
        )

        n, cap = 80, 6
        # 4 hubs connected to everything + random tail edges
        hubs = np.arange(4)
        u = np.concatenate([np.repeat(hubs, n - 1),
                            rng.integers(0, n, 120)])
        v = np.concatenate([np.tile(np.arange(1, n), 4) % n,
                            rng.integers(0, n, 120)])
        keep = u != v
        g = Graph.from_undirected_edges(u[keep], v[keep], num_nodes=n)
        g = g.with_degree_cap(cap, rng=np.random.default_rng(7),
                              symmetric=True)
        assert int(g.degree.max()) <= cap
        # symmetric pattern: (i,j) present iff (j,i) present
        a_bool = g.has_edge_matrix()
        assert (a_bool == a_bool.T).all()

        d = np.asarray(g.degree, np.float64) + 1.0
        inv = (1.0 / np.sqrt(d)).astype(np.float32)
        w = inv[:, None] * inv[np.asarray(g.nbr)]
        g = dataclasses.replace(g, nbr_weight=np.ascontiguousarray(w))
        rows, _, stacked = build_node_sharded_buckets(g, mesh.shape["edge"])
        stacked_j = tuple(jnp.asarray(a) for a in stacked)
        x = rng.standard_normal((n, 8)).astype(np.float32)
        t = rng.standard_normal((n, 8)).astype(np.float32)

        def loss_sharded(xx):
            out = spmm_node_sharded_sym(mesh, xx, n, rows, stacked_j)
            return jnp.sum(out * t)

        a = np.zeros((n, n), np.float32)
        nbr, m = np.asarray(g.nbr), np.asarray(g.nbr_mask)
        for i in range(n):
            a[i, nbr[i][m[i]]] = w[i][m[i]]

        def loss_dense(xx):
            return jnp.sum((jnp.asarray(a) @ xx) * t)

        gs = np.asarray(jax.grad(loss_sharded)(jnp.asarray(x)))
        gd = np.asarray(jax.grad(loss_dense)(jnp.asarray(x)))
        np.testing.assert_allclose(gs, gd, rtol=1e-4, atol=1e-4)


class TestCollabScaleTraining:
    def test_end_to_end_tiny(self):
        """End-to-end collab-scale trainer (BASELINE config 5) at toy size
        on the CPU mesh: loss decreases and held-out AUC beats chance."""
        from linkpred.pipelines.gcn_scale import (
            ScaleGCNConfig,
            train_collab,
        )

        out = train_collab(
            ScaleGCNConfig(nodes=800, edges=3200, steps=25, batch_edges=256,
                           emb_dim=16, hidden=32, max_degree=16, dtype="f32"),
            verbose=False,
        )
        assert out["loss_decreased"], out
        assert out["test_auc"] > 0.55, out

    def test_end_to_end_tiny_bf16(self):
        """The DEFAULT (bf16 aggregation) dtype must also converge — the
        round-2 bench caught the benched config diverging while only the
        f32 tiny config was tested. bench.py's collab gate now hard-fails
        on divergence; this is the CI-side guard at toy size."""
        from linkpred.pipelines.gcn_scale import (
            ScaleGCNConfig,
            train_collab,
        )

        out = train_collab(
            ScaleGCNConfig(nodes=800, edges=3200, steps=25, batch_edges=256,
                           emb_dim=16, hidden=32, max_degree=16,
                           dtype="bf16"),
            verbose=False,
        )
        assert out["loss_decreased"], out
        assert out["test_auc"] > 0.55, out


class TestPipelinedOverlapSpMM:
    def test_matches_unpipelined(self, mesh, rng):
        """Feature-chunked overlap variant must equal the GSPMD-assembled
        path and the dense reference for every chunk count."""
        from linkpred.parallel.spmm_shard import (
            build_node_sharded_buckets,
            spmm_node_sharded,
            spmm_node_sharded_pipelined,
        )

        n = 77
        pairs = np.stack(
            [rng.integers(0, n, 300), rng.integers(0, n, 300)], axis=1
        )
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        g = Graph.from_undirected_edges(pairs[:, 0], pairs[:, 1], num_nodes=n)
        x = rng.standard_normal((n, 16)).astype(np.float32)
        rows, _, stacked = build_node_sharded_buckets(g, mesh.shape["edge"])
        sj = tuple(jnp.asarray(a) for a in stacked)
        ref = np.asarray(
            spmm_node_sharded(mesh, jnp.asarray(x), n, rows, *sj)
        )
        np.testing.assert_allclose(ref, g.dense_adjacency() @ x,
                                   rtol=1e-4, atol=1e-4)
        for chunks in (1, 2, 4):
            out = np.asarray(spmm_node_sharded_pipelined(
                mesh, jnp.asarray(x), n, rows, *sj, chunks=chunks
            ))
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


class TestCollabHaloTraining:
    def test_end_to_end_halo_community(self):
        """End-to-end training with the halo-exchange aggregation on a
        community graph over the 8-device mesh: the boundary-only
        collective path must converge exactly like the replicated-x path."""
        from linkpred.pipelines.gcn_scale import (
            ScaleGCNConfig,
            train_collab,
        )

        out = train_collab(
            ScaleGCNConfig(nodes=800, edges=3200, steps=25, batch_edges=256,
                           emb_dim=16, hidden=32, max_degree=16, dtype="f32",
                           aggregation="halo", graph="community"),
            verbose=False,
        )
        assert out["aggregation"] == "halo"
        assert out["loss_decreased"], out
        assert out["test_auc"] > 0.55, out

    def test_single_shard_fast_path_matches_mesh(self):
        """n_shards==1 routes through spmm_bucketed_sym (no shard_map);
        same seed must produce the same training trajectory as the mesh
        path on one device."""
        from linkpred.parallel.mesh import make_mesh
        from linkpred.pipelines.gcn_scale import (
            ScaleGCNConfig,
            train_collab,
        )

        cfg = ScaleGCNConfig(nodes=400, edges=1600, steps=10,
                             batch_edges=128, emb_dim=8, hidden=16,
                             max_degree=8, dtype="f32")
        a = train_collab(cfg, mesh=make_mesh(n_devices=1, shape=(1, 1)),
                         verbose=False)
        assert a["shards"] == 1
        assert np.isfinite(a["loss_last_quarter"])
        # trajectory equality vs the 2-shard mesh path (same math)
        b = train_collab(cfg, mesh=make_mesh(n_devices=2, shape=(1, 2)),
                         verbose=False)
        np.testing.assert_allclose(a["loss_last_quarter"],
                                   b["loss_last_quarter"], rtol=2e-3)

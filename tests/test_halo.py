"""Halo-exchange node-sharded SpMM: numerics, gradients, traffic bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from linkpred.data.graph import Graph
from linkpred.parallel.halo import HaloLayout, spmm_halo, spmm_halo_sym
from linkpred.parallel.mesh import make_mesh


def _rand_sym_graph(rng, n=400, e=1600):
    lo = rng.integers(0, n, e)
    hi = rng.integers(0, n, e)
    keep = lo != hi
    g = Graph.from_undirected_edges(lo[keep], hi[keep], num_nodes=n)
    # symmetric normalization (what gcn_scale feeds the kernel)
    d = np.asarray(g.degree, np.float64) + 1.0
    inv_sqrt = (1.0 / np.sqrt(d)).astype(np.float32)
    w = inv_sqrt[:, None] * inv_sqrt[np.asarray(g.nbr)]
    import dataclasses

    return dataclasses.replace(g, nbr_weight=np.ascontiguousarray(w))


def _rand_sym_graph_from(lo, hi, n):
    import dataclasses

    g = Graph.from_undirected_edges(lo, hi, num_nodes=n)
    d = np.asarray(g.degree, np.float64) + 1.0
    inv_sqrt = (1.0 / np.sqrt(d)).astype(np.float32)
    w = inv_sqrt[:, None] * inv_sqrt[np.asarray(g.nbr)]
    return dataclasses.replace(g, nbr_weight=np.ascontiguousarray(w))


def _dense_ref(g, x_old):
    """Dense aggregation in OLD node order."""
    n = g.num_nodes
    a = np.zeros((n, n), np.float64)
    w = g.nbr_weight
    for v in range(n):
        for s in range(g.nbr.shape[1]):
            if g.nbr_mask[v, s]:
                a[v, g.nbr[v, s]] += w[v, s]
    return a @ x_old


class TestHaloSpmm:
    @pytest.mark.parametrize("reorder", [True, False])
    def test_matches_dense(self, rng, reorder):
        g = _rand_sym_graph(rng)
        mesh = make_mesh(shape=(1, 8))
        layout = HaloLayout.build(g, 8, reorder=reorder)
        x_old = rng.standard_normal((g.num_nodes, 16)).astype(np.float32)
        x_new = jnp.asarray(x_old[layout.order])
        out = np.asarray(spmm_halo(
            mesh, x_new, g.num_nodes, layout.rows_per_shard,
            layout.ghost_capacity, *layout.operands()))
        ref = _dense_ref(g, x_old)[layout.order]
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)

    def test_locality_ordering_shrinks_halo_banded(self, rng):
        """Auto ordering must collapse the exchange on a banded graph
        (ring of chained blocks — the RCM-favoring regime) despite
        scrambled input labels."""
        blocks, bs = 16, 25
        pairs = []
        for b in range(blocks):
            base = b * bs
            for i in range(bs):
                for j in range(i + 1, min(i + 4, bs)):
                    pairs.append((base + i, base + j))
            pairs.append((base + bs - 1, ((b + 1) % blocks) * bs))
        pairs = np.asarray(pairs)
        n = blocks * bs
        perm = rng.permutation(n)  # scramble labels
        g = Graph.from_undirected_edges(
            perm[pairs[:, 0]], perm[pairs[:, 1]], num_nodes=n)
        # hub replication off: isolate the ORDERING effect (hubs would
        # absorb the multi-referenced rows of the raw ordering too)
        lay = HaloLayout.build(g, 8, reorder=True, hub_min_refs=None)
        lay_raw = HaloLayout.build(g, 8, reorder=False, hub_min_refs=None)
        assert lay.ghost_capacity * 3 < lay_raw.ghost_capacity, (
            lay.ghost_capacity, lay_raw.ghost_capacity)
        # capacity (hence collective bytes) must be a small fraction of N
        assert lay.ghost_capacity < n // 8

    def test_locality_ordering_shrinks_halo_community(self):
        """Auto ordering must rediscover shuffled communities (the
        label-prop-favoring regime) and cut halo traffic accordingly."""
        from benchmarks.scaling import synth_community_graph

        n = 8000
        lo, hi = synth_community_graph(n, 32000, n_comm=32, seed=3)
        g = Graph.from_undirected_edges(lo, hi, num_nodes=n)
        lay = HaloLayout.build(g, 8, reorder=True, hub_min_refs=None)
        lay_raw = HaloLayout.build(g, 8, reorder=False, hub_min_refs=None)
        assert lay.edge_cut * 2 < lay_raw.edge_cut, (
            lay.edge_cut, lay_raw.edge_cut)
        assert lay.ghost_capacity * 2 < lay_raw.ghost_capacity, (
            lay.ghost_capacity, lay_raw.ghost_capacity)

    def _hubby_graph(self, rng, n_base=4000, n_hubs=600, hub_deg=48):
        """Community graph plus genuine global hubs: every hub connects
        to random nodes across all communities, so hub rows are
        referenced by (nearly) every shard."""
        from benchmarks.scaling import synth_community_graph

        lo, hi = synth_community_graph(n_base, 4 * n_base, n_comm=16,
                                       seed=3)
        n = n_base + n_hubs
        hub_u = np.repeat(np.arange(n_base, n), hub_deg)
        hub_v = rng.integers(0, n_base, len(hub_u))
        lo = np.concatenate([lo, np.minimum(hub_u, hub_v)])
        hi = np.concatenate([hi, np.maximum(hub_u, hub_v)])
        return _rand_sym_graph_from(lo, hi, n), n

    def test_hub_auto_rule_never_worse(self, rng):
        """The auto hub rule must pick the exchange-volume argmin: never
        costlier than pairwise-only OR fixed replication thresholds.
        (Measured physics at S=8 on undirected graphs: a hub row's
        read-fan costs at most S-1 pairwise copies vs S all_gather
        copies, so replication is near-breakeven and auto usually keeps
        it off — the rule's job is to never pay for it when it loses.)"""
        g, n = self._hubby_graph(rng)

        def vol(l):
            return l.ghost_capacity + l.hub_capacity

        lay = HaloLayout.build(g, 8, reorder="cluster")
        for fixed in (None, 2, 4, 7):
            other = HaloLayout.build(g, 8, reorder="cluster",
                                     hub_min_refs=fixed)
            # small slack: auto scores candidates with the IDEAL
            # post-redeal hub_cap; the realized layout can differ by a
            # few rows
            assert vol(lay) <= vol(other) * 1.05 + 8, (
                fixed, vol(lay), vol(other))

    def test_hub_replication_numerics_match_dense(self, rng):
        """Hub-replicated aggregation must be numerically identical to
        the dense reference on a hubby graph (forced replication)."""
        from benchmarks.scaling import synth_powerlaw_graph

        n = 300
        lo, hi = synth_powerlaw_graph(n, 1500, seed=5)
        g = _rand_sym_graph_from(lo, hi, n)
        mesh = make_mesh(shape=(1, 8))
        layout = HaloLayout.build(g, 8, hub_min_refs=2)
        assert layout.num_hubs > 0
        x_old = rng.standard_normal((n, 16)).astype(np.float32)
        x_new = jnp.asarray(x_old[layout.order])
        out = np.asarray(spmm_halo(
            mesh, x_new, n, layout.rows_per_shard,
            layout.ghost_capacity, *layout.operands()))
        ref = _dense_ref(g, x_old)[layout.order]
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)

    def test_sym_vjp_padded_input_shape(self, rng):
        """Gradient of spmm_halo_sym on a PRE-PADDED [rows*S, F] input must
        come back [rows*S, F] (round-4 review: the pad guard compared
        against the cotangent's rows and silently returned [num_nodes, F])."""
        g = _rand_sym_graph(rng, n=10, e=30)
        mesh = make_mesh(shape=(1, 8))
        layout = HaloLayout.build(g, 8)
        pad_total = layout.rows_per_shard * 8
        assert pad_total > g.num_nodes
        x = jnp.asarray(
            rng.standard_normal((pad_total, 4)).astype(np.float32))

        def loss(x):
            return jnp.sum(spmm_halo_sym(
                mesh, x, g.num_nodes, layout.rows_per_shard,
                layout.ghost_capacity, layout.operands()) ** 2)

        gx = jax.grad(loss)(x)
        assert gx.shape == x.shape, (gx.shape, x.shape)
        # padded rows carry zero gradient
        np.testing.assert_allclose(
            np.asarray(gx[g.num_nodes:]), 0.0, atol=1e-7)

    def test_sym_vjp_matches_autodiff(self, rng):
        g = _rand_sym_graph(rng, n=200, e=700)
        mesh = make_mesh(shape=(1, 8))
        layout = HaloLayout.build(g, 8)
        ops = layout.operands()
        x = jnp.asarray(
            rng.standard_normal((g.num_nodes, 8)).astype(np.float32))
        t = jnp.asarray(
            rng.standard_normal((g.num_nodes, 8)).astype(np.float32))

        def loss_sym(x):
            return jnp.sum(spmm_halo_sym(
                mesh, x, g.num_nodes, layout.rows_per_shard,
                layout.ghost_capacity, ops) * t)

        def loss_plain(x):
            return jnp.sum(spmm_halo(
                mesh, x, g.num_nodes, layout.rows_per_shard,
                layout.ghost_capacity, *ops) * t)

        ga = jax.grad(loss_sym)(x)
        gb = jax.grad(loss_plain)(x)  # XLA's own VJP of the gather graph
        np.testing.assert_allclose(np.asarray(ga), np.asarray(gb),
                                   rtol=1e-4, atol=1e-4)

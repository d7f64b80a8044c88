import jax
import jax.numpy as jnp
import numpy as np
import pytest

from linkpred.data.graph import Graph
from linkpred.ops.walk import AliasTables, WalkEngine, alias_setup_rows


def test_alias_setup_distribution(rng):
    probs = np.array([[0.5, 0.2, 0.3, 0.0], [1.0, 0.0, 0.0, 0.0]])
    valid = np.array([[True, True, True, False], [True, False, False, False]])
    J, q = alias_setup_rows(probs, valid)
    # empirical draw distribution must match probs
    draws = np.zeros(3)
    r = np.random.default_rng(0)
    for _ in range(20000):
        kk = int(r.random() * 3)
        slot = kk if r.random() < q[0, kk] else J[0, kk]
        draws[slot] += 1
    np.testing.assert_allclose(draws / draws.sum(), [0.5, 0.2, 0.3], atol=0.02)


def test_walks_shape_and_validity(rng):
    u = rng.integers(0, 30, size=80)
    v = rng.integers(0, 30, size=80)
    keep = u != v
    g = Graph.from_undirected_edges(u[keep], v[keep], num_nodes=30)
    eng = WalkEngine(g, p=1.0, q=1.0)
    walks = np.asarray(eng.walks(jax.random.PRNGKey(0), num_walks=3, walk_length=10))
    assert walks.shape == (90, 10)
    has = g.has_edge_matrix()
    # every consecutive step is a real edge (or a stall at a dead end)
    for w in walks:
        for a, b in zip(w[:-1], w[1:]):
            assert a == b or has[a, b]


def test_second_order_bias():
    # path graph 0-1-2 plus triangle edge 0-2: from edge (0->1), p small
    # favors returning to 0; q small favors moving outward.
    g = Graph.from_undirected_edges([0, 1, 2], [1, 2, 0], num_nodes=3)
    import jax.numpy as jnp
    from linkpred.ops.walk import simulate_walks

    def next_counts(p, q):
        tab = AliasTables.build(g, p=p, q=q)
        eng = WalkEngine.__new__(WalkEngine)
        eng.graph = g
        starts = jnp.zeros(4000, dtype=jnp.int32)
        walks = simulate_walks(
            jax.random.PRNGKey(1),
            starts,
            jnp.asarray(g.nbr),
            jnp.asarray(g.indptr[:-1]),
            jnp.asarray(g.degree),
            jnp.asarray(tab.node_J),
            jnp.asarray(tab.node_q),
            jnp.asarray(tab.edge_J),
            jnp.asarray(tab.edge_q),
            walk_length=3,
        )
        w = np.asarray(walks)
        # fix walks that went 0 -> 1 and look at the third node
        m = w[:, 1] == 1
        third = w[m, 2]
        return (third == 0).mean(), (third == 2).mean()

    ret_low_p, _ = next_counts(p=0.1, q=1.0)
    ret_high_p, _ = next_counts(p=10.0, q=1.0)
    assert ret_low_p > 0.7  # low p -> strong return bias
    assert ret_high_p < 0.3  # high p -> avoid returning


def test_walk_starts_cover_all_nodes(rng):
    u = rng.integers(0, 20, size=60)
    v = rng.integers(0, 20, size=60)
    keep = u != v
    g = Graph.from_undirected_edges(u[keep], v[keep], num_nodes=20)
    eng = WalkEngine(g)
    walks = np.asarray(eng.walks(jax.random.PRNGKey(2), num_walks=2, walk_length=5))
    assert (walks[:, 0] == np.tile(np.arange(20), 2)).all()


class TestWeightedWalks:
    def test_weighted_alias_bias(self, rng):
        """A heavily weighted edge dominates the transition distribution."""
        import jax
        from linkpred.data.graph import Graph
        from linkpred.ops.walk import WalkEngine

        # node 0 -> {1 (w=100), 2 (w=1)}; walks from 0 should mostly hit 1
        src = np.array([0, 0, 1, 2])
        dst = np.array([1, 2, 0, 0])
        w = np.array([100.0, 1.0, 1.0, 1.0], dtype=np.float32)
        g = Graph.from_edges(src, dst, num_nodes=3, weight=w)
        eng = WalkEngine(g)
        starts = jnp.zeros(2000, dtype=jnp.int32)
        from linkpred.ops.walk import simulate_walks

        walks = np.asarray(simulate_walks(
            jax.random.PRNGKey(0), starts, eng.nbr, eng.indptr, eng.degree,
            eng.node_J, eng.node_q, eng.edge_J, eng.edge_q, 2,
        ))
        frac_to_1 = (walks[:, 1] == 1).mean()
        assert frac_to_1 > 0.95  # expect ~100/101

    def test_weighted_edgelist_loader(self, tmp_path):
        from linkpred.data.io import load_edgelist

        path = tmp_path / "w.edgelist"
        path.write_text("0 1 5.0\n1 2 1.0\n")
        g = load_edgelist(str(path), weighted=True)
        assert g.nbr_weight is not None
        assert g.nbr_weight[g.nbr_mask].max() == 5.0

import numpy as np
import pytest

from linkpred.data.graph import Graph
from linkpred.data import split as sp


def random_graph(rng, n=50, m=120):
    u = rng.integers(0, n, size=m)
    v = rng.integers(0, n, size=m)
    keep = u != v
    return u[keep], v[keep], n


def test_graph_views_consistent(rng):
    u, v, n = random_graph(rng)
    g = Graph.from_undirected_edges(u, v, num_nodes=n)
    # CSR rows match degrees
    assert g.indptr[-1] == g.num_edges
    assert (np.diff(g.indptr) == g.degree).all()
    # ELL mask row sums match degrees
    assert (g.nbr_mask.sum(axis=1) == g.degree).all()
    # symmetry: every edge has its reverse
    fw = set(zip(g.src.tolist(), g.dst.tolist()))
    assert all((d, s) in fw for s, d in fw)
    # ELL contents match CSR contents
    for i in range(n):
        csr_nbrs = sorted(g.indices[g.indptr[i] : g.indptr[i + 1]].tolist())
        ell_nbrs = sorted(g.nbr[i][g.nbr_mask[i]].tolist())
        assert csr_nbrs == ell_nbrs


def test_fb_pages_food_shape(fb_graph):
    g, edges = fb_graph
    assert g.num_nodes == 620
    assert edges.shape == (2102, 2)
    # the raw file has 11 self-loops which the Graph constructor drops
    assert g.num_edges == 2 * (2102 - 11)


def test_random_split_edges(fb_graph, rng):
    g, edges = fb_graph
    s = sp.random_split_edges(edges, g.num_nodes, 0.05, 0.1, rng)
    m = 2102 - 11  # upper-triangular dedup drops the 11 self-loops
    assert len(s.val_pos) == int(0.05 * m)
    assert len(s.test_pos) == int(0.10 * m)
    assert len(s.train_pos) == m - len(s.val_pos) - len(s.test_pos)
    assert len(s.train_neg) == len(s.train_pos)
    assert len(s.val_neg) == len(s.val_pos)
    assert len(s.test_neg) == len(s.test_pos)
    # no negative is a real edge, and no val/test neg overlaps
    real = set((min(a, b), max(a, b)) for a, b in edges.tolist())
    for neg in [s.train_neg, s.val_neg, s.test_neg]:
        for a, b in neg.tolist():
            assert (min(a, b), max(a, b)) not in real
    vt = set(map(tuple, s.val_neg.tolist())) | set(map(tuple, s.test_neg.tolist()))
    assert len(vt) == len(s.val_neg) + len(s.test_neg)


def test_negative_sampling_excludes(rng):
    pairs = np.array([[0, 1], [1, 2], [2, 3]])
    neg = sp.negative_sampling(pairs, 10, 20, rng)
    assert len(neg) == 20
    ex = set(map(tuple, pairs.tolist()))
    for a, b in neg.tolist():
        assert a < b and (a, b) not in ex
    assert len(set(map(tuple, neg.tolist()))) == 20


def test_two_hop_negatives_match_networkx(fb_graph):
    nx = pytest.importorskip("networkx")
    g, edges = fb_graph
    neg = sp.two_hop_negatives(edges, g.num_nodes)
    G = nx.Graph()
    G.add_nodes_from(range(g.num_nodes))
    G.add_edges_from(edges.tolist())
    # verify a sample against networkx shortest paths
    idx = np.random.default_rng(0).permutation(len(neg))[:200]
    for a, b in neg[idx].tolist():
        assert not G.has_edge(a, b)
        assert nx.shortest_path_length(G, a, b) == 2


def test_removable_positive_edges_keep_connected(fb_graph):
    nx = pytest.importorskip("networkx")
    g, edges = fb_graph
    removable = sp.removable_positive_edges(edges, g.num_nodes)
    keep = np.setdiff1d(np.arange(len(edges)), removable)
    G = nx.Graph()
    G.add_nodes_from(range(g.num_nodes))
    G.add_edges_from(edges[keep].tolist())
    assert nx.number_connected_components(G) == nx.number_connected_components(
        nx.Graph(edges.tolist())
    )
    # kept non-loop edges form a spanning forest -> size = N - #components
    ncomp = nx.number_connected_components(G)
    kept_pairs = edges[keep]
    n_loops_kept = int((kept_pairs[:, 0] == kept_pairs[:, 1]).sum())
    assert len(keep) - n_loops_kept == g.num_nodes - ncomp

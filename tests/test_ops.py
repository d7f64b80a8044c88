import jax
import jax.numpy as jnp
import numpy as np
import pytest

from linkpred.data.graph import Graph
from linkpred.ops import segment, spmm, sddmm


@pytest.fixture
def small(rng):
    n, m = 40, 150
    u = rng.integers(0, n, size=m)
    v = rng.integers(0, n, size=m)
    keep = u != v
    g = Graph.from_undirected_edges(u[keep], v[keep], num_nodes=n)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    return g, x


def dense_ref(g, x, w=None):
    a = g.dense_adjacency()
    if w is not None:
        a = a * 0
        for e, (s, d) in enumerate(zip(g.src, g.dst)):
            a[d, s] += w[e]
        return a @ x
    # out[i] = sum_{j in N(i)} x[j]; adjacency symmetric
    return a @ x


def test_spmm_coo_matches_dense(small):
    g, x = small
    out = spmm.spmm_coo(jnp.asarray(g.src), jnp.asarray(g.dst), jnp.asarray(x), g.num_nodes)
    np.testing.assert_allclose(np.asarray(out), dense_ref(g, x), rtol=1e-5, atol=1e-5)


def test_spmm_coo_weighted_masked(small, rng):
    g, x = small
    w = rng.random(g.num_edges).astype(np.float32)
    mask = rng.random(g.num_edges) > 0.3
    out = spmm.spmm_coo(
        jnp.asarray(g.src),
        jnp.asarray(g.dst),
        jnp.asarray(x),
        g.num_nodes,
        edge_weight=jnp.asarray(w),
        mask=jnp.asarray(mask),
    )
    ref = dense_ref(g, x, w * mask)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4, atol=1e-4)


def test_spmm_ell_matches_coo(small):
    g, x = small
    out_ell = spmm.spmm_ell(jnp.asarray(g.nbr), jnp.asarray(g.nbr_mask), jnp.asarray(x))
    # ELL aggregates over out-neighbors of each row; symmetric graph ->
    # equals COO aggregation by dst.
    out_coo = spmm.spmm_coo(jnp.asarray(g.src), jnp.asarray(g.dst), jnp.asarray(x), g.num_nodes)
    np.testing.assert_allclose(np.asarray(out_ell), np.asarray(out_coo), rtol=1e-5, atol=1e-5)


def test_spmm_ell_blocked(small):
    g, x = small
    a = spmm.spmm_ell(jnp.asarray(g.nbr), jnp.asarray(g.nbr_mask), jnp.asarray(x))
    b = spmm.spmm_ell_blocked(
        jnp.asarray(g.nbr), jnp.asarray(g.nbr_mask), jnp.asarray(x), block_rows=7
    )
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_degree(small):
    g, _ = small
    d = segment.degree_from_edges(jnp.asarray(g.dst), g.num_nodes)
    np.testing.assert_array_equal(np.asarray(d), g.degree.astype(np.float32))


def test_gcn_aggregate_matches_dense_norm(small):
    g, x = small
    out = spmm.gcn_aggregate(
        jnp.asarray(g.src), jnp.asarray(g.dst), jnp.asarray(x), g.num_nodes
    )
    a = g.dense_adjacency() + np.eye(g.num_nodes, dtype=np.float32)
    dinv = 1.0 / np.sqrt(a.sum(axis=1))
    ref = (dinv[:, None] * a * dinv[None, :]) @ x
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4, atol=1e-4)


def test_sddmm(small, rng):
    g, x = small
    y = rng.standard_normal(x.shape).astype(np.float32)
    out = sddmm.sddmm_coo(jnp.asarray(g.src), jnp.asarray(g.dst), jnp.asarray(x), jnp.asarray(y))
    ref = np.einsum("ef,ef->e", x[g.src], y[g.dst])
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4, atol=1e-4)


def test_segment_mean(rng):
    data = rng.standard_normal((20, 4)).astype(np.float32)
    ids = rng.integers(0, 5, size=20)
    out = segment.segment_mean(jnp.asarray(data), jnp.asarray(ids), 5)
    for s in range(5):
        m = ids == s
        if m.any():
            np.testing.assert_allclose(np.asarray(out[s]), data[m].mean(axis=0), rtol=1e-5, atol=1e-5)


def test_spmm_bucketed_matches_dense(small, rng):
    g, x = small
    # out rows follow the ELL orientation (rows = src side of Graph's ELL),
    # which for an undirected graph equals the dense symmetric aggregate
    layout = spmm.BucketedEll.from_graph(g)
    assert layout.num_edges == g.num_edges
    slots = sum(nb.size for _, nb, _ in layout.buckets)
    assert slots <= 2 * g.num_edges + 4 * g.num_nodes
    fn = jax.jit(spmm.spmm_bucketed, static_argnums=1)
    out = fn(jnp.asarray(x), g.num_nodes, *layout.operands())
    np.testing.assert_allclose(np.asarray(out), dense_ref(g, x),
                               rtol=1e-5, atol=1e-5)


def test_spmm_bucketed_weighted_and_isolated(rng):
    # graph with isolated nodes (never in any bucket -> zero rows) and
    # per-edge weights
    n = 12
    src = np.array([0, 0, 1, 3, 3, 3, 3, 3], dtype=np.int32)
    dst = np.array([1, 2, 2, 0, 1, 2, 4, 5], dtype=np.int32)
    w = rng.standard_normal(len(src)).astype(np.float32)
    g = Graph.from_edges(src, dst, num_nodes=n, weight=w)
    x = rng.standard_normal((n, 5)).astype(np.float32)
    layout = spmm.BucketedEll.from_graph(g)
    out = spmm.spmm_bucketed(jnp.asarray(x), n, *layout.operands())
    expect = np.zeros((n, 5), np.float32)
    for e in range(len(src)):
        expect[src[e]] += w[e] * x[dst[e]]
    np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-5, atol=1e-5)
    assert np.all(np.asarray(out)[6:] == 0)


def test_segment_plan_matches_segment_sum(rng):
    from linkpred.ops.segment import (
        SegmentPlan,
        segment_sum_planned,
    )

    S, R = 400, 23
    # unsorted ids with out-of-range capacity pads (== R)
    ids = rng.integers(0, R + 1, S).astype(np.int32)
    plan = SegmentPlan.build(ids, R)
    dst, inv, buckets = plan.operands()
    msgs = jnp.asarray(rng.standard_normal((S, 5)).astype(np.float32))
    out = segment_sum_planned(R, msgs, dst, inv, buckets)
    ref = segment.segment_sum(msgs, jnp.asarray(ids), R)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    # VJP equals the default autodiff of segment_sum
    g = jax.grad(lambda m: jnp.sum(
        segment_sum_planned(R, m, dst, inv, buckets) ** 2))(msgs)
    gr = jax.grad(lambda m: jnp.sum(
        segment.segment_sum(m, jnp.asarray(ids), R) ** 2))(msgs)
    np.testing.assert_allclose(np.asarray(g), np.asarray(gr),
                               rtol=1e-5, atol=1e-5)
    # vmap of grad (the refinement-sweep pattern)
    b = jnp.stack([msgs, 2 * msgs])
    gg = jax.vmap(jax.grad(lambda m: jnp.sum(
        segment_sum_planned(R, m, dst, inv, buckets) ** 2)))(b)
    np.testing.assert_allclose(np.asarray(gg[0]), np.asarray(gr),
                               rtol=1e-5, atol=1e-5)


def test_spmm_auto_regimes_match_dense(small):
    g, x = small
    dense = dense_ref(g, x)
    for force in ("bucketed", "ell"):
        out = spmm.spmm_auto(g.nbr, g.nbr_mask, jnp.asarray(x), force=force)
        np.testing.assert_allclose(np.asarray(out), dense,
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"regime {force}")


def test_spmm_auto_unknown_regime_raises(small):
    g, x = small
    for force in ("pallas", "onehot"):
        with pytest.raises(ValueError, match="unknown SpMM regime"):
            spmm.spmm_auto(g.nbr, g.nbr_mask, jnp.asarray(x), force=force)


def test_spmm_auto_default_regime_by_size(small, monkeypatch):
    """Without `force`, graphs above BUCKETED_MIN_NODES take the bucketed
    layout and smaller ones the flat ELL gather."""
    g, x = small
    calls = []
    real_bucketed, real_ell = spmm.spmm_bucketed, spmm.spmm_ell
    monkeypatch.setattr(spmm, "spmm_bucketed", lambda *a: (
        calls.append("bucketed"), real_bucketed(*a))[1])
    monkeypatch.setattr(spmm, "spmm_ell", lambda *a: (
        calls.append("ell"), real_ell(*a))[1])
    spmm.spmm_auto(g.nbr, g.nbr_mask, jnp.asarray(x))
    monkeypatch.setattr(spmm, "BUCKETED_MIN_NODES", g.num_nodes - 1)
    out = spmm.spmm_auto(g.nbr, g.nbr_mask, jnp.asarray(x))
    assert calls == ["ell", "bucketed"]
    np.testing.assert_allclose(np.asarray(out), dense_ref(g, x),
                               rtol=1e-4, atol=1e-4)


def test_ops_import_loads_no_pallas():
    """`import linkpred.ops` (and the models above it) must not pull in
    any `jax.experimental.pallas` module."""
    import os
    import subprocess
    import sys

    code = ("import sys, linkpred.ops, linkpred.models.twowl; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('jax.experimental.pallas')))")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, timeout=120,
        cwd=os.path.join(os.path.dirname(__file__), ".."))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]", out.stdout

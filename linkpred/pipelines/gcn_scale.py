"""End-to-end GCN link-prediction TRAINING at ogbl-collab scale.

BASELINE config 5 exercised as actual training, not just kernel steps: a
2-layer GCN link predictor over a ~235k-node power-law graph, node inputs
from a learnable embedding table, every aggregation node(row)-sharded over
the device mesh (`parallel.spmm_shard.spmm_node_sharded_sym` — gather-only
in BOTH directions because the symmetric-normalized adjacency is its own
transpose), edge scores = dot of endpoint representations, BCE over
pos/neg edge batches, Adam, whole schedule one `lax.scan` device program.

The reference cannot express this run at all: its largest graph is 620
nodes on one CPU (`pages/🛠️Model.py:38`), and its only distributed
component parallelizes walk generation, not GNN training
(`node2vec_spark/.../Node2vec.scala:31-61`). The behavioral contract here
is SURVEY §7 step 8 — partition the graph over the mesh, aggregate
locally, let collectives assemble rows — carried to an end-to-end
training loop with decreasing loss and a held-out test AUC.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class ScaleGCNConfig:
    nodes: int = 235_000
    edges: int = 1_280_000
    max_degree: int = 64
    emb_dim: int = 64
    hidden: int = 128
    steps: int = 60
    batch_edges: int = 8192
    test_fraction: float = 0.02
    learning_rate: float = 5e-3
    dtype: str = "bf16"  # aggregation/feature dtype; params stay f32
    seed: int = 0
    # "node_sharded": replicated-x gather path (spmm_shard) — right on a
    # single chip / small meshes. "halo": boundary-only exchange over a
    # locality ordering (parallel.halo) — the multi-host design whose
    # collective volume tracks the edge cut instead of N*F.
    aggregation: str = "node_sharded"
    graph: str = "powerlaw"  # or "community" (clustered, collab-like)
    # real-graph ingestion (`cli scale --edges-file`): an edge dump
    # (comma/whitespace, arbitrary ids — data.io.load_edge_pairs)
    # replaces the synthetic generator; nodes/edges are derived from it
    edges_file: str | None = None


def resolve_graph_source(cfg):
    """`(cfg, (lo, hi) | None)`: when `cfg.edges_file` is set, load the
    real edge dump and rewrite nodes/edges from it (shared by all three
    scale pipelines)."""
    if not getattr(cfg, "edges_file", None):
        return cfg, None
    from linkpred.data.io import load_edge_pairs

    lo, hi, n = load_edge_pairs(cfg.edges_file)
    return dataclasses.replace(cfg, nodes=n, edges=len(lo)), (lo, hi)


def build_problem(cfg: ScaleGCNConfig, pairs_override=None):
    """Collab-scale graph (synthetic or a real `edges_file` dump) +
    train/test edge split + the symmetric-normalized node-sharded
    aggregation layout.

    Returns (graph, layout, train_pos, test_pos, test_neg) — all host
    numpy; `layout` is (rows_per_shard, stacked arrays) for
    `spmm_node_sharded_sym` (built later once the mesh size is known).
    """
    from benchmarks.scaling import synth_community_graph, synth_powerlaw_graph
    from linkpred.data.graph import Graph
    from linkpred.data.split import negative_sampling

    rng = np.random.default_rng(cfg.seed)
    if pairs_override is not None:
        lo, hi = pairs_override
    else:
        synth = (synth_community_graph if cfg.graph == "community"
                 else synth_powerlaw_graph)
        lo, hi = synth(cfg.nodes, cfg.edges, seed=cfg.seed)
    pairs = np.stack([lo, hi], axis=1)
    perm = rng.permutation(len(pairs))
    n_test = int(len(pairs) * cfg.test_fraction)
    test_pos = pairs[perm[:n_test]]
    train_pos = pairs[perm[n_test:]]
    test_neg = negative_sampling(pairs, cfg.nodes, n_test, rng=rng)

    # message graph = train positives only (held-out edges invisible).
    # The cap MUST be symmetric (drop whole undirected pairs): the sharded
    # aggregation's custom VJP reuses the forward kernel as A^T, which is
    # only correct when the capped sparsity pattern is symmetric. A
    # per-orientation cap here trains with ~90% wrong gradients on hub
    # graphs (tests/test_parallel.py::TestNodeShardedSymVJP::test_gradient_capped_hubs).
    g = Graph.from_undirected_edges(
        train_pos[:, 0], train_pos[:, 1], num_nodes=cfg.nodes
    ).with_degree_cap(cfg.max_degree, rng=rng, symmetric=True)

    # symmetric GCN normalization w_ij = 1/sqrt((d_i+1)(d_j+1)) — symmetric
    # matrix, so the aggregation VJP is the same kernel (spmm_shard.py)
    d = np.asarray(g.degree, np.float64) + 1.0
    inv_sqrt = (1.0 / np.sqrt(d)).astype(np.float32)
    w = inv_sqrt[:, None] * inv_sqrt[np.asarray(g.nbr)]
    g = dataclasses.replace(g, nbr_weight=np.ascontiguousarray(w))
    return g, train_pos, test_pos, test_neg


def init_params(key, cfg: ScaleGCNConfig):
    import jax
    import jax.numpy as jnp

    k = jax.random.split(key, 5)

    def glorot(kk, shape):
        lim = float(np.sqrt(6.0 / (shape[0] + shape[1])))
        return jax.random.uniform(kk, shape, jnp.float32, -lim, lim)

    return {
        "emb": jax.random.normal(k[0], (cfg.nodes, cfg.emb_dim)) * 0.1,
        "w1": glorot(k[1], (cfg.emb_dim, cfg.hidden)),
        "w1s": glorot(k[2], (cfg.emb_dim, cfg.hidden)),
        "w2": glorot(k[3], (cfg.hidden, cfg.hidden)),
        "w2s": glorot(k[4], (cfg.hidden, cfg.hidden)),
    }


def train_collab(cfg: ScaleGCNConfig = ScaleGCNConfig(), mesh=None,
                 verbose: bool = True) -> dict:
    """Train end-to-end; returns losses, test AUC, and throughput."""
    import jax
    import jax.numpy as jnp
    import optax

    from linkpred.parallel import make_mesh
    from linkpred.parallel.halo import HaloLayout, spmm_halo_sym
    from linkpred.parallel.spmm_shard import (
        build_node_sharded_buckets,
        spmm_node_sharded_sym,
    )
    from linkpred.utils import metrics

    mesh = mesh or make_mesh(shape=(1, len(jax.devices())))
    n_shards = mesh.shape["edge"]
    dtype = jnp.bfloat16 if cfg.dtype == "bf16" else jnp.float32

    t0 = time.time()
    cfg, pairs_override = resolve_graph_source(cfg)
    g, train_pos, test_pos, test_neg = build_problem(cfg, pairs_override)
    if cfg.aggregation == "halo":
        # boundary-exchange aggregation works in the layout's RELABELED
        # node space: map every pair array through inv_perm once on the
        # host; the embedding table is per-node learnable so relabeling
        # it is a no-op beyond indexing consistency
        lay = HaloLayout.build(g, n_shards)
        remap = lay.inv_perm
        train_pos = remap[train_pos]
        test_pos = remap[test_pos]
        test_neg = remap[test_neg]
        # pass the layout arrays as jit ARGUMENTS (closure capture would
        # bake them into the program as constants)
        stacked_j = lay.operands()

        def spmm_sym(x, stacked_):
            return spmm_halo_sym(mesh, x, cfg.nodes, lay.rows_per_shard,
                                 lay.ghost_capacity, tuple(stacked_))
    elif n_shards == 1:
        # single device: skip the shard_map wrapper entirely — the plain
        # bucketed kernel with the symmetric VJP is numerically identical
        from linkpred.ops.spmm import BucketedEll, spmm_bucketed_sym

        stacked_j = BucketedEll.from_graph(g).operands()

        def spmm_sym(x, stacked_):
            return spmm_bucketed_sym(x, cfg.nodes, stacked_)
    else:
        rows, _, stacked = build_node_sharded_buckets(g, n_shards)
        stacked_j = tuple(jnp.asarray(a) for a in stacked)

        def spmm_sym(x, stacked_):
            return spmm_node_sharded_sym(mesh, x, cfg.nodes, rows, stacked_)

    build_seconds = time.time() - t0
    e_directed = g.num_edges

    rng = np.random.default_rng(cfg.seed + 1)
    B, S = cfg.batch_edges, cfg.steps
    pos_b = train_pos[rng.integers(0, len(train_pos), (S, B))].astype(np.int32)
    neg_b = rng.integers(0, cfg.nodes, (S, B, 2)).astype(np.int32)

    params = init_params(jax.random.PRNGKey(cfg.seed), cfg)
    opt = optax.adam(cfg.learning_rate)
    opt_state = opt.init(params)

    def embed_all(p, stacked_):
        x = p["emb"].astype(dtype)
        a1 = spmm_sym(x, stacked_)
        h = jax.nn.relu(a1 @ p["w1"].astype(dtype) + x @ p["w1s"].astype(dtype))
        a2 = spmm_sym(h, stacked_)
        return a2 @ p["w2"].astype(dtype) + h @ p["w2s"].astype(dtype)

    from linkpred.ops.sddmm import sddmm_coo

    def loss_fn(p, pos, neg, stacked_):
        h = embed_all(p, stacked_)
        logits = jnp.concatenate([
            sddmm_coo(pos[:, 0], pos[:, 1], h),
            sddmm_coo(neg[:, 0], neg[:, 1], h),
        ]).astype(jnp.float32)
        y = jnp.concatenate([jnp.ones((B,)), jnp.zeros((B,))])
        return optax.sigmoid_binary_cross_entropy(logits, y).mean()

    @jax.jit
    def train_scan(p, s, pos_all, neg_all, *stacked_):
        def step(carry, inp):
            p, s = carry
            pos, neg = inp
            loss, grads = jax.value_and_grad(loss_fn)(p, pos, neg, stacked_)
            upd, s = opt.update(grads, s, p)
            return (optax.apply_updates(p, upd), s), loss

        (p, s), losses = jax.lax.scan(step, (p, s), (pos_all, neg_all))
        return p, s, losses

    @jax.jit
    def test_logits(p, pairs, *stacked_):
        h = embed_all(p, stacked_)
        return sddmm_coo(pairs[:, 0], pairs[:, 1], h).astype(jnp.float32)

    from linkpred.utils.profiling import ThroughputCounter

    pos_d, neg_d = jnp.asarray(pos_b), jnp.asarray(neg_b)
    # AOT compile so compile_seconds measures compilation alone
    t0 = time.time()
    train_compiled = train_scan.lower(params, opt_state, pos_d, neg_d,
                                      *stacked_j).compile()
    compile_seconds = time.time() - t0

    # Warm execution first: the FIRST run of a freshly loaded executable
    # may pay one-time costs (operand upload, buffer allocation). The
    # timed span is the second, steady-state execution of the identical
    # pure function — the warm-time convention BASELINE.md documents for
    # every recorded Time in this repo.
    jax.block_until_ready(
        train_compiled(params, opt_state, pos_d, neg_d, *stacked_j))

    # 4 aggregation passes per step: 2 forward + 2 custom-VJP backward.
    counter = ThroughputCounter(unit="agg-edges")
    with counter.span(4 * e_directed * S):
        params, opt_state, losses = train_compiled(params, opt_state, pos_d,
                                                   neg_d, *stacked_j)
        losses = np.asarray(losses)
    train_seconds = counter.seconds

    both = np.concatenate([test_pos, test_neg]).astype(np.int32)
    scores = np.asarray(test_logits(params, jnp.asarray(both), *stacked_j))
    y = np.concatenate([np.ones(len(test_pos)), np.zeros(len(test_neg))])
    auc = metrics.roc_auc_score(y, scores)

    agg_eps = counter.rate
    first_q = float(losses[: max(S // 4, 1)].mean())
    last_q = float(losses[-max(S // 4, 1):].mean())
    out = {
        "nodes": cfg.nodes,
        "directed_edges": int(e_directed),
        "shards": int(n_shards),
        "aggregation": cfg.aggregation,
        "steps": S,
        "loss_first_quarter": first_q,
        "loss_last_quarter": last_q,
        "loss_decreased": bool(last_q < first_q),
        "losses": [float(v) for v in losses],
        "test_auc": float(auc),
        "train_seconds": round(train_seconds, 3),
        "compile_seconds": round(compile_seconds, 1),
        "build_seconds": round(build_seconds, 1),
        "steps_per_s": round(S / train_seconds, 2),
        "agg_edges_per_s": round(agg_eps),
    }
    if verbose:
        print(f"collab-scale GCN: loss {first_q:.4f} -> {last_q:.4f}, "
              f"test AUC {auc:.4f}, {out['steps_per_s']} steps/s, "
              f"{agg_eps / 1e6:.0f}M agg-edges/s on {n_shards} shard(s)")
    return out

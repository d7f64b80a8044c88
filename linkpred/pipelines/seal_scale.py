"""End-to-end SEAL at ogbl-collab scale (BASELINE configs 4/5 for family B).

The reference's SEAL data path is structurally dense — `link2subgraph`
builds an [N, N] uint8 adjacency (`SEAL/config/subgraph.py:27-31`) and
extracts one subgraph per Python-loop iteration (`:75-82`) — so it cannot
exist beyond a few thousand nodes. This pipeline is the scale redesign:

- target pairs are a SAMPLE of the edge set plus uniformly sampled
  non-edges (the full 1.2M-edge set would mean 2.4M subgraphs; sampling
  targets is how SEAL is actually run on OGB-sized graphs),
- the message graph is every edge except the held-out test positives
  (train-positive target links stay in the graph and are masked inside
  their own subgraph, `sub_adj[0,1]=0`, exactly the reference's
  per-subgraph convention `subgraph.py:137`),
- extraction runs over CSR in threaded C++
  (`data.subgraph.extract_subgraphs_csr` — O(P·K²) memory, no dense
  adjacency anywhere),
- DRNL is the batched while-loop BFS, and training/scoring reuse the same
  batched DGCNN device programs as the small pipeline
  (`models.seal.train_scan_compact`), AOT-compiled.

Features are one-hot DRNL tags (embedding off by default: at 235k nodes
the node2vec+SGNS stage dominates wall-clock and the gate measures the
SEAL-specific path; flip `use_embedding` to fuse walk features in, which
is BASELINE config 4's fused variant at small scale — see `run_seal`).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class ScaleSEALConfig:
    nodes: int = 235_000
    edges: int = 1_200_000
    target_pairs: int = 4096  # positives sampled as targets (same # negs)
    test_fraction: float = 0.1
    hop: int = 2
    max_neighbors: int = 100
    top_k_percent: float = 60.0
    learning_rate: float = 1e-4
    epochs: int = 10
    batch_size: int = 64
    use_embedding: bool = False
    emb_dim: int = 64
    seed: int = 0
    # real-graph ingestion (`cli scale --edges-file`, see gcn_scale)
    edges_file: str | None = None


def build_problem(cfg: ScaleSEALConfig, pairs_override=None):
    """Collab-scale graph (synthetic or a real `edges_file` dump),
    sampled targets, message-graph CSR."""
    from benchmarks.scaling import synth_powerlaw_graph
    from linkpred.data.graph import Graph
    from linkpred.data.split import negative_sampling

    rng = np.random.default_rng(cfg.seed)
    if pairs_override is not None:
        lo, hi = pairs_override
    else:
        lo, hi = synth_powerlaw_graph(cfg.nodes, cfg.edges, alpha=0.9,
                                      seed=cfg.seed)
    pairs = np.stack([lo, hi], axis=1)

    perm = rng.permutation(len(pairs))
    pos_idx = perm[: cfg.target_pairs]
    positives = pairs[pos_idx]
    negatives = negative_sampling(pairs, cfg.nodes, cfg.target_pairs, rng=rng)

    n_test = int(cfg.target_pairs * cfg.test_fraction)
    test_pos, train_pos = positives[:n_test], positives[n_test:]
    test_neg, train_neg = negatives[:n_test], negatives[n_test:]

    # message graph: all edges except the held-out test positives (their
    # links must be invisible); train-positive target links remain and are
    # masked per-subgraph like the reference
    keep = np.ones(len(pairs), dtype=bool)
    keep[pos_idx[:n_test]] = False
    msg = pairs[keep]
    g = Graph.from_undirected_edges(msg[:, 0], msg[:, 1],
                                    num_nodes=cfg.nodes)
    return g, (train_pos, train_neg, test_pos, test_neg)


def run_seal_scale(cfg: ScaleSEALConfig = ScaleSEALConfig(),
                   verbose: bool = True) -> dict:
    import jax
    import jax.numpy as jnp
    import optax

    from linkpred.data import subgraph as sg
    from linkpred.models import seal
    from linkpred.utils import metrics

    t0 = time.perf_counter()
    from linkpred.pipelines.gcn_scale import resolve_graph_source

    cfg, pairs_override = resolve_graph_source(cfg)
    g, (train_pos, train_neg, test_pos, test_neg) = build_problem(
        cfg, pairs_override)
    build_seconds = time.perf_counter() - t0

    all_pairs = np.concatenate([train_pos, train_neg, test_pos, test_neg])
    labels = np.concatenate([
        np.ones(len(train_pos), np.int32), np.zeros(len(train_neg), np.int32),
        np.ones(len(test_pos), np.int32), np.zeros(len(test_neg), np.int32),
    ])
    n_train = len(train_pos) + len(train_neg)
    tr = np.arange(n_train)
    te = np.arange(n_train, len(all_pairs))

    t0 = time.perf_counter()
    batch = sg.build_subgraph_batch_csr(
        all_pairs, np.asarray(g.indptr), np.asarray(g.indices), cfg.nodes,
        cfg.hop, cfg.max_neighbors, seed=cfg.seed,
    )
    extract_seconds = time.perf_counter() - t0
    subgraphs_per_s = len(all_pairs) / extract_seconds

    emb = None
    if cfg.use_embedding:
        from linkpred.models.word2vec import SGNSConfig, train_sgns
        from linkpred.ops.walk import WalkEngine

        eng = WalkEngine(g, p=1.0, q=1.0)
        walks = eng.walks(jax.random.PRNGKey(cfg.seed), num_walks=2,
                          walk_length=40)
        emb = train_sgns(
            jax.random.PRNGKey(cfg.seed + 1), walks, cfg.nodes,
            SGNSConfig(dim=cfg.emb_dim, window=10, negatives=5, epochs=1),
        ).astype(np.float32)

    threshold_k = seal.threshold_from_sizes(batch.sizes, cfg.top_k_percent)
    feature_dim = batch.tags_size + (emb.shape[1] if emb is not None else 0)

    adj_d = jnp.asarray(batch.adj)
    tags_d = jnp.asarray(batch.tags)
    nodes_d = jnp.asarray(batch.nodes)
    mask_d = jnp.asarray(batch.node_mask)
    emb_d = jnp.asarray(emb) if emb is not None else None
    y_d = jnp.asarray(labels)

    rng = np.random.default_rng(cfg.seed + 2)
    bs = min(cfg.batch_size, n_train)
    steps_per_epoch = max(n_train // bs, 1)
    batch_idx = np.concatenate([
        tr[rng.permutation(n_train)[: steps_per_epoch * bs]].reshape(
            steps_per_epoch, bs)
        for _ in range(cfg.epochs)
    ]).astype(np.int32)

    optimizer = optax.adam(cfg.learning_rate)
    key = jax.random.PRNGKey(cfg.seed)
    key, k_init, k_scan = jax.random.split(key, 3)
    params = seal.init_params(k_init, feature_dim, threshold_k)
    opt_state = optimizer.init(params)

    scan_args = (params, opt_state, k_scan, jnp.asarray(batch_idx),
                 adj_d, tags_d, nodes_d, mask_d, emb_d, y_d)
    t0 = time.perf_counter()
    train_compiled = seal.train_scan_compact.lower(
        *scan_args, tags_size=batch.tags_size, threshold_k=threshold_k,
        dropout_rate=0.5, optimizer=optimizer, num_steps=len(batch_idx),
    ).compile()
    compile_seconds = time.perf_counter() - t0

    t0 = time.perf_counter()
    params, _, losses = train_compiled(*scan_args)
    losses = np.asarray(losses)  # host read closes the timed span
    train_seconds = time.perf_counter() - t0

    te_d = jnp.asarray(te.astype(np.int32))
    scores = np.asarray(seal.predict_scores_compact(
        params, adj_d[te_d], tags_d[te_d], nodes_d[te_d], mask_d[te_d],
        emb_d, batch.tags_size, threshold_k,
    ))
    auc = metrics.roc_auc_score(labels[te], scores)

    S = len(batch_idx)
    first_q = float(losses[: max(S // 4, 1)].mean())
    last_q = float(losses[-max(S // 4, 1):].mean())
    out = {
        "nodes": cfg.nodes,
        "directed_edges": int(g.num_edges),
        "hop": cfg.hop,
        "target_pairs": int(len(all_pairs)),
        "subgraphs_per_s": round(subgraphs_per_s),
        "extract_seconds": round(extract_seconds, 2),
        "mean_subgraph_size": round(float(batch.sizes.mean()), 1),
        "tags_size": int(batch.tags_size),
        "loss_first_quarter": first_q,
        "loss_last_quarter": last_q,
        "loss_decreased": bool(last_q < first_q),
        "test_auc": float(auc),
        "train_seconds": round(train_seconds, 2),
        "compile_seconds": round(compile_seconds, 1),
        "build_seconds": round(build_seconds, 1),
        "use_embedding": cfg.use_embedding,
    }
    if verbose:
        print(f"collab-scale SEAL: {out['subgraphs_per_s']} subgraphs/s "
              f"(hop {cfg.hop}), loss {first_q:.4f} -> {last_q:.4f}, "
              f"test AUC {auc:.4f}")
    return out

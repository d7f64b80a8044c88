"""LocalWLNet (TwoWL) end-to-end training at collab scale.

The flagship best-AUC family (reference `TwoWL/model/model.py:8-96`) runs
only at fb-pages-food scale in the reference — its ei2 edge-pair structure
(`TwoWL/utils.py:36-45`) is Σ deg_in·deg_out and explodes on larger
graphs. This pipeline carries the family to ≥50k-node graphs with two
capacity bounds, both reference-sanctioned moves:

- graph degree cap (random symmetric truncation) — the Spark loader's cap
  (`Node2vec.scala:47-49`, cap 30),
- per-node ei2 product budget with uniform random truncation
  (`data.twowl.build_ei2_capped`) — the SEAL `max_neighbors` subgraph cap
  (`SEAL/config/subgraph.py:118-131`) applied to the 2-WL structure.

Training runs the SAME static-shape masked pipeline as the small-graph
path (`models.twowl.train_scan`, chunked, epoch-exact early stop); the
2-WL scatter plans simply get big. The bench gate records loss decrease
and held-out AUC like the GCN/SEAL scale gates.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class ScaleTwoWLConfig:
    nodes: int = 50_000
    edges: int = 250_000
    graph: str = "community"  # or "powerlaw"
    max_degree: int = 32
    # per-node ei2 product budget; None = exact. 128 was chosen by an AUC
    # study (benchmarks/twowl_cap_study.py: AUC delta vs exact -0.0024 at
    # 8k where exact is tractable, -0.0005 vs cap-256 at 50k; cap 64 loses
    # -0.014)
    ei2_cap_per_node: int | None = 128
    epochs: int = 96
    # epochs per scan call: chunks give progress output and the early-stop
    # check between calls; each boundary costs one host round-trip
    chunk_epochs: int = 16
    early_stop: int = 800
    # val AUC every k-th epoch (1 = reference's every-epoch cadence);
    # at scale the val forward costs as much as a train epoch, so 4 buys
    # ~40% wall with early-stop patience still epoch-denominated
    eval_every: int = 4
    val_ratio: float = 0.02
    test_ratio: float = 0.04
    channels_1wl: int = 24
    channels_2wl: int = 16
    depth1: int = 2
    depth2: int = 2
    learning_rate: float = 0.01
    # linear warmup then cosine decay over the planned epochs (0 =
    # constant lr, the reference's setting). At 50k nodes the constant-lr
    # curve is still climbing at 160 epochs; the schedule is what lands
    # the run inside a benchable epoch budget.
    warmup_epochs: int = 10
    seed: int = 0
    # Node features: "n2v" (default) = learnable per-node embedding rows
    # INITIALIZED from a node2vec/SGNS run over the train message graph —
    # the reference's node-attribute branch (`model.py:49-52`) fed the
    # way its other two families build features (walks + Word2Vec:
    # `feature_extraction.py:8-25`, `SEAL/config/data.py:35-78`), with x
    # itself learnable. A randomly-initialized free table ("free") learns
    # too slowly here: the logit is 4th-order in x (edge product, then
    # direction product), so gradients through random products are tiny —
    # measured val AUC 0.54 after 32 epochs vs the n2v-seeded start.
    # "degree" = the reference default degree-indexed table —
    # structure-only features, 33 distinct inputs at 50k nodes.
    node_feature: str = "n2v"
    n2v_walks_per_node: int = 8
    n2v_walk_length: int = 16
    n2v_epochs: int = 2
    # real-graph ingestion (`cli scale --edges-file`, see gcn_scale)
    edges_file: str | None = None
    # feature dtype for the 2-WL stack (93% of the step, gather-bound —
    # benchmarks/twowl_profile.py); bf16 halves its bytes
    compute_dtype: str = "bf16"
    # Pairs per epoch step. The reference trains one VAL-SIZED minibatch
    # per epoch (`train.py:14-23,79`) — at fb-pages scale that is ~5% of
    # the graph, but at 50k+ nodes a val-sized batch leaves the model
    # undertrained for any benchable epoch count, while the per-epoch
    # cost is dominated by the full-graph convolutions (batch only sizes
    # the target-row select). Decoupling the batch is therefore free
    # throughput; set 0 to recover strict val-sized reference semantics.
    batch_pairs: int = 8192


def build_scale_data(cfg: ScaleTwoWLConfig):
    from benchmarks.scaling import (
        synth_community_graph,
        synth_powerlaw_graph,
    )
    from linkpred.data.graph import Graph
    from linkpred.data.twowl import build_twowl_data
    from linkpred.pipelines.gcn_scale import resolve_graph_source

    cfg, pairs_override = resolve_graph_source(cfg)
    rng = np.random.default_rng(cfg.seed)
    if pairs_override is not None:
        lo, hi = pairs_override
    else:
        synth = (synth_community_graph if cfg.graph == "community"
                 else synth_powerlaw_graph)
        lo, hi = synth(cfg.nodes, cfg.edges, seed=cfg.seed)
    g = Graph.from_undirected_edges(lo, hi, num_nodes=cfg.nodes)
    g = g.with_degree_cap(cfg.max_degree, rng=rng, symmetric=True)
    pairs = np.stack([g.src, g.dst], axis=1)
    pairs = pairs[pairs[:, 0] < pairs[:, 1]]  # undirected pairs once
    return build_twowl_data(
        pairs, cfg.nodes, rng=rng,
        val_ratio=cfg.val_ratio, test_ratio=cfg.test_ratio,
        ei2_cap_per_node=cfg.ei2_cap_per_node,
    )


def _memory_summary(compiled) -> dict | None:
    """Byte counts of XLA's memory analysis of the compiled epoch scan
    (None where the backend gives none)."""
    mem = compiled.memory_analysis()
    if mem is None:
        return None
    return {k: int(getattr(mem, f"{k}_size_in_bytes")) for k in (
        "argument", "output", "temp", "alias", "generated_code")}


def run_twowl_scale(cfg: ScaleTwoWLConfig = ScaleTwoWLConfig(),
                    verbose: bool = True) -> dict:
    import jax
    import jax.numpy as jnp
    import optax

    from linkpred.models import twowl as m
    from linkpred.pipelines.twowl_pipeline import evaluate
    from linkpred.utils import metrics  # noqa: F401 (roc deps)

    t0 = time.time()
    data = build_scale_data(cfg)
    build_seconds = time.time() - t0

    free = cfg.node_feature in ("free", "n2v")
    mcfg = m.TwoWLConfig(
        max_degree=(data.num_nodes - 1) if free else data.max_degree,
        degree_feature=not free,
        channels_1wl=cfg.channels_1wl, channels_2wl=cfg.channels_2wl,
        depth1=cfg.depth1, depth2=cfg.depth2,
        # at this scale the masked minibatch is a small fraction of the
        # graph; dropout off keeps the short benched schedule stable
        dp_emb=0.0, dp_1wl0=0.0, dp_1wl1=0.0, dp_2wl=0.0,
        act0=True, act1=False,
        learning_rate=cfg.learning_rate,
        compute_dtype=cfg.compute_dtype,
    )
    key = jax.random.PRNGKey(cfg.seed)
    key, k_init = jax.random.split(key)
    params = m.init_params(k_init, mcfg)
    n2v_seconds = 0.0
    if cfg.node_feature == "n2v":
        # seed the free table from walks + SGNS over the TRAIN message
        # graph only (no held-out edges — the embedding regime of
        # reference `SEAL/config/data.py:35-78`)
        from linkpred.data.graph import Graph
        from linkpred.models.word2vec import SGNSConfig, train_sgns
        from linkpred.ops.walk import WalkEngine

        tn = time.time()
        msg = data.train.msg[::2]
        gm = Graph.from_undirected_edges(
            msg[:, 0], msg[:, 1], num_nodes=data.num_nodes)
        key, kw, ks = jax.random.split(key, 3)
        walks = WalkEngine(gm).walks(
            kw, cfg.n2v_walks_per_node, cfg.n2v_walk_length)
        emb0 = train_sgns(
            ks, np.asarray(walks), data.num_nodes,
            SGNSConfig(dim=cfg.channels_1wl, window=5,
                       epochs=cfg.n2v_epochs, batch_size=65536))
        params["emb"] = jnp.asarray(np.asarray(emb0, np.float32))
        n2v_seconds = time.time() - tn
    if cfg.warmup_epochs > 0:
        schedule = optax.schedules.warmup_cosine_decay_schedule(
            init_value=cfg.learning_rate * 0.05,
            peak_value=cfg.learning_rate,
            warmup_steps=cfg.warmup_epochs,
            decay_steps=max(cfg.epochs, cfg.warmup_epochs + 1),
            end_value=cfg.learning_rate * 0.02,
        )
        optimizer = optax.adam(schedule)
    else:
        optimizer = optax.adam(mcfg.learning_rate)
    opt_state = optimizer.init(params)

    trn = m.SplitArrays.from_split(data.train)
    val = m.SplitArrays.from_split(data.val)
    n_pos_pairs = data.train.num_msg // 2
    n_neg_pairs = len(data.train.pred) // 2
    base = cfg.batch_pairs if cfg.batch_pairs > 0 else len(data.val.y)
    # cap at 1/8 of the train positives: sample_block REMOVES the batch
    # positives from the message graph (leakage prevention), so a batch
    # comparable to the edge count would train on a near-empty graph
    P = max(1, min(base, n_pos_pairs // 8, n_neg_pairs))
    # round DOWN to whole chunks: a ragged final chunk changes the scan
    # length and recompiles the whole 2-WL program inside the timed span
    E = max(cfg.chunk_epochs,
            (cfg.epochs // cfg.chunk_epochs) * cfg.chunk_epochs)
    rng = np.random.default_rng(cfg.seed)
    pos_ids = np.stack([
        rng.permutation(n_pos_pairs)[:P] for _ in range(E)
    ]).astype(np.int32)
    neg_ids = np.stack([
        rng.permutation(n_neg_pairs)[:P] for _ in range(E)
    ]).astype(np.int32)
    warm_excluded = E > cfg.chunk_epochs  # chunk 0 = warm-up execution
    tc0 = time.time()  # per-chunk wall marker (verbose prints)

    val_y = jnp.asarray(data.val.y)
    node_deg = (jnp.arange(data.num_nodes, dtype=jnp.int32) if free
                else jnp.asarray(data.node_deg))
    chunk = min(E, cfg.chunk_epochs)
    from linkpred.utils.progress import LiveProgress

    progress = LiveProgress(E, label="twowl-scale") if verbose else None
    best = (params, jnp.float32(0.0), jnp.int32(0))
    hists = []
    t0 = time.time()
    compile_seconds = 0.0
    memory = None
    for start in range(0, E, chunk):
        stop = min(start + chunk, E)
        key, k_scan = jax.random.split(key)
        dyn = (params, opt_state, k_scan,
               jnp.asarray(pos_ids[start:stop]),
               jnp.asarray(neg_ids[start:stop]),
               trn, val, val_y, node_deg)
        if start == 0:
            tc = time.time()
            compiled = m.train_scan.lower(
                *dyn, mcfg, optimizer, data.num_nodes, stop - start,
                init_best=best, early_stop=cfg.early_stop,
                eval_every=cfg.eval_every).compile()
            compile_seconds = time.time() - tc
            memory = _memory_summary(compiled)
            t0 = time.time()  # timed span excludes compilation
        # call the AOT executable directly (statics are baked in; every
        # chunk has identical shapes) — relying on .compile() to warm
        # jit's cache is undocumented behavior
        if start == 0 and warm_excluded:
            # warm execution: the first run of a freshly loaded
            # executable may pay one-time costs (operand upload, buffer
            # allocation); run epoch chunk 0 outside the timed span and
            # restart the clock (its epochs are excluded from the rate
            # below)
            params, opt_state, best_p, best_a, since, h = compiled(
                *dyn, init_best=best)
            jax.block_until_ready(h)
            t0 = time.time()
            tc0 = t0
        else:
            params, opt_state, best_p, best_a, since, h = compiled(
                *dyn, init_best=best)
        best = (best_p, best_a, since)
        hists.append(np.asarray(h[0]))
        if verbose:
            # live surface (reference's in-training progress + line
            # charts, `TwoWL_work.py:119-129`): per-epoch loss series of
            # the finished chunk + the running best-val sparkline
            for k, lv in enumerate(hists[-1]):
                progress.update(start + k + 1, loss=float(lv))
            progress.update(stop, auc=float(best_a))
            print(f"  epochs {start:3d}-{stop:<3d} loss "
                  f"{float(np.mean(hists[-1])):.4f} best val "
                  f"{float(best_a):.4f} [+{time.time() - tc0:.1f}s]",
                  flush=True)
            tc0 = time.time()
        if int(since) > cfg.early_stop:
            break
    losses = np.concatenate(hists)
    train_seconds = time.time() - t0
    # the rate is over the TIMED epochs only (chunk 0 is the warm-up
    # execution when more than one chunk ran)
    epochs_timed = (len(losses) - chunk) if warm_excluded else len(losses)
    epochs_timed = max(epochs_timed, 1)

    tst_auc, _ = evaluate(best[0], mcfg, data, data.test)
    q = max(len(losses) // 4, 1)
    first_q, last_q = float(losses[:q].mean()), float(losses[-q:].mean())
    out = {
        "nodes": data.num_nodes,
        "msg_edges": int(data.train.num_msg),
        "ei2_columns": int(len(data.train.e1_src)),
        "ei2_cap_per_node": cfg.ei2_cap_per_node,
        "epochs": int(len(losses)),
        "loss_first_quarter": first_q,
        "loss_last_quarter": last_q,
        "loss_decreased": bool(last_q < first_q),
        "best_val_auc": float(best[1]),
        "test_auc": float(tst_auc),
        "train_seconds": round(train_seconds, 3),
        "epochs_per_s": round(epochs_timed / max(train_seconds, 1e-9), 2),
        "compile_seconds": round(compile_seconds, 1),
        "build_seconds": round(build_seconds, 1),
        "n2v_seconds": round(n2v_seconds, 1),
        "node_feature": cfg.node_feature,
        "memory_analysis": memory,
    }
    if verbose:
        print(f"twowl-scale: {cfg.nodes} nodes, "
              f"{out['ei2_columns']} ei2 cols, loss {first_q:.4f} -> "
              f"{last_q:.4f}, test AUC {out['test_auc']:.4f}")
    return out

"""Headline benchmark + BASELINE gate capture.

Headline: TwoWL hyperparameter-sweep wall-clock vs reference. The
reference only ever trains TwoWL inside an Optuna sweep
(`TwoWL_work.py:112-132`: 10 sequential trials, mean ~133.4 s each on CPU
— `assets/time_twowl.txt`, BASELINE.md). The batched equivalent is the
trial-major sweep (`pipelines.twowl_pipeline.refine_vmapped`): 32
(lr x dropout) configurations train SIMULTANEOUSLY in one compiled
program. `value` = wall seconds for the whole 32-trial x 1000-epoch
sweep, warm; `vs_baseline` = per-trial speedup.

The `gates` field records every BASELINE.md target machine-readably on
the device this runs on: single-device SpMM edges/s + % of the device's
published HBM peak (`linkpred.utils.hardware.DEVICE_PEAKS`), walk hops/s,
SGNS tokens/s, SEAL subgraphs/s, and the end-to-end collab-scale GCN
training run (loss decrease + agg-edges/s). Each gate is individually
guarded — a gate failure records an error string instead of killing the
headline metric.

Prints ONE JSON line, which names the device it ran on.
"""

import json
import time

REFERENCE_TRAIN_SECONDS = 133.4  # mean per-trial, assets/time_twowl.txt
REFERENCE_BEST_AUC = 0.8947
SWEEP_TRIALS = 32


def _gate(gates: dict, name: str, fn, deadline: float):
    import sys

    if time.perf_counter() > deadline:
        gates[name] = {"skipped": "gate time budget exhausted"}
        return
    print(f"[bench] gate {name}...", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    try:
        gates[name] = fn()
    except Exception as e:  # record, don't kill the headline
        gates[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
    gates[name]["gate_seconds"] = round(time.perf_counter() - t0, 1)
    # full (verbose) record to stderr; the stdout line stays compact so
    # the driver's bounded tail capture never truncates the headline
    print(f"[bench] {json.dumps({name: gates[name]})}",
          file=sys.stderr, flush=True)


# keys that matter for the machine-readable gate line; everything else
# (explanatory notes, redundant derived numbers) lives in the stderr dump
_VERBOSE_KEYS = ("note", "gensim_cited_words_per_s", "host_measured_kind",
                 "actual_gb_s", "gather_rows_per_s",
                 "kernel_slot_rows_per_s", "gather_roofline_gb_s",
                 "full_gather_bytes", "build_seconds")


def _compact(obj):
    if isinstance(obj, dict):
        return {k: _compact(v) for k, v in obj.items()
                if k not in _VERBOSE_KEYS}
    return obj


def collab_graph(nodes=235_000, edges=1_280_000, max_degree=64):
    import numpy as np

    from benchmarks.scaling import synth_powerlaw_graph
    from linkpred.data.graph import Graph

    lo, hi = synth_powerlaw_graph(nodes, edges, alpha=0.9, seed=0)
    g = Graph.from_undirected_edges(lo, hi, num_nodes=nodes)
    return g.with_degree_cap(max_degree, rng=np.random.default_rng(1))


def sweep_problem(seed: int = 0):
    """(data, cfg) of the headline sweep: fb-pages-food split and the
    reference's best-trial architecture."""
    import numpy as np

    from linkpred.data import io
    from linkpred.data.twowl import build_twowl_data
    from linkpred.models import twowl as m

    _, edges = io.load_fb_pages_food()
    n = int(edges.max()) + 1
    data = build_twowl_data(edges, n, rng=np.random.default_rng(seed))
    cfg = m.TwoWLConfig(
        max_degree=data.max_degree,
        channels_1wl=24, channels_2wl=16, depth1=2, depth2=2,
        dp_emb=0.5, dp_1wl0=0.2, dp_1wl1=0.4, dp_2wl=0.1,
        act0=True, act1=False, learning_rate=0.01,
    )
    return data, cfg


def device_record() -> dict:
    """What every result line names: platform, kind and count of the JAX
    devices, and the card's name and power limit from nvidia-smi."""
    import jax

    from linkpred.utils.hardware import gpu_name_and_power_limit

    d = jax.devices()
    return {"platform": d[0].platform, "device_kind": d[0].device_kind,
            "devices": len(d), "nvidia_smi": gpu_name_and_power_limit()}


def gate_spmm(g, feats=128):
    """Single-device aggregation edges/s at collab scale, f32 + bf16, vs
    the device's published HBM peak (BASELINE 'speed-of-light SpMM')."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from benchmarks.scaling import bench_chained
    from linkpred.ops import spmm
    from linkpred.utils.hardware import device_peaks

    peak_gbs = device_peaks(jax.devices()[0].device_kind)["hbm_gbs"]
    e, n = g.num_edges, g.num_nodes
    layout = spmm.BucketedEll.from_graph(g)
    ops = layout.operands()
    slots = sum(int(b[1].size) for b in layout.buckets)
    out = {"nodes": n, "directed_edges": int(e), "feats": feats,
           "padded_slots": slots}
    x32 = jnp.asarray(np.random.default_rng(2).standard_normal(
        (n, feats)).astype(np.float32))
    # roofline = chained SELF-gather: a [slots, F] table permuted by random
    # row indices so the output is carry-shape-stable inside
    # bench_chained's fori_loop (a [n, F]-table gather would emit
    # [slots, F] and break the carry)
    idx = jnp.asarray(np.random.default_rng(3).integers(
        0, slots, slots).astype(np.int32))
    g32 = jnp.asarray(np.random.default_rng(4).standard_normal(
        (slots, feats)).astype(np.float32))

    @jax.jit
    def row_gather(x, idx):
        return x[idx]

    for dtype, b, tag in ((jnp.float32, 4, "f32"), (jnp.bfloat16, 2, "bf16")):
        x = x32.astype(dtype)
        # dtype-matched achievable ceiling: a bare random row gather of the
        # SAME slot count and row size the kernel performs
        dt_g = bench_chained(row_gather, g32.astype(dtype), idx, k=40)
        gather_traffic = slots * feats * b + slots * 4 + slots * feats * b
        gather_gbs = gather_traffic / dt_g / 1e9
        dt = bench_chained(
            lambda x, *o: spmm.spmm_bucketed(x, n, *o), x, *ops, k=40)
        # true-edge traffic (the conventional "effective" number) and the
        # kernel's ACTUAL slot traffic (what the hardware really moves)
        traffic = e * feats * b + e * 4 + n * feats * b
        actual = slots * feats * b + slots * (4 + b) + n * feats * b
        gbs = traffic / dt / 1e9
        out[f"bucketed_{tag}"] = {
            "edges_per_s": round(e / dt),
            "eff_gb_s": round(gbs, 1),
            "actual_gb_s": round(actual / dt / 1e9, 1),
            "pct_hbm_peak": round(100 * gbs / peak_gbs, 1),
            "gather_roofline_gb_s": round(gather_gbs, 1),
            # the kernel must fetch `slots` random rows; the bare gather
            # fetches AND writes them, so >100% means the kernel's fused
            # reduce beats the literal gather+materialize
            "gather_rows_per_s": round(slots / dt_g),
            "kernel_slot_rows_per_s": round(slots / dt),
            "pct_gather_roofline": round(100 * dt_g / dt, 1),
        }
    return out


def gate_walks(g, walkers=65_536, length=16):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from benchmarks.scaling import bench
    from linkpred.ops.walk import WalkEngine, simulate_walks

    eng = WalkEngine(g)
    starts = jnp.asarray(np.random.default_rng(3).integers(
        0, g.num_nodes, walkers).astype(np.int32))
    dt = bench(lambda: simulate_walks(
        jax.random.PRNGKey(0), starts, eng.nbr, eng.indptr, eng.degree,
        eng.node_J, eng.node_q, eng.edge_J, eng.edge_q, length))
    return {"hops_per_s": round(walkers * (length - 1) / dt),
            "walkers": walkers, "walk_length": length}


def gate_sgns(num_nodes=235_000, walk_length=16):
    """SGNS throughput vs a MEASURED on-host gensim-class baseline.

    Device number: the steady-state jit loop, waited for with
    `block_until_ready` (the [N, dim] table stays on device for downstream
    pair-feature gathers).
    Baseline: `native.sgns_train_ref`, a faithful C++ hogwild
    reimplementation of the gensim training loop the reference uses
    (`feature_extraction.py:17`, workers=8 C threads), run on THIS host's
    cores over the same corpus distribution, beside gensim's published
    450k words/s (8 cores).
    """
    import jax
    import numpy as np

    from linkpred import native
    from linkpred.models.word2vec import (
        SGNSConfig, prepare_sgns, train_sgns_device)

    walks = np.random.default_rng(5).integers(
        0, num_nodes, (65536, walk_length), dtype=np.int32)
    cfg = SGNSConfig(dim=128, epochs=1, batch_size=65536)
    prep = prepare_sgns(walks, num_nodes, cfg)

    def run(seed):
        w = train_sgns_device(
            jax.random.PRNGKey(seed), walks, num_nodes, cfg, prep=prep)
        jax.block_until_ready(w)  # table stays device-resident
    run(7)
    t0 = time.perf_counter()
    run(17)
    dt = time.perf_counter() - t0
    pairs = walks.size * cfg.window * 2 * cfg.epochs  # candidate pairs
    tok_s = round(walks.size * cfg.epochs / dt)

    out = {"tokens_per_s_device": tok_s,
           "pairs_per_s_device": round(pairs / dt),
           "host_prep_s": round(prep.prep_seconds, 3),
           "gensim_cited_words_per_s": 450_000,
           "beats_gensim_cited": bool(tok_s > 450_000)}
    if native.available():
        # measured on-host baseline on a 1/4 corpus (bounds gate time);
        # words/s is corpus-size independent at fixed vocab
        t0 = time.perf_counter()
        _, trained = native.sgns_train_ref(
            walks[:16384], num_nodes, dim=128, epochs=1)
        ref_dt = time.perf_counter() - t0
        host = round(trained / ref_dt)
        out["host_measured_words_per_s"] = host
        out["host_measured_kind"] = (
            "native/graphlib.cpp sgns_train_ref (gensim loop, hogwild, "
            "all host cores)")
        out["beats_host_measured"] = bool(tok_s > host)
    return out


def gate_seal(num_nodes=235_000):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from linkpred.models import seal

    P, K = 2048, 50
    rs = np.random.default_rng(6)
    adj = (rs.random((P, K, K)) < 0.08).astype(np.uint8)
    adj = np.maximum(adj, adj.transpose(0, 2, 1))
    tags = rs.integers(0, 20, (P, K)).astype(np.int32)
    nodes = rs.integers(0, num_nodes, (P, K)).astype(np.int32)
    mask = np.ones((P, K), bool)
    ys = rs.integers(0, 2, P).astype(np.int32)
    emb = jnp.asarray(rs.standard_normal((num_nodes, 32)).astype(np.float32))
    sp = seal.init_params(jax.random.PRNGKey(8), 20 + 32, 30)
    opt = optax.adam(1e-4)
    state = opt.init(sp)
    steps, bsz = 8, 256
    bidx = jnp.asarray(rs.integers(0, P, (steps, bsz)).astype(np.int32))
    args = (sp, state, jax.random.PRNGKey(9), bidx, jnp.asarray(adj),
            jnp.asarray(tags), jnp.asarray(nodes), jnp.asarray(mask),
            emb, jnp.asarray(ys), 20, 30, 0.5, opt, steps)
    seal.train_scan_compact(*args)[2].block_until_ready()  # compile
    t0 = time.perf_counter()
    jax.block_until_ready(seal.train_scan_compact(*args)[2])
    dt = time.perf_counter() - t0
    return {"subgraphs_per_s": round(steps * bsz / dt), "batch": bsz,
            "subgraph_nodes": K}


def gate_collab_e2e():
    from linkpred.pipelines.gcn_scale import ScaleGCNConfig, train_collab

    # steps=60 amortizes the per-call dispatch into the steady-state rate;
    # lr 3e-3 because the 5e-3 default overfits the embedding table past
    # ~40 steps at this schedule length
    out = train_collab(ScaleGCNConfig(steps=60, learning_rate=3e-3),
                       verbose=False)
    res = {k: out[k] for k in (
        "nodes", "directed_edges", "shards", "loss_first_quarter",
        "loss_last_quarter", "loss_decreased", "test_auc", "steps_per_s",
        "agg_edges_per_s", "train_seconds", "compile_seconds")}
    # The flagship scale claim HARD-FAILS if training diverges at the
    # benched config (an asymmetric degree cap once corrupted the
    # symmetric-SpMM VJP without failing anything; see data/graph.py
    # with_degree_cap).
    if not res["loss_decreased"]:
        raise RuntimeError(f"collab e2e training DIVERGED: {json.dumps(res)}")
    return res


def gate_twowl_scale():
    """End-to-end LocalWLNet at 50k nodes — the flagship family at scale.
    Default pipeline config: n2v-seeded free embeddings, paired fused
    2-WL path, bf16 2-WL stack, cap-128 ei2, warmup-cosine, 96 epochs.
    Hard-fails on divergence like the other scale gates."""
    from linkpred.pipelines.twowl_scale import (
        ScaleTwoWLConfig,
        run_twowl_scale,
    )

    res = run_twowl_scale(ScaleTwoWLConfig(), verbose=False)
    if not res["loss_decreased"]:
        raise RuntimeError(f"twowl scale DIVERGED: {json.dumps(res)}")
    res["meets_auc_0p85_gate"] = bool(res["test_auc"] >= 0.85)
    return res


def gate_collab_seal():
    """End-to-end SEAL at collab scale (BASELINE configs 4/5 for family B):
    CSR extraction + host-plane DRNL + batched DGCNN training on sampled
    target pairs of a 235k-node graph. Hard-fails on divergence like the
    GCN gate."""
    from linkpred.pipelines.seal_scale import (
        ScaleSEALConfig,
        run_seal_scale,
    )

    out = run_seal_scale(ScaleSEALConfig(target_pairs=2048, epochs=8),
                         verbose=False)
    res = {k: out[k] for k in (
        "nodes", "directed_edges", "hop", "target_pairs", "subgraphs_per_s",
        "extract_seconds", "mean_subgraph_size", "loss_first_quarter",
        "loss_last_quarter", "loss_decreased", "test_auc", "train_seconds",
        "compile_seconds")}
    if not res["loss_decreased"]:
        raise RuntimeError(f"collab SEAL training DIVERGED: {json.dumps(res)}")
    return res


def main():
    import os

    from linkpred.utils.hardware import enable_compile_cache

    enable_compile_cache()

    from linkpred.pipelines.twowl_pipeline import (
        TwoWLRunConfig,
        refine_vmapped,
    )

    data, cfg = sweep_problem()
    # warm-up: compile the chunked sweep scan out of the timed region
    # (identical shapes; chunk compiles once and is reused)
    refine_vmapped(data, cfg, TwoWLRunConfig(epochs=1000),
                   n_trials=SWEEP_TRIALS, verbose=False)

    t0 = time.perf_counter()
    res = refine_vmapped(data, cfg, TwoWLRunConfig(epochs=1000),
                         n_trials=SWEEP_TRIALS, verbose=False)
    seconds = time.perf_counter() - t0
    per_trial = seconds / SWEEP_TRIALS

    gates = {}
    if not os.environ.get("BENCH_SKIP_GATES"):
        # highest-evidence gates EXECUTE first within a hard budget (if it
        # runs out, the convergence proofs and the SpMM numbers are
        # already in the artifact); unfinished gates record a 'skipped'
        # marker instead of truncating stdout
        deadline = time.perf_counter() + float(
            os.environ.get("BENCH_GATE_BUDGET_S", "480"))
        g = collab_graph()
        _gate(gates, "spmm_single_chip", lambda: gate_spmm(g), deadline)
        _gate(gates, "twowl_scale", gate_twowl_scale, deadline)
        _gate(gates, "collab_e2e_training", gate_collab_e2e, deadline)
        _gate(gates, "collab_seal", gate_collab_seal, deadline)
        _gate(gates, "sgns", gate_sgns, deadline)
        _gate(gates, "walks", lambda: gate_walks(g), deadline)
        _gate(gates, "seal_step", gate_seal, deadline)

    # stdout line layout: gates lead (cheap ones first, flagship LAST so a
    # bounded tail capture keeps them), headline metric keys at the very
    # end
    display_order = ("walks", "seal_step", "sgns", "collab_seal",
                     "twowl_scale", "collab_e2e_training", "spmm_single_chip")
    gates_out = {k: _compact(gates[k]) for k in display_order if k in gates}
    gates_out.update(
        {k: _compact(v) for k, v in gates.items() if k not in gates_out})
    print(json.dumps({
        "gates": gates_out,
        **device_record(),
        "trials": SWEEP_TRIALS,
        "epochs_per_trial": 1000,
        "per_trial_seconds": round(per_trial, 3),
        "test_auc_winner": round(float(res["test_auc"]), 4),
        "best_val_auc": round(float(max(res["val_aucs"])), 4),
        "reference_per_trial_seconds": REFERENCE_TRAIN_SECONDS,
        "reference_best_auc": REFERENCE_BEST_AUC,
        "metric": "twowl_sweep32_wall_seconds",
        "unit": "s",
        "vs_baseline": round(REFERENCE_TRAIN_SECONDS / per_trial, 2),
        "value": round(seconds, 3),
    }))


if __name__ == "__main__":
    main()

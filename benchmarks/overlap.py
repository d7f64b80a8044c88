"""Collective/compute overlap A/B for the node-sharded SpMM.

Measures three variants of the mesh aggregation at a given scale:

- `gspmd`      — `spmm_node_sharded`: x replicated, out P(axis); the row
                 assembly collective is whatever GSPMD schedules.
- `pipelined1` — `spmm_node_sharded_pipelined(chunks=1)`: x row-sharded,
                 ONE explicit in-shard_map all_gather then all compute —
                 the no-overlap baseline.
- `pipelinedK` — same with K feature stripes: stripe c+1's all_gather can
                 issue while stripe c's bucket einsums run (XLA async
                 collectives) — the overlap-on arm.

On the virtual CPU mesh the collectives are memcpys on one host, so the
deltas bound scheduling overhead, not interconnect overlap; the real
signal needs several GPUs of one machine. One JSON line per variant.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=235_000)
    ap.add_argument("--edges", type=int, default=1_280_000)
    ap.add_argument("--feats", type=int, default=128)
    ap.add_argument("--max-degree", type=int, default=64)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--dtype", choices=["f32", "bf16"], default="f32")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from benchmarks.scaling import bench_chained, synth_powerlaw_graph
    from linkpred.data.graph import Graph
    from linkpred.parallel import make_mesh
    from linkpred.parallel.spmm_shard import (
        build_node_sharded_buckets,
        spmm_node_sharded,
        spmm_node_sharded_pipelined,
    )

    lo, hi = synth_powerlaw_graph(args.nodes, args.edges, alpha=0.9, seed=0)
    g = Graph.from_undirected_edges(lo, hi, num_nodes=args.nodes)
    g = g.with_degree_cap(args.max_degree, rng=np.random.default_rng(1))
    e = g.num_edges
    n_shards = len(jax.devices())
    mesh = make_mesh(shape=(1, n_shards))
    rows, _, stacked = build_node_sharded_buckets(g, n_shards)
    sj = tuple(jnp.asarray(a) for a in stacked)
    dtype = jnp.bfloat16 if args.dtype == "bf16" else jnp.float32
    x = jnp.asarray(
        np.random.default_rng(2).standard_normal(
            (args.nodes, args.feats)).astype(np.float32)).astype(dtype)
    print(json.dumps({"devices": n_shards,
                      "platform": jax.devices()[0].platform,
                      "nodes": args.nodes, "directed_edges": int(e),
                      "feats": args.feats, "dtype": args.dtype}))

    results = {}
    dt = bench_chained(
        lambda x, *ops: spmm_node_sharded(mesh, x, args.nodes, rows, *ops),
        x, *sj)
    results["gspmd"] = dt
    # row-sharded input for the explicit variants; chain keeps it sharded
    xs = jax.device_put(x, NamedSharding(mesh, P("edge")))
    for chunks, tag in ((1, "pipelined1"), (args.chunks,
                                            f"pipelined{args.chunks}")):
        dt = bench_chained(
            lambda x, *ops: spmm_node_sharded_pipelined(
                mesh, x, args.nodes, rows, *ops, chunks=chunks),
            xs, *sj)
        results[tag] = dt
    for tag, dt in results.items():
        print(json.dumps({
            "metric": f"spmm_overlap_{tag}", "seconds_per_iter": round(dt, 5),
            "edges_per_s": round(e / dt),
        }))
    print(json.dumps({
        "metric": "spmm_overlap_speedup_vs_no_overlap",
        "value": round(results["pipelined1"]
                       / results[f"pipelined{args.chunks}"], 3),
    }))


if __name__ == "__main__":
    main()

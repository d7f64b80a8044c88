"""SpMM micro-roofline: measured edges/s + effective HBM GB/s vs peak.

Times the SpMM layouts (COO+segment_sum, ELL gather, degree-bucketed
ELL) at a given graph size, plus the component ceilings (streaming
elementwise, raw row-gather), and reports effective HBM bandwidth against
the device's published peak (`linkpred.utils.hardware.DEVICE_PEAKS`, or
`--peak-gbs`). The traffic model for one SpMM: gathered feature reads
E*F*b + neighbor-id reads E*4 + output writes N*F*b.

Timing is K chained iterations inside one jit, waited for with
`block_until_ready` (`scaling.bench_chained`).

One JSON line per (layout, dtype).
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
    ap.add_argument("--peak-gbs", type=float, default=None,
                    help="HBM peak in GB/s (default: the device kind's "
                         "entry in the peak table)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from benchmarks.scaling import bench_chained, synth_powerlaw_graph
    from linkpred.data.graph import Graph
    from linkpred.ops import spmm
    from linkpred.utils.hardware import device_peaks

    kind = jax.devices()[0].device_kind
    peak_gbs = (args.peak_gbs if args.peak_gbs is not None
                else device_peaks(kind)["hbm_gbs"])

    lo, hi = synth_powerlaw_graph(args.nodes, args.edges, alpha=0.9, seed=0)
    src = np.concatenate([lo, hi])
    dst = np.concatenate([hi, lo])
    g = Graph.from_edges(src, dst, num_nodes=args.nodes).with_degree_cap(
        args.max_degree, rng=np.random.default_rng(1)
    )
    e = g.num_edges
    print(json.dumps({
        "platform": jax.devices()[0].platform, "device_kind": kind,
        "nodes": args.nodes,
        "directed_edges": int(e), "max_degree": int(g.max_degree),
        "feats": args.feats,
    }))

    nbr = jnp.asarray(g.nbr)
    mask = jnp.asarray(g.nbr_mask)
    dst_sort = np.argsort(np.asarray(g.dst), kind="stable")
    src_s = jnp.asarray(np.asarray(g.src)[dst_sort])
    dst_s = jnp.asarray(np.asarray(g.dst)[dst_sort])

    rng = np.random.default_rng(2)
    x32 = jnp.asarray(rng.standard_normal((args.nodes, args.feats)),
                      dtype=jnp.float32)
    n, f = args.nodes, args.feats

    def report(name, dt, dtype_bytes, traffic=None):
        if traffic is None:
            traffic = e * f * dtype_bytes + e * 4 + n * f * dtype_bytes
        gbs = traffic / dt / 1e9
        print(json.dumps({
            "metric": name, "edges_per_s": round(e / dt),
            "seconds_per_iter": round(dt, 5), "eff_gb_s": round(gbs, 1),
            "pct_peak": round(100 * gbs / peak_gbs, 1),
        }))

    layout = spmm.BucketedEll.from_graph(g)
    bucket_ops = layout.operands()
    print(json.dumps({
        "bucketed_slots": sum(nb.size for _, nb, _ in layout.buckets),
        "flat_ell_slots": int(nbr.size),
    }))

    for dtype, b in ((jnp.float32, 4), (jnp.bfloat16, 2)):
        x = x32.astype(dtype)
        tag = "f32" if b == 4 else "bf16"
        dt = bench_chained(
            lambda x, nbr, mask: spmm.spmm_ell(nbr, mask, x), x, nbr, mask)
        report(f"spmm_ell_{tag}", dt, b)
        dt = bench_chained(
            lambda x, s, d: spmm.spmm_coo(s, d, x, n).astype(x.dtype),
            x, src_s, dst_s)
        report(f"spmm_coo_sorted_{tag}", dt, b)
        dt = bench_chained(
            lambda x, *ops: spmm.spmm_bucketed(x, n, *ops), x, *bucket_ops)
        report(f"spmm_bucketed_{tag}", dt, b)

    # ceilings: stream + raw gather (f32)
    dt = bench_chained(lambda x: x * 1.0001, x32)
    report("stream_elementwise_f32", dt, 4, traffic=2 * n * f * 4)
    row_idx = jnp.asarray(
        rng.permutation(n).astype(np.int32))
    dt = bench_chained(lambda x, i: x[i], x32, row_idx)
    report("row_gather_f32", dt, 4, traffic=2 * n * f * 4)


if __name__ == "__main__":
    main()

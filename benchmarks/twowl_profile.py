"""Component-level timing of the TwoWL scale training epoch.

Answers "where does the epoch time go at 50k nodes" by timing isolated
pieces of the train epoch on the device:

- full train_step (fwd+bwd+adam) in degree / free-embedding modes,
- forward only (eval pass = the every-`eval_every` val AUC cost),
- a depth2=0 ablation (1-WL stack alone) to separate the 2-WL ei2 cost,
- the raw planned-gather/segment-sum primitives at the exact ei2 shape.

Prints one JSON line per measurement. Run on the GPU:
    python benchmarks/twowl_profile.py --nodes 50000 --edges 250000
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def timeit(fn, iters=3, warmup=1):
    import jax

    def run():
        return jax.block_until_ready(fn())

    for _ in range(warmup):
        run()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    return (time.perf_counter() - t0) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=50_000)
    ap.add_argument("--edges", type=int, default=250_000)
    ap.add_argument("--cap", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8192)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import optax

    from linkpred.models import twowl as m
    from linkpred.pipelines.twowl_scale import (
        ScaleTwoWLConfig,
        build_scale_data,
    )

    cfg = ScaleTwoWLConfig(nodes=args.nodes, edges=args.edges,
                           ei2_cap_per_node=args.cap)
    t0 = time.time()
    data = build_scale_data(cfg)
    print(json.dumps({"metric": "build_seconds",
                      "value": round(time.time() - t0, 1),
                      "ei2_columns": int(len(data.train.e1_src)),
                      "msg_edges": int(data.train.num_msg)}))

    trn = m.SplitArrays.from_split(data.train)
    val = m.SplitArrays.from_split(data.val)
    node_deg = jnp.asarray(data.node_deg)
    n_pos = data.train.num_msg // 2
    n_neg = len(data.train.pred) // 2
    P = min(args.batch, n_pos // 8, n_neg)
    rng = np.random.default_rng(0)
    pos_ids = jnp.asarray(rng.permutation(n_pos)[:P].astype(np.int32))
    neg_ids = jnp.asarray(rng.permutation(n_neg)[:P].astype(np.int32))
    key = jax.random.PRNGKey(0)

    def step_time(mcfg, tag, feat_rows):
        params = m.init_params(jax.random.PRNGKey(1), mcfg)
        opt = optax.adam(0.01)
        state = opt.init(params)
        t0 = time.time()

        def run():
            p2, _, loss, _, _ = m.train_step(
                params, state, key, pos_ids, neg_ids, trn, mcfg, opt,
                data.num_nodes)
            return loss

        dt = timeit(run)
        print(json.dumps({"metric": f"train_step_{tag}",
                          "seconds": round(dt, 4),
                          "compile_s": round(time.time() - t0 - dt * 4, 1)}))
        return dt

    base = m.TwoWLConfig(
        max_degree=data.max_degree, channels_1wl=24, channels_2wl=16,
        depth1=2, depth2=2, dp_emb=0.0, dp_1wl0=0.0, dp_1wl1=0.0,
        dp_2wl=0.0, act0=True, act1=False)
    step_time(base, "degree_d2", data.max_degree + 1)

    free = dataclasses.replace(base, max_degree=data.num_nodes - 1,
                               degree_feature=False)
    step_time(free, "free_d2", data.num_nodes)

    only1wl = dataclasses.replace(base, depth2=0)
    step_time(only1wl, "degree_d0_1wl_only", data.max_degree + 1)

    # eval forward at val shape (the every-eval_every cost)
    params = m.init_params(jax.random.PRNGKey(1), base)
    dt = timeit(lambda: m.eval_scores(params, node_deg, val, base,
                                      data.num_nodes))
    print(json.dumps({"metric": "eval_forward", "seconds": round(dt, 4)}))

    # forward-only at train shape (no grad, no mask recompute)
    num_msg = int(trn.msg_src.shape[0])
    sel = jnp.arange(2 * P, dtype=jnp.int32)
    msk = jnp.ones((num_msg,), bool)

    @jax.jit
    def fwd_only(p):
        return m.forward(p, base, node_deg, trn, msk, sel, None)

    dt = timeit(lambda: fwd_only(params))
    print(json.dumps({"metric": "train_forward_only",
                      "seconds": round(dt, 4)}))

    # raw primitive costs at the exact ei2 shape
    from linkpred.ops.segment import (
        gather_rows_planned,
        segment_sum_planned,
    )

    S = int(trn.e1_src.shape[0])
    R = int(trn.pos1_src.shape[0])
    C = base.channels_2wl
    e = jnp.asarray(rng.standard_normal((R, C)).astype(np.float32))
    gmsg = jnp.asarray(rng.standard_normal((S, C)).astype(np.float32))

    dt = timeit(lambda: segment_sum_planned(R, gmsg, *trn.e1_plan))
    print(json.dumps({"metric": "ei2_segment_sum_planned_f32",
                      "seconds": round(dt, 4), "slots": S, "rows": R,
                      "channels": C}))

    dt = timeit(lambda: gather_rows_planned(
        e, trn.e1_src ^ 1, trn.e1_gather_plan))
    print(json.dumps({"metric": "ei2_gather_planned_f32",
                      "seconds": round(dt, 4)}))

    ebf = e.astype(jnp.bfloat16)
    gbf = gmsg.astype(jnp.bfloat16)
    dt = timeit(lambda: segment_sum_planned(R, gbf, *trn.e1_plan))
    print(json.dumps({"metric": "ei2_segment_sum_planned_bf16",
                      "seconds": round(dt, 4)}))
    dt = timeit(lambda: gather_rows_planned(
        ebf, trn.e1_src ^ 1, trn.e1_gather_plan))
    print(json.dumps({"metric": "ei2_gather_planned_bf16",
                      "seconds": round(dt, 4)}))

    # 1-WL message structure primitives
    Sm = int(trn.msg_src.shape[0])
    x = jnp.asarray(rng.standard_normal(
        (data.num_nodes, base.channels_1wl)).astype(np.float32))
    xm = jnp.asarray(rng.standard_normal(
        (Sm, base.channels_1wl)).astype(np.float32))
    dt = timeit(lambda: segment_sum_planned(
        data.num_nodes, xm, *trn.msg_plan))
    print(json.dumps({"metric": "msg_segment_sum_planned_f32",
                      "seconds": round(dt, 4), "slots": Sm}))


if __name__ == "__main__":
    main()

"""Per-process worker for the multi-host distributed proof.

Every process runs THIS program (JAX multi-controller, the analog of a
Spark executor — reference `node2vec_spark/.../Node2vec.scala:24-61`): it
joins the job via `jax.distributed.initialize`, builds a global
("host", "data", "edge") mesh whose leading axis spans processes (the DCN
axis), and trains BOTH mesh-parallel families for `--steps` steps:

- TwoWL with the ei2 edge-pair columns sharded over ``edge``
  (edge partitioning; `dp.twowl_split_specs` placement contract),
- SEAL DGCNN with the subgraph batch sharded over the whole mesh (DP).

Checkpoint-restart failure model: with `--interrupt-at K` the job saves a
(params, opt_state) checkpoint at step K and hard-exits every process — a
whole-job crash. A relaunch with `--resume` restores and continues; the
orchestrator (`benchmarks/multihost.py`) asserts the resumed run's final
parameters equal the uninterrupted run's bit-for-bit semantics (same
per-step fold_in keys), and that the multi-process run matches a
single-device reference (`--nproc 0` mode).

Per-step RNG is `fold_in(base, step)` and batch ids come from a per-step
seeded numpy rng, so the trajectory is a pure function of the step index —
identical across processes and across restarts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, required=True,
                    help="process count; 0 = single-device reference mode")
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--port", type=int, default=9733)
    ap.add_argument("--ldev", type=int, default=4,
                    help="virtual CPU devices per process")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--interrupt-at", type=int, default=0,
                    help="crash the whole job right after checkpointing "
                         "at this step (0 = run to completion)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the checkpoint and continue")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--tag", default="run")
    ap.add_argument("--opt", choices=("adam", "sgd"), default="adam",
                    help="sgd for the sharded-equals-reference numerics "
                         "check (adam turns psum reduction-order noise "
                         "into O(lr) steps in noise-dominated directions)")
    return ap.parse_args(argv)


def toy_twowl(n_nodes=32, seed=7, ei2_bucket=256):
    import numpy as np

    from linkpred.data.twowl import build_twowl_data

    rng = np.random.default_rng(seed)
    chain = np.stack([np.arange(n_nodes - 1), np.arange(1, n_nodes)], axis=1)
    extra = np.stack(
        [rng.integers(0, n_nodes, 90), rng.integers(0, n_nodes, 90)], axis=1
    )
    pairs = np.concatenate([chain, extra], axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    return build_twowl_data(pairs, n_nodes, rng=rng, ei2_bucket=ei2_bucket)


def toy_seal_batch(batch, k=16, f=6, seed=5):
    import numpy as np

    rng = np.random.default_rng(seed)
    adj = (rng.random((batch, k, k)) < 0.2).astype(np.float32)
    adj = np.triu(adj, 1)
    adj = adj + adj.transpose(0, 2, 1)
    a_tilde = adj + np.eye(k, dtype=np.float32)[None]
    d_inv = (1.0 / a_tilde.sum(axis=2)).astype(np.float32)
    x = rng.standard_normal((batch, k, f)).astype(np.float32)
    node_mask = np.ones((batch, k), dtype=bool)
    y = rng.integers(0, 2, size=batch).astype(np.int32)
    return d_inv, a_tilde, x, node_mask, y


def main(argv=None):
    args = parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")

    distributed = args.nproc >= 2
    if distributed:
        from linkpred.parallel.multihost import initialize_cpu

        initialize_cpu(f"localhost:{args.port}", args.nproc, args.pid,
                       args.ldev)

    import jax.numpy as jnp
    import numpy as np
    import optax
    from jax.sharding import PartitionSpec as P

    from linkpred.models import seal
    from linkpred.models import twowl as m
    from linkpred.parallel import dp
    from linkpred.parallel.multihost import (
        fetch_replicated, global_mesh, global_put, global_twowl_split, sync,
    )
    from linkpred.utils.checkpoint import restore_pytree, save_pytree

    reference = args.nproc == 0
    if reference:
        mesh = None
    else:
        total = args.nproc * args.ldev if distributed else args.ldev
        host = args.nproc if distributed else 1
        edge = 2
        data = total // (host * edge)
        # hosts-outer/devices-inner layout via distributed.hybrid_mesh (falls
        # back to the process-major reshape on CPU device topologies,
        # which global_mesh asserts is what we got)
        from linkpred.parallel.distributed import hybrid_mesh

        mesh = hybrid_mesh((data, edge), (host,),
                           axis_names=("host", "data", "edge"))
        assert dict(mesh.shape) == dict(
            global_mesh((host, data, edge), ("host", "data", "edge")).shape
        )
        if args.pid == 0:
            print(f"[{args.tag}] mesh {dict(mesh.shape)} over "
                  f"{jax.process_count()} processes", flush=True)

    is_proc0 = jax.process_index() == 0
    os.makedirs(args.outdir, exist_ok=True)
    result = {"tag": args.tag, "nproc": args.nproc,
              "devices": len(jax.devices()),
              "processes": jax.process_count()}

    # ---- TwoWL: ei2 columns sharded over `edge` -------------------------
    d = toy_twowl()
    cfg = m.TwoWLConfig(max_degree=d.max_degree, channels_1wl=16,
                        channels_2wl=8, depth1=2, depth2=2,
                        learning_rate=0.01)
    params = m.init_params(jax.random.PRNGKey(0), cfg)
    make_opt = optax.adam if args.opt == "adam" else optax.sgd
    optimizer = make_opt(cfg.learning_rate)
    opt_state = optimizer.init(params)
    raw = m.SplitArrays.from_split(d.train)
    if reference:
        placed = raw
        put = lambda tree: tree  # noqa: E731
    elif distributed:
        placed = global_twowl_split(mesh, raw)
        put = lambda tree: global_put(mesh, P(), tree)  # noqa: E731
    else:
        placed = dp.shard_twowl_split(mesh, raw)
        put = lambda tree: dp.replicate(mesh, tree)  # noqa: E731
    params = put(params)
    opt_state = put(opt_state)

    n_pos = d.train.num_msg // 2
    n_neg = len(d.train.pred) // 2
    batch = min(8, n_pos, n_neg)
    base = jax.random.PRNGKey(42)

    ckpt_prefix = os.path.join(args.outdir, "ckpt_twowl")
    start = 0
    if args.resume:
        like = (m.init_params(jax.random.PRNGKey(0), cfg),
                optimizer.init(m.init_params(jax.random.PRNGKey(0), cfg)))
        restored = restore_pytree(
            f"{ckpt_prefix}-{args.interrupt_at}", like
        )
        params, opt_state = put(restored[0]), put(restored[1])
        start = args.interrupt_at
        if is_proc0:
            print(f"[{args.tag}] resumed twowl from step {start}", flush=True)

    losses = []
    for step in range(start, args.steps):
        srng = np.random.default_rng(1000 + step)
        pos = jnp.asarray(srng.permutation(n_pos)[:batch].astype(np.int32))
        neg = jnp.asarray(srng.permutation(n_neg)[:batch].astype(np.int32))
        key = jax.random.fold_in(base, step)
        params, opt_state, loss, _, _ = m.train_step(
            params, opt_state, key, pos, neg, placed, cfg, optimizer,
            d.num_nodes,
        )
        losses.append(float(fetch_replicated(loss)))
        if args.interrupt_at and not args.resume \
                and step + 1 == args.interrupt_at:
            host_state = fetch_replicated((params, opt_state))
            if is_proc0:
                save_pytree(ckpt_prefix, host_state, step=step + 1)
            sync("ckpt_twowl")
            if is_proc0:
                print(f"[{args.tag}] checkpointed at step {step + 1}; "
                      "simulating whole-job crash", flush=True)
            # hard job crash: every process dies (the failure model a dead
            # host imposes on a synchronous SPMD job)
            sys.stdout.flush()
            os._exit(17)

    result["twowl_losses"] = losses
    final_params = fetch_replicated(params)
    if is_proc0:
        save_pytree(os.path.join(args.outdir, f"twowl_params_{args.tag}"),
                    final_params)

    # ---- SEAL: subgraph batch sharded over the whole mesh (DP) ----------
    # fixed batch so reference-mode and N-process numerics are comparable;
    # must divide by the global device count (16 covers up to 16 devices)
    B = 16
    d_inv, a_tilde, x, node_mask, y = toy_seal_batch(B)
    threshold_k = 8
    sparams = seal.init_params(jax.random.PRNGKey(1), x.shape[-1],
                               threshold_k)
    sopt = make_opt(1e-3)
    sstate = sopt.init(sparams)
    if not reference:
        spec = dp.seal_batch_spec(mesh)
        if distributed:
            d_inv, a_tilde, x, node_mask, y = (
                global_put(mesh, spec, a)
                for a in (d_inv, a_tilde, x, node_mask, y)
            )
            sparams = global_put(mesh, P(), sparams)
            sstate = global_put(mesh, P(), sstate)
        else:
            d_inv, a_tilde, x, node_mask, y = dp.shard_seal_batch(
                mesh, d_inv, a_tilde, x, node_mask, y
            )
            sparams = dp.replicate(mesh, sparams)
            sstate = dp.replicate(mesh, sstate)

    seal_losses = []
    for step in range(args.steps):
        key = jax.random.fold_in(jax.random.PRNGKey(77), step)
        sparams, sstate, sloss = seal.train_step(
            sparams, sstate, d_inv, a_tilde, x, node_mask, y,
            key, threshold_k, 0.5, sopt,
        )
        seal_losses.append(float(fetch_replicated(sloss)))
    result["seal_losses"] = seal_losses
    if is_proc0:
        save_pytree(os.path.join(args.outdir, f"seal_params_{args.tag}"),
                    fetch_replicated(sparams))

    if is_proc0:
        with open(os.path.join(args.outdir, f"result_{args.tag}.json"),
                  "w") as f:
            json.dump(result, f)
        print(f"[{args.tag}] done: twowl loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, seal loss {seal_losses[0]:.4f} -> "
              f"{seal_losses[-1]:.4f}", flush=True)
    sync("done")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()

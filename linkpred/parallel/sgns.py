"""Distributed SGNS embedding training over a device mesh.

The reference's embedding fit is *distributed*: Spark MLlib Word2Vec
trains data-parallel SGD over the partitioned walk corpus
(`node2vec_spark/.../Word2vec.scala:35-39`, driven from
`Node2vec.scala:140-148`; `numPartition=10` in `Main.scala:15-31`). MLlib
partitions sentences, trains each partition against stale broadcast
weights, and averages tables per iteration — a design forced by the RDD
model, and one that *approximates* single-machine SGD.

The design here is exact instead of averaged, by splitting the
two parallel axes the way the hardware wants (scaling-book recipe: shard
the big tensors, psum the small activations):

- **corpus data parallelism** — the walk matrix is row-sharded over the
  mesh; each device samples its share of the step's center positions from
  its local walk shard (the per-partition sampling of MLlib). The sampled
  *indices* (a few hundred KB of int32) are `all_gather`ed so every device
  sees the full batch — the index exchange is the frontier/boundary
  payload, three orders of magnitude smaller than the embedding rows
  themselves.
- **feature-axis model parallelism** — both embedding tables are sharded
  on the feature dim ([N, D/P] per device). Dot products psum partial
  scores ([Bc, nc] + [Bc, pool] floats — the only float collective); all
  index-dependent gathers/scatters touch only the local D/P slice, so the
  row-transaction count per device *drops* with the mesh size instead of
  replicating.

Every device applies updates for the SAME global batch to its own feature
slice, so the sharded run is numerically the single-device run (up to
float reassociation in the psum) — no table averaging, no staleness.
`train_sgns_mesh_reference` replays the identical sample stream on one
device; tests assert allclose between the two.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from linkpred.models.word2vec import SGNSConfig, SGNSPrep, prepare_sgns


def _cap_batch(cfg: SGNSConfig, num_nodes: int) -> SGNSConfig:
    """Same stability cap as the single-device trainer: ~16 pair
    candidates per vocabulary entry per step (models/word2vec.py)."""
    import dataclasses

    batch = max(64, min(cfg.batch_size, 16 * num_nodes))
    return dataclasses.replace(cfg, batch_size=batch) \
        if batch != cfg.batch_size else cfg


def _shard_geometry(cfg: SGNSConfig, n_shards: int):
    nc = max(1, min(cfg.ctx_per_center, cfg.batch_size))
    bc = max(n_shards, cfg.batch_size // nc)
    bc -= bc % n_shards  # centers per step, divisible over the mesh
    return nc, bc


def _sample_shard(key, shard_id, walks_shard, nc, bc_local, window, keep):
    """Sample `bc_local` center positions + [bc_local, nc] context
    candidates from ONE walk shard. Identical semantics to the
    single-device sampler in `models.word2vec` (per-center reduced-window
    cap, range/self-pair/subsample masks); the key is folded with the
    shard id so shards draw independent streams.
    """
    W, L = walks_shard.shape
    ks = jax.random.split(jax.random.fold_in(key, shard_id), 7)
    widx = jax.random.randint(ks[0], (bc_local,), 0, W)
    t = jax.random.randint(ks[1], (bc_local,), 0, L)
    cap = jax.random.randint(ks[2], (bc_local, 1), 1, window + 1)
    direction = jax.random.randint(ks[3], (bc_local, nc), 0, 2) * 2 - 1
    mag = jax.random.randint(ks[4], (bc_local, nc), 1, window + 1)
    ctx_t = t[:, None] + direction * mag
    valid = (mag <= cap) & (ctx_t >= 0) & (ctx_t < L)
    ctx_t = jnp.clip(ctx_t, 0, L - 1)
    rows = walks_shard[widx]  # [bc_local, L] — one row gather per center
    center = jnp.take_along_axis(rows, t[:, None], axis=1)[:, 0]
    context = jnp.take_along_axis(rows, ctx_t, axis=1)
    valid &= center[:, None] != context
    if keep is not None:
        uc = jax.random.uniform(ks[5], (bc_local,))
        ux = jax.random.uniform(ks[6], (bc_local, nc))
        valid &= (uc < keep[center])[:, None] & (ux < keep[context])
    return center, context, valid


def _draw_pool(key, noise_J, noise_q, pool_size, num_nodes):
    """Shared negative pool — same key on every shard, so the pool is
    replicated by construction."""
    un = jax.random.uniform(jax.random.fold_in(key, 0x7EA), (2, pool_size))
    kk = jnp.minimum((un[0] * num_nodes).astype(jnp.int32), num_nodes - 1)
    return jnp.where(un[1] < noise_q[kk], kk, noise_J[kk]).astype(jnp.int32)


def _slice_update(w_in_l, w_out_l, lr, center, context, valid, pool, cfg,
                  pos_score, neg_score):
    """Apply the pooled-SGNS update for the full global batch to one
    feature slice, given the (already psum'd / full-D) scores."""
    nc = context.shape[1]
    bc = center.shape[0]
    vc = w_in_l[center]
    uo = w_out_l[context.reshape(-1)].reshape(bc, nc, -1)
    U = w_out_l[pool]
    validf = valid.astype(vc.dtype)
    g_pos = (jax.nn.sigmoid(pos_score) - 1.0) * validf
    nvalid = validf.sum(axis=1) * (cfg.negatives / cfg.neg_pool)
    g_neg = jax.nn.sigmoid(neg_score) * nvalid[:, None]
    grad_vc = jnp.einsum("bn,bnd->bd", g_pos, uo) + g_neg @ U
    grad_uo = g_pos[:, :, None] * vc[:, None, :]
    grad_pool = g_neg.T @ vc
    w_in_l = w_in_l.at[center].add(-lr * grad_vc)
    w_out_l = w_out_l.at[context.reshape(-1)].add(
        -lr * grad_uo.reshape(bc * nc, -1))
    w_out_l = w_out_l.at[pool].add(-lr * grad_pool)
    return w_in_l, w_out_l


@partial(jax.jit,
         static_argnames=("cfg", "num_steps", "mesh", "axis"),
         donate_argnums=(1, 2))
def _train_mesh(key, w_in, w_out, walks, noise_J, noise_q, keep,
                cfg: SGNSConfig, num_steps: int, mesh: Mesh, axis: str):
    n_shards = mesh.shape[axis]
    num_nodes = w_in.shape[0]
    nc, bc = _shard_geometry(cfg, n_shards)
    bc_local = bc // n_shards
    lrs = jnp.linspace(cfg.lr, cfg.min_lr, num_steps)
    keys = jax.random.split(key, num_steps)

    def local(w_in_l, w_out_l, walks_l, noise_J, noise_q, keep, keys, lrs):
        pidx = jax.lax.axis_index(axis)

        def step(carry, inp):
            w_in_l, w_out_l = carry
            k, lr = inp
            c_l, x_l, v_l = _sample_shard(
                k, pidx, walks_l, nc, bc_local, cfg.window,
                keep if cfg.subsample > 0 else None)
            # index exchange: int32 payloads only
            center = jax.lax.all_gather(c_l, axis, tiled=True)
            context = jax.lax.all_gather(x_l, axis, tiled=True)
            valid = jax.lax.all_gather(v_l, axis, tiled=True)
            pool = _draw_pool(k, noise_J, noise_q, cfg.neg_pool, num_nodes)

            vc = w_in_l[center]
            uo = w_out_l[context.reshape(-1)].reshape(bc, nc, -1)
            U = w_out_l[pool]
            # partial scores over the local feature slice -> psum
            pos_score = jax.lax.psum(
                jnp.einsum("bd,bnd->bn", vc, uo), axis)
            neg_score = jax.lax.psum(vc @ U.T, axis)
            return _slice_update(
                w_in_l, w_out_l, lr, center, context, valid, pool, cfg,
                pos_score, neg_score), None

        (w_in_l, w_out_l), _ = jax.lax.scan(
            step, (w_in_l, w_out_l), (keys, lrs))
        return w_in_l, w_out_l

    fspec = P(None, axis)  # tables feature-sharded
    return shard_map(
        local, mesh=mesh,
        in_specs=(fspec, fspec, P(axis), P(), P(), P(), P(), P()),
        out_specs=(fspec, fspec),
    )(w_in, w_out, walks, noise_J, noise_q, keep, keys, lrs)


def _steps_and_init(key, walks_np, num_nodes, cfg, n_shards):
    nc, bc = _shard_geometry(cfg, n_shards)
    pairs_per_step = bc * nc
    pairs_per_epoch = walks_np.size * cfg.window * 2
    num_steps = max(int(cfg.epochs * pairs_per_epoch / pairs_per_step), 1)
    k_init, k_train = jax.random.split(
        jax.random.PRNGKey(0) if key is None else key)
    w_in = (jax.random.uniform(
        k_init, (num_nodes, cfg.dim), minval=-0.5, maxval=0.5) / cfg.dim
    ).astype(jnp.float32)
    w_out = jnp.zeros((num_nodes, cfg.dim), dtype=jnp.float32)
    return num_steps, k_train, w_in, w_out


def train_sgns_mesh(
    key,
    walks,
    num_nodes: int,
    cfg: SGNSConfig = SGNSConfig(),
    mesh: Mesh | None = None,
    axis: str = "data",
    prep: SGNSPrep | None = None,
) -> np.ndarray:
    """Distributed SGNS fit (module docstring); returns [num_nodes, dim].

    Requires `cfg.neg_pool > 0` (the pooled step is the distributed
    design) and `cfg.dim` divisible by the mesh axis size. Walk rows
    beyond a multiple of the axis size are dropped (documented corpus
    trim, < one shard's worth).
    """
    if mesh is None:
        from linkpred.parallel.mesh import make_mesh

        n = len(jax.devices())
        mesh = make_mesh(shape=(n, 1))
    n_shards = mesh.shape[axis]
    cfg = _cap_batch(cfg, num_nodes)
    assert cfg.neg_pool > 0, "mesh SGNS requires the pooled negative step"
    assert cfg.dim % n_shards == 0, (cfg.dim, n_shards)

    walks_np = np.asarray(walks)
    trim = (walks_np.shape[0] // n_shards) * n_shards
    walks_np = walks_np[:trim]
    if prep is None:
        prep = prepare_sgns(walks_np, num_nodes, cfg)
    num_steps, k_train, w_in, w_out = _steps_and_init(
        key, walks_np, num_nodes, cfg, n_shards)

    dev = jax.device_put
    fsh = NamedSharding(mesh, P(None, axis))
    w_in = dev(w_in, fsh)
    w_out = dev(w_out, fsh)
    walks_d = dev(jnp.asarray(walks_np), NamedSharding(mesh, P(axis)))
    rep = NamedSharding(mesh, P())
    w_in, _ = _train_mesh(
        k_train, w_in, w_out, walks_d,
        dev(jnp.asarray(prep.noise_J), rep), dev(jnp.asarray(prep.noise_q), rep),
        dev(jnp.asarray(prep.keep), rep), cfg, num_steps, mesh, axis)
    return np.asarray(w_in)


def train_sgns_mesh_reference(
    key,
    walks,
    num_nodes: int,
    cfg: SGNSConfig,
    n_shards: int,
    prep: SGNSPrep | None = None,
) -> np.ndarray:
    """Single-device replay of the EXACT mesh sample stream: loops over
    shard ids in Python, samples each shard's centers from its walk rows
    with the same folded keys, concatenates (== the all_gather), and
    applies the pooled update to full-width tables. Up to float
    reassociation in the psum'd scores this is the mesh result — the
    equivalence oracle for tests."""
    cfg = _cap_batch(cfg, num_nodes)
    walks_np = np.asarray(walks)
    trim = (walks_np.shape[0] // n_shards) * n_shards
    walks_np = walks_np[:trim]
    if prep is None:
        prep = prepare_sgns(walks_np, num_nodes, cfg)
    num_steps, k_train, w_in, w_out = _steps_and_init(
        key, walks_np, num_nodes, cfg, n_shards)
    nc, bc = _shard_geometry(cfg, n_shards)
    bc_local = bc // n_shards
    keep = jnp.asarray(prep.keep)
    noise_J = jnp.asarray(prep.noise_J)
    noise_q = jnp.asarray(prep.noise_q)
    shards = jnp.asarray(walks_np).reshape(n_shards, trim // n_shards, -1)
    lrs = np.linspace(cfg.lr, cfg.min_lr, num_steps)
    keys = jax.random.split(k_train, num_steps)

    @jax.jit
    def step(w_in, w_out, k, lr):
        cs, xs, vs = [], [], []
        for s in range(n_shards):
            c, x, v = _sample_shard(
                k, s, shards[s], nc, bc_local, cfg.window,
                keep if cfg.subsample > 0 else None)
            cs.append(c)
            xs.append(x)
            vs.append(v)
        center = jnp.concatenate(cs)
        context = jnp.concatenate(xs)
        valid = jnp.concatenate(vs)
        pool = _draw_pool(k, noise_J, noise_q, cfg.neg_pool, num_nodes)
        vc = w_in[center]
        uo = w_out[context.reshape(-1)].reshape(bc, nc, -1)
        U = w_out[pool]
        pos_score = jnp.einsum("bd,bnd->bn", vc, uo)
        neg_score = vc @ U.T
        return _slice_update(
            w_in, w_out, lr, center, context, valid, pool, cfg,
            pos_score, neg_score)

    for i in range(num_steps):
        w_in, w_out = step(w_in, w_out, keys[i], float(lrs[i]))
    return np.asarray(w_in)

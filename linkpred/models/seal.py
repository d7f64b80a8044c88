"""SEAL DGCNN: batched GCN stack + SortPooling + 1-D convs, in pure JAX.

A batched redesign of the reference's TF1 graph (`SEAL/model/gnn.py:22-145`),
which trains one variable-sized subgraph per `sess.run` (batch size 1,
thousands of Python<->TF crossings, `gnn.py:172-181`). Here the entire
dataset is a capacity-padded tensor stack (`linkpred.data.subgraph`) and
training runs as one jit-compiled minibatched loop on device:

- 4 graph-conv layers `Z = tanh(D^-1 A~ Z W)`, channels 32/32/32/1
  (`gnn.py:46-60`; D is diagonal so `D^-1 @ M` is a row scale, and the
  dense `A~ @ (Z W)` is a [K,K]x[K,C] batched matmul — no sparse scatter needed at enclosing-subgraph scale).
- SortPooling (`gnn.py:77-91`): nodes ordered by the 1-channel Z_4 score
  via `lax.top_k`, truncated/zero-padded to a static `threshold_k` chosen
  as the `top_k`-th percentile of subgraph sizes. Padded nodes are pushed
  to the bottom with a -inf score and zeroed after the gather, which
  reproduces the reference's pad-with-zeros branch.
- conv1d #1 (width = stride = 96) is algebraically a per-node matmul of the
  sorted [k, 96] feature rows — implemented as such. conv1d #2 (width 5,
  stride 1, 16->32) uses `lax.conv_general_dilated`. Dense 128 + dropout
  0.5 + 2-way softmax head (`gnn.py:103-137`).

Deviations from the reference (documented, deliberate):
- weights re-initialized once, not every epoch (`gnn.py:170` re-inits inside
  the epoch loop, making the shipped model effectively one-epoch-trained);
- dropout actually applied during training (the reference's
  `if is_train == 1:` on a placeholder is always-true Python, and
  `tf.layers.dropout` defaults to `training=False`, so it never dropped);
- the final dense init uses stddev 0.1 like every other layer (the
  reference leaves `weight_2` at stddev 1.0, `gnn.py:133`).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

GRAPH_CONV_CHANNELS = (32, 32, 32, 1)
CONV1D_1_OUT = 16
CONV1D_2_OUT = 32
CONV1D_2_WIDTH = 5
DENSE_NODES = 128
DROPOUT_RATE = 0.5


class DGCNNParams(NamedTuple):
    gw: tuple  # 4 graph-conv weights
    wc1: jnp.ndarray  # [96, 16] sort-pooled per-node projection
    wc2: jnp.ndarray  # [5, 16, 32] conv1d kernel (WIO)
    w1: jnp.ndarray
    b1: jnp.ndarray
    w2: jnp.ndarray
    b2: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class DGCNNConfig:
    feature_dim: int
    threshold_k: int
    learning_rate: float = 1e-4
    batch_size: int = 32
    epochs: int = 50
    dropout: float = DROPOUT_RATE
    seed: int = 0


def assemble_inputs(adj_u8, tags, nodes, node_mask, emb_table, tags_size: int):
    """On-device GNN input assembly from compact arrays.

    The dense inputs (A~ = A + I as f32, row-scale D^-1, X = one-hot tag
    ++ embedding rows) are built *inside* jit from a uint8 adjacency, int
    tags, int node ids, and the [N, D] embedding table — ~12x less
    host->device traffic and HBM than shipping the assembled f32 stack
    (reference `create_input_for_gnn_fly`, `SEAL/config/data.py:81-145`,
    materializes everything densely on the host).
    """
    K = adj_u8.shape[-1]
    a_tilde = adj_u8.astype(jnp.float32) + jnp.eye(K, dtype=jnp.float32)
    d_inv = 1.0 / a_tilde.sum(axis=-1)
    m = node_mask[..., None].astype(jnp.float32)
    x = jax.nn.one_hot(tags, tags_size, dtype=jnp.float32) * m
    if emb_table is not None:
        x = jnp.concatenate([x, emb_table[nodes] * m], axis=-1)
    return d_inv, a_tilde, x


def _trunc_normal(key, shape, stddev=0.1):
    return stddev * jax.random.truncated_normal(key, -2.0, 2.0, shape, jnp.float32)


def init_params(key, feature_dim: int, threshold_k: int) -> DGCNNParams:
    ks = jax.random.split(key, 8)
    chans = (feature_dim,) + GRAPH_CONV_CHANNELS
    gw = tuple(
        _trunc_normal(ks[i], (chans[i], chans[i + 1])) for i in range(4)
    )
    total_gc = sum(GRAPH_CONV_CHANNELS[:3])  # 96
    dense_in = (threshold_k - CONV1D_2_WIDTH + 1) * CONV1D_2_OUT
    return DGCNNParams(
        gw=gw,
        wc1=_trunc_normal(ks[4], (total_gc, CONV1D_1_OUT)),
        wc2=_trunc_normal(ks[5], (CONV1D_2_WIDTH, CONV1D_1_OUT, CONV1D_2_OUT)),
        w1=_trunc_normal(ks[6], (dense_in, DENSE_NODES)),
        b1=jnp.zeros((DENSE_NODES,)),
        w2=_trunc_normal(ks[7], (DENSE_NODES, 2)),
        b2=jnp.zeros((2,)),
    )


def graph_conv_layers(params: DGCNNParams, d_inv, a_tilde, x):
    """The 4-layer GCN stack; returns (concat(Z1..Z3) [B,K,96], Z4 [B,K,1]).

    Exposed separately for per-layer allclose tests against the dense
    reference math of `gnn.py:46-60`.
    """
    zs = []
    z = x
    for w in params.gw:
        z = jnp.tanh(d_inv[:, :, None] * jnp.einsum(
            "bkj,bjc->bkc", a_tilde, jnp.einsum("bkc,cd->bkd", z, w),
            preferred_element_type=jnp.float32,
        ))
        zs.append(z)
    return jnp.concatenate(zs[:3], axis=-1), zs[3]


def sort_pool(cat, z4, node_mask, threshold_k: int):
    """SortPooling: order nodes by Z4 score, keep/pad to threshold_k rows.

    The pooled gather runs in flat 2-D form (rows = B*K) instead of a
    batched 3-D `take_along_axis`.
    """
    from linkpred.ops.segment import take_rows

    B, K = node_mask.shape
    scores = jnp.where(node_mask, z4[:, :, 0], -jnp.inf)
    _, idx = jax.lax.top_k(scores, threshold_k)  # [B, k]
    flat_idx = jnp.arange(B, dtype=idx.dtype)[:, None] * K + idx  # [B, k]
    pooled = take_rows(cat.reshape(B * K, -1), flat_idx)  # [B, k, 96]
    valid = take_rows(node_mask.reshape(B * K), flat_idx)
    return pooled * valid[:, :, None]


def forward(
    params: DGCNNParams,
    d_inv,  # [B, K]
    a_tilde,  # [B, K, K]
    x,  # [B, K, F]
    node_mask,  # [B, K]
    threshold_k: int,
    dropout_key=None,
    dropout_rate: float = DROPOUT_RATE,
):
    """Batched DGCNN forward -> logits [B, 2]."""
    cat, z4 = graph_conv_layers(params, d_inv, a_tilde, x)
    pooled = sort_pool(cat, z4, node_mask, threshold_k)  # [B, k, 96]

    # conv1d(width=stride=96) over the flattened rows == per-node matmul
    c1 = jnp.einsum("bkc,cd->bkd", pooled, params.wc1)  # [B, k, 16]

    c2 = jax.lax.conv_general_dilated(
        c1,
        params.wc2,
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NWC", "WIO", "NWC"),
    )  # [B, k-4, 32]

    h = c2.reshape(c2.shape[0], -1)
    h = jax.nn.relu(h @ params.w1 + params.b1)
    if dropout_key is not None and dropout_rate > 0:
        keep = jax.random.bernoulli(dropout_key, 1.0 - dropout_rate, h.shape)
        h = jnp.where(keep, h / (1.0 - dropout_rate), 0.0)
    return h @ params.w2 + params.b2


def loss_fn(params, d_inv, a_tilde, x, node_mask, y, threshold_k, key, dropout_rate):
    logits = forward(
        params, d_inv, a_tilde, x, node_mask, threshold_k, key, dropout_rate
    )
    return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()


@partial(jax.jit, static_argnames=("threshold_k", "dropout_rate", "optimizer"))
def train_step(
    params,
    opt_state,
    d_inv,
    a_tilde,
    x,
    node_mask,
    y,
    key,
    threshold_k: int,
    dropout_rate: float,
    optimizer,
):
    loss, grads = jax.value_and_grad(loss_fn)(
        params, d_inv, a_tilde, x, node_mask, y, threshold_k, key, dropout_rate
    )
    updates, opt_state = optimizer.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss


@partial(
    jax.jit,
    static_argnames=("threshold_k", "dropout_rate", "optimizer", "num_steps"),
)
def train_scan(
    params,
    opt_state,
    key,
    batch_idx,  # [num_steps, batch] precomputed minibatch indices
    d_inv,
    a_tilde,
    x,
    node_mask,
    y,
    threshold_k: int,
    dropout_rate: float,
    optimizer,
    num_steps: int,
):
    """The whole minibatched training run as one on-device `lax.scan` —
    replaces per-step host dispatch (the reference does one `sess.run` per
    *subgraph*, `gnn.py:172-181`; the host-loop trainer here still paid one
    dispatch per minibatch). Returns (params, opt_state, per-step losses)."""

    def step(carry, inp):
        params, opt_state, key = carry
        idx = inp
        key, k_drop = jax.random.split(key)
        loss, grads = jax.value_and_grad(loss_fn)(
            params, d_inv[idx], a_tilde[idx], x[idx], node_mask[idx], y[idx],
            threshold_k, k_drop, dropout_rate,
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state, key), loss

    (params, opt_state, _), losses = jax.lax.scan(
        step, (params, opt_state, key), batch_idx, length=num_steps
    )
    return params, opt_state, losses


@partial(
    jax.jit,
    static_argnames=(
        "tags_size", "threshold_k", "dropout_rate", "optimizer", "num_steps",
    ),
)
def train_scan_compact(
    params,
    opt_state,
    key,
    batch_idx,  # [num_steps, batch]
    adj_u8,  # [P, K, K] uint8
    tags,  # [P, K] int32
    nodes,  # [P, K] int32
    node_mask,  # [P, K] bool
    emb_table,  # [N, D] float32 (or None)
    y,  # [P] int32
    tags_size: int,
    threshold_k: int,
    dropout_rate: float,
    optimizer,
    num_steps: int,
):
    """`train_scan` over compact inputs: each step gathers its minibatch
    from the uint8/int stacks and assembles dense f32 inputs on device."""

    from linkpred.ops.segment import take_rows

    def step(carry, inp):
        params, opt_state, key = carry
        idx = inp
        key, k_drop = jax.random.split(key)
        # adj_u8 is [P, K, K]: gather in flat 2-D form
        mask_b = take_rows(node_mask, idx)
        d_inv, a_tilde, x = assemble_inputs(
            take_rows(adj_u8.reshape(adj_u8.shape[0], -1), idx).reshape(
                (idx.shape[0],) + adj_u8.shape[1:]
            ),
            take_rows(tags, idx), take_rows(nodes, idx), mask_b,
            emb_table, tags_size,
        )
        loss, grads = jax.value_and_grad(loss_fn)(
            params, d_inv, a_tilde, x, mask_b, y[idx],
            threshold_k, k_drop, dropout_rate,
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state, key), loss

    (params, opt_state, _), losses = jax.lax.scan(
        step, (params, opt_state, key), batch_idx, length=num_steps
    )
    return params, opt_state, losses


@partial(jax.jit, static_argnames=("tags_size", "threshold_k"))
def predict_scores_compact(
    params, adj_u8, tags, nodes, node_mask, emb_table,
    tags_size: int, threshold_k: int,
):
    d_inv, a_tilde, x = assemble_inputs(
        adj_u8, tags, nodes, node_mask, emb_table, tags_size
    )
    logits = forward(params, d_inv, a_tilde, x, node_mask, threshold_k)
    return jax.nn.softmax(logits, axis=-1)[:, 1]


@partial(jax.jit, static_argnames=("threshold_k",))
def predict_scores(params, d_inv, a_tilde, x, node_mask, threshold_k: int):
    """Positive-class softmax scores [B] (reference `gnn.py:137,243`)."""
    logits = forward(params, d_inv, a_tilde, x, node_mask, threshold_k)
    return jax.nn.softmax(logits, axis=-1)[:, 1]


def threshold_from_sizes(sizes: np.ndarray, top_k_percent: float) -> int:
    """`threshold_k` = the `top_k`-th percentile of subgraph sizes
    (reference `gnn.py:77-79`), floored at the conv2 width."""
    k = int(np.percentile(np.asarray(sizes), top_k_percent))
    return max(k, CONV1D_2_WIDTH)


def train_dgcnn(
    cfg: DGCNNConfig,
    d_inv: np.ndarray,
    a_tilde: np.ndarray,
    x: np.ndarray,
    node_mask: np.ndarray,
    y: np.ndarray,
    eval_every: int = 0,
    eval_fn=None,
    verbose: bool = False,
    fused: bool = True,
) -> DGCNNParams:
    """Minibatched Adam training over the padded subgraph stack.

    `fused=True` (default, and forced when no eval callback is given) runs
    the entire schedule as one device-side `train_scan`; the host loop
    remains for callers that need per-epoch callbacks.
    """
    n = y.shape[0]
    bs = min(cfg.batch_size, n)
    steps_per_epoch = max(n // bs, 1)
    optimizer = optax.adam(cfg.learning_rate)

    key = jax.random.PRNGKey(cfg.seed)
    key, k_init = jax.random.split(key)
    params = init_params(k_init, cfg.feature_dim, cfg.threshold_k)
    opt_state = optimizer.init(params)

    d_inv = jnp.asarray(d_inv)
    a_tilde = jnp.asarray(a_tilde)
    x = jnp.asarray(x)
    node_mask = jnp.asarray(node_mask)
    y = jnp.asarray(y, dtype=jnp.int32)

    rng = np.random.default_rng(cfg.seed)
    if fused and eval_fn is None:
        batch_idx = np.concatenate(
            [
                rng.permutation(n)[: steps_per_epoch * bs].reshape(
                    steps_per_epoch, bs
                )
                for _ in range(cfg.epochs)
            ]
        ).astype(np.int32)
        key, k_scan = jax.random.split(key)
        params, opt_state, losses = train_scan(
            params, opt_state, k_scan, jnp.asarray(batch_idx),
            d_inv, a_tilde, x, node_mask, y,
            cfg.threshold_k, cfg.dropout, optimizer, len(batch_idx),
        )
        if verbose:
            losses = np.asarray(losses).reshape(cfg.epochs, steps_per_epoch)
            for epoch in (0, cfg.epochs // 2, cfg.epochs - 1):
                print(f"epoch {epoch}: loss {losses[epoch].mean():.4f}")
        return params

    for epoch in range(cfg.epochs):
        perm = rng.permutation(n)
        epoch_loss = 0.0
        for s in range(steps_per_epoch):
            idx = jnp.asarray(perm[s * bs : s * bs + bs])
            key, k_drop = jax.random.split(key)
            params, opt_state, loss = train_step(
                params,
                opt_state,
                d_inv[idx],
                a_tilde[idx],
                x[idx],
                node_mask[idx],
                y[idx],
                k_drop,
                cfg.threshold_k,
                cfg.dropout,
                optimizer,
            )
            epoch_loss += float(loss)
        if verbose:
            print(f"epoch {epoch}: loss {epoch_loss / steps_per_epoch:.4f}")
        if eval_fn is not None and eval_every and (epoch + 1) % eval_every == 0:
            eval_fn(epoch, params)
    return params

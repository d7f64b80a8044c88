"""LocalWLNet — the 2-WL edge-level GNN — in pure JAX, static shapes.

A static-shape redesign of the reference PyTorch/PyG model
(`TwoWL/model/model.py:8-96`) and its training step (`TwoWL/model/train.py`):

- degree-indexed `nn.Embedding` + GraphNorm + dropout (`model.py:53-55`),
- `depth1` GCNConv+GraphNorm 1-WL layers over the node graph
  (`model.py:57-59`),
- edge representation `x[u] * x[v]` for every row of `pos1`
  (`model.py:75`),
- `depth2` *pairs* of GCNConv+GraphNorm stacks over the ei2 edge-pair graph
  and its parity-reverse, summed (`model.py:61-64,76-77`),
- select the target rows, multiply the two directions of each undirected
  pair (even row * odd row), linear head -> one logit per pair
  (`model.py:78-84`).

GCNConv here is PyG-semantics symmetric normalization with self-loops,
implemented as masked segment-sums (`linkpred.ops.segment`) — the
equivalent of torch-scatter. GraphNorm follows PyG:
`weight * (x - mean_scale*mean) / sqrt(E[(x - mean_scale*mean)^2] + eps) + bias`.

The reference's `sample_block` (`TwoWL/utils.py:60-68`) *rebuilds* the
message graph and ei2 without the sampled target edges every step —
data-dependent shapes. Here `sample_block_masks` produces boolean masks
over the static arrays instead: removed edges get weight 0, degrees are
recomputed by masked segment-sum, and ei2 columns sourced at a removed
edge are masked off. The jit-compiled step never changes shape.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from linkpred.ops.segment import (
    SegmentPlan,
    composed_operands,
    gather_rows_planned,
    gather_sum_composed,
    gcn_norm_coefficients,
    segment_sum,
    segment_sum_planned,
    take_rows,
)


@dataclasses.dataclass(frozen=True)
class TwoWLConfig:
    """Hyperparameters; defaults are the reference's published best trial
    (`logs.json`: lr 0.01, depths 2/2, channels 24/16, dropouts
    .5/.6/.5/.2/.4/.1, act0 true, act1 false)."""

    max_degree: int
    channels_1wl: int = 24
    channels_2wl: int = 16
    depth1: int = 2
    depth2: int = 2
    dp_emb: float = 0.5
    dp_1wl0: float = 0.2
    dp_1wl1: float = 0.4
    dp_2wl: float = 0.1
    act0: bool = True
    act1: bool = False
    learning_rate: float = 0.01
    eps: float = 1e-5
    # Node-feature regime. True = the reference default: degree-indexed
    # embedding table, recomputed under the sample-block mask every step
    # (`model.py:47-55` embedding branch + `utils.py:66-67` degree
    # recompute). False = a learnable FREE per-node embedding: the table
    # has one row per node and the feature index is the node id — the
    # reference's node-attribute branch (`model.py:49-52` Linear on x)
    # with x itself learnable, and the same transductive feature regime
    # as `pipelines.gcn_scale`. At >=50k nodes degree-only features are
    # structure-blind (33 distinct inputs for 50k nodes); free embeddings
    # are what carries the scale pipeline past the 1-WL GCN baseline.
    # Callers set max_degree = num_nodes - 1 so init sizes the table.
    degree_feature: bool = True
    # Feature dtype for the 2-WL stack (the edge-representation convs
    # over ei2, the gather-heavy part of the scale step). "bf16" halves
    # the bytes of every ei2 gather/segment-sum. Params, the 1-WL stack,
    # GraphNorm statistics, and the loss stay f32. Default f32 (exact
    # parity with the reference numerics at fb-pages scale).
    compute_dtype: str = "f32"


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def _glorot(key, shape):
    lim = float(np.sqrt(6.0 / (shape[0] + shape[1])))
    return jax.random.uniform(key, shape, jnp.float32, -lim, lim)


def _gn_params(dim):
    return {
        "weight": jnp.ones((dim,)),
        "bias": jnp.zeros((dim,)),
        "mean_scale": jnp.ones((dim,)),
    }


def init_params(key, cfg: TwoWLConfig):
    n_keys = 2 + cfg.depth1 + 2 * cfg.depth2 + 1
    ks = iter(jax.random.split(key, n_keys))
    params = {
        "emb": jax.random.normal(next(ks), (cfg.max_degree + 1, cfg.channels_1wl)),
        "emb_gn": _gn_params(cfg.channels_1wl),
    }
    dims = [cfg.channels_1wl] * cfg.depth1 + [cfg.channels_2wl]
    params["conv1"] = [
        {
            "w": _glorot(next(ks), (dims[i], dims[i + 1])),
            "b": jnp.zeros((dims[i + 1],)),
            "gn": _gn_params(dims[i + 1]),
        }
        for i in range(cfg.depth1)
    ]
    params["conv2"] = [
        {
            "w": _glorot(next(ks), (cfg.channels_2wl, cfg.channels_2wl)),
            "b": jnp.zeros((cfg.channels_2wl,)),
            "gn": _gn_params(cfg.channels_2wl),
        }
        for _ in range(cfg.depth2)
    ]
    params["conv2r"] = [
        {
            "w": _glorot(next(ks), (cfg.channels_2wl, cfg.channels_2wl)),
            "b": jnp.zeros((cfg.channels_2wl,)),
            "gn": _gn_params(cfg.channels_2wl),
        }
        for _ in range(cfg.depth2)
    ]
    params["pred_w"] = _glorot(next(ks), (cfg.channels_2wl, 1))
    params["pred_b"] = jnp.zeros((1,))
    return params


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def graph_norm(p, x, eps: float = 1e-5):
    # statistics always in f32 (a bf16 mean over ~1e5 rows loses the
    # tail); output returns to the input dtype
    x32 = x.astype(jnp.float32)
    mean = x32.mean(axis=0, keepdims=True)
    centered = x32 - p["mean_scale"] * mean
    var = (centered**2).mean(axis=0, keepdims=True)
    out = p["weight"] * centered * jax.lax.rsqrt(var + eps) + p["bias"]
    return out.astype(x.dtype)


def gcn_conv(
    p, x, src, dst, num_rows: int, mask=None, sorted_dst: bool = False,
    norm=None, plan=None, src_plan=None,
):
    """PyG-style GCNConv: h=xW; out[t] = sum_e norm_e h[src_e] (+ self loop).

    `sorted_dst=True` when `dst` is presorted (host-sorted static edge
    structure) — the scatter then skips XLA's per-call sort. `norm` is an
    optional precomputed (edge_coeff, self_coeff) pair: the coefficients
    depend only on the (masked) edge structure, so stacked layers over the
    same graph compute them once (the reference recomputes inside every
    PyG GCNConv). `plan` is an optional `SegmentPlan.operands()` tuple for
    `dst` — the aggregation then runs scatter-free (see
    ops.segment.SegmentPlan). Dynamic edge masking composes in through
    `coeff` (masked edges carry weight 0, so their message rows are zero).
    """
    h = x @ p["w"].astype(x.dtype)
    coeff, self_coeff = norm if norm is not None else gcn_norm_coefficients(
        src, dst, num_rows, mask, indices_are_sorted=sorted_dst
    )
    # coefficients/bias follow the feature dtype (a stray f32 operand
    # would silently promote the whole bf16 2-WL path back to f32)
    coeff = coeff.astype(h.dtype)
    # `src_plan` (a SegmentPlan over the source rows) swaps the gather's
    # scatter-add VJP for the scatter-free planned segment-sum — the 2-WL
    # backward (ops.segment.gather_rows_planned)
    hs = (gather_rows_planned(h, src, src_plan) if src_plan
          else h[src])
    msgs = hs * coeff[:, None]
    if plan is not None:
        agg = segment_sum_planned(num_rows, msgs, *plan)
    else:
        agg = segment_sum(msgs, dst, num_rows, indices_are_sorted=sorted_dst)
    return (agg + self_coeff.astype(h.dtype)[:, None] * h
            + p["b"].astype(h.dtype))


class SplitArrays(NamedTuple):
    """Device-resident static arrays of one TwoWL split (see
    `data.twowl.TwoWLSplit` for the layout contract)."""

    msg_src: jnp.ndarray  # [Em]
    msg_dst: jnp.ndarray  # [Em]
    msg_perm: jnp.ndarray  # [Em] argsort(msg_dst)
    pos1_src: jnp.ndarray  # [R]
    pos1_dst: jnp.ndarray  # [R]
    e1_src: jnp.ndarray  # [S] message-edge id a; dir-1 source row = a ^ 1
    e1_dst: jnp.ndarray  # [S] sorted scatter destination (pads = R)
    e1_mask: jnp.ndarray  # [S]
    e2_src: jnp.ndarray  # [S] message-edge id a = dir-2 source row
    e2_dst: jnp.ndarray  # [S] sorted destination b ^ 1 (pads = R)
    e2_mask: jnp.ndarray  # [S]
    # scatter-free SegmentPlan.operands() for the three static structures
    # (sorted msg dst over nodes; e1/e2 dst over pos1 rows)
    msg_plan: tuple
    e1_plan: tuple
    e2_plan: tuple
    # gather-side plans over the 2-WL SOURCE rows (e1_src^1 / e2_src):
    # `ops.segment.gather_rows_planned` uses them to make the backward of
    # `e[src]` a planned segment-sum instead of an unsorted scatter over
    # every ei2 slot
    e1_gather_plan: tuple = ()
    e2_gather_plan: tuple = ()
    # composed one-gather-per-pass structures for the 2-WL convolutions
    # (`ops.segment.gather_sum_composed`): per direction a (fwd_ops,
    # bwd_ops) pair — the FAST path for forward(); the plans above remain
    # for the trial-major sweep path and as the semantic reference
    e1_cops: tuple = ()
    e2_cops: tuple = ()

    @staticmethod
    def from_split(s) -> "SplitArrays":
        R = len(s.pos1)
        msg_plan = SegmentPlan.build(
            s.msg[s.msg_perm][:, 1], s.num_nodes).operands()
        e1_plan_obj = SegmentPlan.build(s.e1_dst, R)
        e2_plan_obj = SegmentPlan.build(s.e2_dst, R)
        e1_plan = e1_plan_obj.operands()
        e2_plan = e2_plan_obj.operands()
        # gather plans over source rows (pads carry dst=R -> masked out;
        # clip keeps the forward gather in-bounds, coeff 0 kills the value)
        src1 = np.where(s.e1_mask, s.e1_src ^ 1, R)
        src2 = np.where(s.e2_mask, s.e2_src, R)
        e1_gp_obj = SegmentPlan.build(src1, R)
        e2_gp_obj = SegmentPlan.build(src2, R)
        e1_gp = e1_gp_obj.operands()
        e2_gp = e2_gp_obj.operands()
        # composed structures: slot->source-row in dst-grouped buckets
        # (forward) and slot->dst-row in src-grouped buckets (backward).
        # Only direction 1 needs them — the paired fused path in
        # `forward` recovers direction 2 from the same gather via the
        # parity symmetry (see the PAIRED fused path comment).
        e1_cops = (
            composed_operands(e1_plan_obj, src1, R),
            composed_operands(e1_gp_obj, np.where(s.e1_mask, s.e1_dst, R),
                              R),
        )
        return SplitArrays(
            msg_src=jnp.asarray(s.msg[:, 0]),
            msg_dst=jnp.asarray(s.msg[:, 1]),
            msg_perm=jnp.asarray(s.msg_perm),
            pos1_src=jnp.asarray(s.pos1[:, 0]),
            pos1_dst=jnp.asarray(s.pos1[:, 1]),
            e1_src=jnp.asarray(s.e1_src),
            e1_dst=jnp.asarray(s.e1_dst),
            e1_mask=jnp.asarray(s.e1_mask),
            e2_src=jnp.asarray(s.e2_src),
            e2_dst=jnp.asarray(s.e2_dst),
            e2_mask=jnp.asarray(s.e2_mask),
            msg_plan=msg_plan,
            e1_plan=e1_plan,
            e2_plan=e2_plan,
            e1_gather_plan=e1_gp,
            e2_gather_plan=e2_gp,
            e1_cops=e1_cops,
        )


def _dropout(key, x, rate):
    if isinstance(rate, float) and rate <= 0.0:
        return x
    keep = jax.random.bernoulli(key, 1.0 - rate, x.shape)
    # a traced f32 rate must not promote a bf16 feature path
    return jnp.where(keep, x / (1.0 - rate), 0.0).astype(x.dtype)


class DropRates(NamedTuple):
    """Dropout rates as traced scalars — vmappable across trials (the
    architecture stays static in TwoWLConfig; rates and learning rate are
    data, so a whole refinement sweep trains in one vmapped program)."""

    dp_emb: jnp.ndarray
    dp_1wl0: jnp.ndarray
    dp_1wl1: jnp.ndarray
    dp_2wl: jnp.ndarray

    @staticmethod
    def from_config(cfg: "TwoWLConfig") -> "DropRates":
        return DropRates(cfg.dp_emb, cfg.dp_1wl0, cfg.dp_1wl1, cfg.dp_2wl)


def forward(
    params,
    cfg: TwoWLConfig,
    node_deg,  # [N] int32 degree feature (masked-graph degrees in training)
    arrays: SplitArrays,
    msg_mask,  # [Em] bool in ORIGINAL edge order (False on removed positives)
    sel_idx,  # [B] doubled row indices into pos1 (even count)
    key=None,  # None => eval (no dropout)
    rates: "DropRates | None" = None,  # traced dropout rates (default: cfg)
):
    """Returns one logit per undirected selected pair: [B // 2].

    Every scatter runs over host-presorted destinations
    (`indices_are_sorted=True`): the 1-WL message edges through `msg_perm`,
    the two 2-WL directions through their dedicated sorted views. The
    dynamic sample-block mask composes in by gathers (`msg_mask[perm]`,
    `msg_mask[e*_src]`) — shapes never change.
    """
    train = key is not None
    n_drops = 1 + cfg.depth1 + 2 * cfg.depth2
    dks = iter(jax.random.split(key, n_drops)) if train else None
    r = rates if rates is not None else DropRates.from_config(cfg)

    def drop(x, rate):
        return _dropout(next(dks), x, rate) if train else x

    N = node_deg.shape[0]
    R = arrays.pos1_src.shape[0]

    x = params["emb"][node_deg]
    x = graph_norm(params["emb_gn"], x, cfg.eps)
    x = drop(x, r.dp_emb)

    src_s = arrays.msg_src[arrays.msg_perm]
    dst_s = arrays.msg_dst[arrays.msg_perm]
    mask_s = msg_mask[arrays.msg_perm]
    norm1 = gcn_norm_coefficients(
        src_s, dst_s, N, mask_s, indices_are_sorted=True,
        plan=arrays.msg_plan,
    )
    for i, layer in enumerate(params["conv1"]):
        x = gcn_conv(layer, x, src_s, dst_s, N, mask_s, sorted_dst=True,
                     norm=norm1, plan=arrays.msg_plan)
        x = graph_norm(layer["gn"], x, cfg.eps)
        last = i == cfg.depth1 - 1
        x = drop(x, r.dp_1wl1 if last else r.dp_1wl0)
        if (cfg.act1 if last else cfg.act0):
            x = jax.nn.relu(x)

    # edge representation (`ops.sddmm.edge_hadamard` — reference
    # `model.py:75`), cast to the 2-WL compute dtype: everything below
    # runs over the S-slot ei2 structure, where bf16 halves every
    # gather/segment-sum byte
    from linkpred.ops.sddmm import edge_hadamard

    cd = jnp.bfloat16 if cfg.compute_dtype == "bf16" else jnp.float32
    e = edge_hadamard(arrays.pos1_src, arrays.pos1_dst, x).astype(cd)

    # parity-reverse convention: an edge-row's partner is index XOR 1;
    # dir-1 sources are the partners of the stored message-edge ids,
    # dir-2 destinations are pre-XORed and pre-sorted in the data layout
    if arrays.e1_cops:
        # PAIRED fused path — one 2C-channel S-gather per layer serves
        # BOTH direction branches (fwd and bwd; ops.segment.
        # gather_sum_composed). Two facts make this exact: (1) the slot coefficient dinv[src]*dinv[dst]*mask
        # factorizes into row-wise multiplies — dinv[dst] is constant
        # per segment (applied on the output rows), dinv[src]*mask rides
        # the input rows; (2) dir-2 enumerates the SAME (a, b) slot set
        # as dir-1 with source a (vs a^1) and destination b^1 (vs b) —
        # the parity image (`data/twowl._pad_and_sort_ei2`). Packing
        # row r as [h_A[r]*m_A[r] || h_B[r^1]*m_B[r^1]] makes the dir-1
        # bucket-sum produce both branches at once (segment b's dir-2
        # target is the constant b^1, recovered by a parity row swap). A
        # slot gathers row a^1 and dies when message
        # edge a is removed, so the dir-1 row mask is the parity-swapped
        # msg_mask; dir-2 masks by its own gathered row. Pred rows
        # (>= num_msg) never source 2-WL messages.
        num_msg = msg_mask.shape[0]
        C2 = cfg.channels_2wl

        def swap(v):  # parity-partner row view: r <-> r^1
            return v.reshape(-1, 2, *v.shape[1:])[:, ::-1].reshape(v.shape)

        ones_pred = jnp.ones((R - num_msg,), msg_mask.dtype)
        rm2 = jnp.concatenate([msg_mask, ones_pred]).astype(jnp.float32)
        rm1 = swap(rm2)
        # both directions mask a slot by msg_mask[a], so
        # deg2[b^1] == deg1[b]: ONE 1-channel degree pass, parity-swapped
        deg1 = gather_sum_composed(
            rm1[:, None], arrays.e1_cops[0], arrays.e1_cops[1])[:, 0] + 1.0
        dinv1 = jax.lax.rsqrt(jnp.maximum(deg1, 1e-12))
        dinv2 = swap(dinv1)
        cd_ = e.dtype
        mA = (dinv1 * rm1).astype(cd_)
        mB = swap(mA)  # == dinv2 * rm2
        outA = dinv1.astype(cd_)[:, None]
        outB = dinv2.astype(cd_)[:, None]
        selfA = (dinv1 * dinv1).astype(cd_)[:, None]
        selfB = (dinv2 * dinv2).astype(cd_)[:, None]

        for i in range(cfg.depth2):
            lA, lB = params["conv2"][i], params["conv2r"][i]
            hA = e @ lA["w"].astype(cd_)
            hB = e @ lB["w"].astype(cd_)
            h2 = jnp.concatenate(
                [hA * mA[:, None], swap(hB * mB[:, None])], axis=1)
            out = gather_sum_composed(
                h2, arrays.e1_cops[0], arrays.e1_cops[1])
            hA = out[:, :C2] * outA + selfA * hA + lA["b"].astype(cd_)
            hB = swap(out[:, C2:]) * outB + selfB * hB + lB["b"].astype(cd_)
            hA = jax.nn.relu(drop(graph_norm(lA["gn"], hA, cfg.eps),
                                  r.dp_2wl))
            hB = jax.nn.relu(drop(graph_norm(lB["gn"], hB, cfg.eps),
                                  r.dp_2wl))
            e = hA + hB
    else:
        m1 = arrays.e1_mask & msg_mask[arrays.e1_src]
        m2 = arrays.e2_mask & msg_mask[arrays.e2_src]
        src1 = arrays.e1_src ^ 1
        normA = gcn_norm_coefficients(
            src1, arrays.e1_dst, R, m1, indices_are_sorted=True,
            plan=arrays.e1_plan,
        )
        normB = gcn_norm_coefficients(
            arrays.e2_src, arrays.e2_dst, R, m2, indices_are_sorted=True,
            plan=arrays.e2_plan,
        )
        for i in range(cfg.depth2):
            def branch(layer, src, dst, m, norm, plan, src_plan):
                h = gcn_conv(layer, e, src, dst, R, m, sorted_dst=True,
                             norm=norm, plan=plan, src_plan=src_plan)
                h = graph_norm(layer["gn"], h, cfg.eps)
                h = drop(h, r.dp_2wl)
                return jax.nn.relu(h)

            e = branch(
                params["conv2"][i], src1, arrays.e1_dst, m1, normA,
                arrays.e1_plan, arrays.e1_gather_plan or None,
            ) + branch(
                params["conv2r"][i], arrays.e2_src, arrays.e2_dst, m2,
                normB, arrays.e2_plan, arrays.e2_gather_plan or None,
            )

    sel = e[sel_idx]  # [B, ch2]
    paired = (sel[0::2] * sel[1::2]).astype(jnp.float32)  # dir product
    return (paired @ params["pred_w"] + params["pred_b"])[:, 0]


# ---------------------------------------------------------------------------
# sample_block as mask arithmetic + train/eval steps
# ---------------------------------------------------------------------------


def double_index(ids: jnp.ndarray) -> jnp.ndarray:
    """Pair ids -> interleaved doubled row ids [2P] (reference
    `double(..., for_index=True)`, `utils.py:86-89`)."""
    return jnp.stack([2 * ids, 2 * ids + 1], axis=1).reshape(-1)


def sample_block_masks(pos_ids, num_msg: int, e_src, e_mask):
    """Masks implementing reference `sample_block` (`utils.py:60-68`):
    remove the sampled positive pairs' doubled edges from the message graph
    and mask ei2 columns sourced at a removed edge. Degrees are recomputed
    by the caller with a masked segment-sum."""
    removed = jnp.zeros((num_msg,), dtype=bool).at[double_index(pos_ids)].set(True)
    return ~removed, e_mask & ~removed[e_src]


@partial(jax.jit, static_argnames=("cfg", "optimizer", "num_nodes"))
def train_step(
    params,
    opt_state,
    key,
    pos_ids,  # [P] sampled train-pos pair ids
    neg_ids,  # [P] sampled train-neg pair ids
    arrays: SplitArrays,
    cfg: TwoWLConfig,
    optimizer,
    num_nodes: int,
    rates: "DropRates | None" = None,
):
    num_msg = arrays.msg_src.shape[0]
    idx1 = double_index(pos_ids)
    idx2 = double_index(neg_ids) + num_msg
    removed = jnp.zeros((num_msg,), dtype=bool).at[idx1].set(True)
    msg_mask = ~removed
    if cfg.degree_feature:
        deg = segment_sum_planned(
            num_nodes, msg_mask[arrays.msg_perm].astype(jnp.float32),
            *arrays.msg_plan,
        ).astype(jnp.int32)
    else:
        deg = jnp.arange(num_nodes, dtype=jnp.int32)  # free per-node rows

    sel = jnp.concatenate([idx1, idx2])
    y = jnp.concatenate(
        [jnp.ones_like(pos_ids, dtype=jnp.float32),
         jnp.zeros_like(neg_ids, dtype=jnp.float32)]
    )

    def loss_fn(p):
        logits = forward(p, cfg, deg, arrays, msg_mask, sel, key, rates)
        return optax.sigmoid_binary_cross_entropy(logits, y).mean(), logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    return params, opt_state, loss, logits, y


@partial(
    jax.jit,
    static_argnames=("cfg", "optimizer", "num_nodes", "num_epochs",
                     "eval_every", "early_stop"),
)
def train_scan(
    params,
    opt_state,
    key,
    pos_ids_epochs,  # [E, P] per-epoch sampled train-pos pair ids
    neg_ids_epochs,  # [E, P]
    trn: "SplitArrays",
    val: "SplitArrays",
    val_y,  # [num_val_pairs] float32 labels
    node_deg,  # [N] eval-time degree feature
    cfg: TwoWLConfig,
    optimizer,
    num_nodes: int,
    num_epochs: int,
    eval_every: int = 1,
    rates: "DropRates | None" = None,
    init_best=None,  # (best_params, best_auc[, since_best]) from a chunk
    early_stop: int | None = None,
):
    """Whole training run as ONE on-device `lax.scan`: per epoch, a masked
    train step plus a val-split eval with on-device AUC; the best-val
    parameters are kept by a tree-select. Removes the per-epoch host
    round-trips of the reference's loop (`train.py:86-107`) — the full
    1000-epoch routine can be a single device program.

    `init_best` seeds the best-val carry so a long run can be CHUNKED into
    several scan calls: pipelines split the epoch axis for progress output
    and the early-stop check between chunks, and thread (params,
    opt_state, best) through identical-shape chunks (one compile, reused).

    `early_stop` makes the stop EPOCH-EXACT inside the scan, matching
    reference `train.py:86-107` epoch-for-epoch: an `epochs-since-best`
    counter rides the carry, and once it exceeds `early_stop` a
    `lax.cond` freezes the remaining epochs into no-ops (the chip skips
    the train/eval branch entirely, so post-stop epochs cost ~nothing and
    the chunk loop exits at the next boundary). Frozen epochs log
    (loss 0, auc -1) history markers.

    Returns (final_params, final_opt_state, best_params, best_val_auc,
    since_best, per-epoch (loss, val_auc)).
    """
    from linkpred.utils.metrics import roc_auc_jax

    num_msg_v = val.msg_src.shape[0]
    num_pred_v = val.pos1_src.shape[0] - num_msg_v
    val_sel = num_msg_v + jnp.arange(num_pred_v, dtype=jnp.int32)
    val_msg_mask = jnp.ones((num_msg_v,), dtype=bool)

    def active_epoch(carry, inp):
        params, opt_state, best_params, best_auc, since, key = carry
        epoch_idx, pos_ids, neg_ids = inp
        key, k_step = jax.random.split(key)
        params, opt_state, loss, _, _ = train_step(
            params, opt_state, k_step, pos_ids, neg_ids,
            trn, cfg, optimizer, num_nodes, rates,
        )

        def do_eval(p):
            logits = forward(p, cfg, node_deg, val, val_msg_mask, val_sel, None)
            return roc_auc_jax(val_y, logits)

        if eval_every > 1:
            auc = jax.lax.cond(
                epoch_idx % eval_every == eval_every - 1,
                do_eval,
                lambda p: jnp.float32(-1.0),
                params,
            )
        else:
            auc = do_eval(params)
        improved = auc > best_auc
        best_params = jax.tree_util.tree_map(
            lambda new, old: jnp.where(improved, new, old), params, best_params
        )
        best_auc = jnp.where(improved, auc, best_auc)
        since = jnp.where(improved, 0, since + 1)
        return (params, opt_state, best_params, best_auc, since, key), (
            loss, auc)

    def epoch(carry, inp):
        if early_stop is None:
            return active_epoch(carry, inp)
        def frozen(c, i):
            # keep incrementing since-best so callers can recover the
            # exact stop epoch (stop - (since - early_stop - 1)) after a
            # chunk ends; everything else is untouched
            c = (*c[:4], c[4] + 1, c[5])
            return c, (jnp.float32(0.0), jnp.float32(-1.0))

        return jax.lax.cond(
            carry[4] > early_stop, frozen, active_epoch, carry, inp)

    if init_best is None:
        init_best = (params, jnp.float32(0.0))
    if len(init_best) == 2:
        init_best = (*init_best, jnp.int32(0))
    best_p0, best_a0, since0 = init_best
    init = (params, opt_state, best_p0, best_a0, jnp.int32(since0), key)
    epoch_ids = jnp.arange(num_epochs, dtype=jnp.int32)
    (params, opt_state, best_params, best_auc, since, _), hist = jax.lax.scan(
        epoch, init, (epoch_ids, pos_ids_epochs, neg_ids_epochs),
        length=num_epochs,
    )
    return params, opt_state, best_params, best_auc, since, hist


@partial(jax.jit, static_argnames=("cfg", "num_nodes"))
def eval_scores(
    params,
    node_deg,
    arrays: SplitArrays,
    cfg: TwoWLConfig,
    num_nodes: int,
):
    """Scores for every prediction pair of a split (rows after the message
    block), matching reference `test` (`train.py:50-68`)."""
    num_msg = arrays.msg_src.shape[0]
    num_pred = arrays.pos1_src.shape[0] - num_msg
    msg_mask = jnp.ones((num_msg,), dtype=bool)
    sel = num_msg + jnp.arange(num_pred, dtype=jnp.int32)
    logits = forward(params, cfg, node_deg, arrays, msg_mask, sel, None)
    return jax.nn.sigmoid(logits)


# ---------------------------------------------------------------------------
# trial-major multi-trial training (the batched hyperparameter sweep)
# ---------------------------------------------------------------------------
#
# Instead of an outer `jax.vmap` over sweep trials, which would give every
# embedding lookup, message gather and planned segment-sum a leading batch
# dimension, the trial-major layout keeps the trial axis in TRAILING dims:
# features are [rows, T, C], row-indexed parameters put T after the index
# axis (emb: [D+1, T, C]), and every gather stays a leading-axis gather;
# matmuls become einsum-batched calls. One compiled program trains T
# models at once. Whether this beats a plain vmap on a GPU is not
# measured yet.

TRIAL_EMB_PATH = "emb"


def init_params_trials(key, cfg: TwoWLConfig, n_trials: int):
    """Per-trial params: leaves get a trial axis — axis 0 everywhere except
    the degree-embedding table, which keeps its index axis leading
    ([max_degree+1, T, C]) so lookups are leading-axis gathers."""
    ks = jax.random.split(key, n_trials)
    p = jax.vmap(lambda k: init_params(k, cfg))(ks)
    p["emb"] = jnp.moveaxis(p["emb"], 0, 1)
    return p


def _trial_axes(params):
    """Pytree of ints: which axis of each leaf is the trial axis."""
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: 1 if (
            len(path) == 1
            and getattr(path[0], "key", None) == TRIAL_EMB_PATH
        ) else 0,
        params,
    )


def _bcast_trial(v, leaf_ndim: int, axis: int):
    shape = [1] * leaf_ndim
    shape[axis] = v.shape[0]
    return v.reshape(shape)


def extract_trial(params, i: int):
    """Single-trial params (standard layout) from a trial-major pytree."""
    axes = _trial_axes(params)
    return jax.tree_util.tree_map(
        lambda leaf, ax: jnp.take(leaf, i, axis=ax), params, axes
    )


def take_trials(params, idx):
    """Trial-major pytree restricted to the trial subset `idx` (int array).

    Used by successive halving: survivors keep their learned weights (and,
    via `take_trials` on the Adam mu/nu pytrees, their optimizer moments)
    when the losing trials are dropped from the program."""
    axes = _trial_axes(params)
    idx = jnp.asarray(idx)
    return jax.tree_util.tree_map(
        lambda leaf, ax: jnp.take(leaf, idx, axis=ax), params, axes
    )


def _gcn_conv_trials(p, x, src, coeff, self_coeff, num_rows, plan,
                     src_plan=None):
    """x [R, T, C_in] -> [R', T, C_out]; p leaves carry trial axis 0."""
    h = jnp.einsum("rtc,tcd->rtd", x, p["w"])
    hs = (gather_rows_planned(h, src, src_plan) if src_plan
          else take_rows(h, src))
    msgs = hs * coeff[:, None, None]
    agg = segment_sum_planned(num_rows, msgs, *plan)
    return agg + self_coeff[:, None, None] * h + p["b"][None]


class TrialRates(NamedTuple):
    """Per-trial dropout rates, each [T]."""

    dp_emb: jnp.ndarray
    dp_1wl0: jnp.ndarray
    dp_1wl1: jnp.ndarray
    dp_2wl: jnp.ndarray


def _dropout_trials(key, x, rate_t):
    # x [R, T, C], rate_t [T] -> independent masks per trial
    keep_p = 1.0 - rate_t[:, None]  # [T, 1] broadcasts over [R, T, C]
    keep = jax.random.bernoulli(key, keep_p, x.shape)
    return jnp.where(keep, x / keep_p, 0.0)


def forward_trials(
    params,
    cfg: TwoWLConfig,
    node_deg,
    arrays: SplitArrays,
    msg_mask,
    sel_idx,
    key=None,
    rates: "TrialRates | None" = None,
):
    """Trial-major forward: one program scoring T models; returns
    logits [B // 2, T]."""
    train = key is not None
    n_drops = 1 + cfg.depth1 + 2 * cfg.depth2
    dks = iter(jax.random.split(key, n_drops)) if train else None

    def drop(x, rate_t):
        return _dropout_trials(next(dks), x, rate_t) if train else x

    N = node_deg.shape[0]
    R = arrays.pos1_src.shape[0]

    x = take_rows(params["emb"], node_deg)  # [N, T, C]
    x = graph_norm(params["emb_gn"], x, cfg.eps)
    if train:
        x = drop(x, rates.dp_emb)

    src_s = arrays.msg_src[arrays.msg_perm]
    dst_s = arrays.msg_dst[arrays.msg_perm]
    mask_s = msg_mask[arrays.msg_perm]
    coeff1, self1 = gcn_norm_coefficients(
        src_s, dst_s, N, mask_s, indices_are_sorted=True,
        plan=arrays.msg_plan,
    )
    for i, layer in enumerate(params["conv1"]):
        x = _gcn_conv_trials(layer, x, src_s, coeff1, self1, N,
                             arrays.msg_plan)
        x = graph_norm(layer["gn"], x, cfg.eps)
        last = i == cfg.depth1 - 1
        if train:
            x = drop(x, rates.dp_1wl1 if last else rates.dp_1wl0)
        if (cfg.act1 if last else cfg.act0):
            x = jax.nn.relu(x)

    e = take_rows(x, arrays.pos1_src) * take_rows(x, arrays.pos1_dst)

    if arrays.e1_cops:
        # paired one-gather fused path, trial-major form (see the
        # single-trial `forward` for the derivation — gather_sum_composed
        # flattens trailing dims, so [R, T, 2C] packs both directions of
        # all T trials into the SAME S-row gather)
        num_msg = msg_mask.shape[0]
        C2 = cfg.channels_2wl

        def swap(v):
            return v.reshape(-1, 2, *v.shape[1:])[:, ::-1].reshape(v.shape)

        ones_pred = jnp.ones((R - num_msg,), msg_mask.dtype)
        rm2 = jnp.concatenate([msg_mask, ones_pred]).astype(jnp.float32)
        rm1 = swap(rm2)
        deg1 = gather_sum_composed(
            rm1[:, None], arrays.e1_cops[0], arrays.e1_cops[1])[:, 0] + 1.0
        dinv1 = jax.lax.rsqrt(jnp.maximum(deg1, 1e-12))
        dinv2 = swap(dinv1)
        mA = (dinv1 * rm1)[:, None, None]
        mB = swap(mA)
        outA, outB = dinv1[:, None, None], dinv2[:, None, None]
        selfA, selfB = (dinv1 * dinv1)[:, None, None], None
        selfB = swap(selfA)
        for i in range(cfg.depth2):
            lA, lB = params["conv2"][i], params["conv2r"][i]
            hA = jnp.einsum("rtc,tcd->rtd", e, lA["w"])
            hB = jnp.einsum("rtc,tcd->rtd", e, lB["w"])
            h2 = jnp.concatenate([hA * mA, swap(hB * mB)], axis=-1)
            out = gather_sum_composed(
                h2, arrays.e1_cops[0], arrays.e1_cops[1])
            hA = out[..., :C2] * outA + selfA * hA + lA["b"][None]
            hB = (swap(out[..., C2:]) * outB + selfB * hB
                  + lB["b"][None])
            hA = graph_norm(lA["gn"], hA, cfg.eps)
            hB = graph_norm(lB["gn"], hB, cfg.eps)
            if train:
                hA = drop(hA, rates.dp_2wl)
                hB = drop(hB, rates.dp_2wl)
            e = jax.nn.relu(hA) + jax.nn.relu(hB)
    else:
        m1 = arrays.e1_mask & msg_mask[arrays.e1_src]
        m2 = arrays.e2_mask & msg_mask[arrays.e2_src]
        src1 = arrays.e1_src ^ 1
        coeffA, selfA = gcn_norm_coefficients(
            src1, arrays.e1_dst, R, m1, indices_are_sorted=True,
            plan=arrays.e1_plan,
        )
        coeffB, selfB = gcn_norm_coefficients(
            arrays.e2_src, arrays.e2_dst, R, m2, indices_are_sorted=True,
            plan=arrays.e2_plan,
        )
        for i in range(cfg.depth2):
            def branch(layer, src, coeff, selfc, plan, src_plan):
                h = _gcn_conv_trials(layer, e, src, coeff, selfc, R, plan,
                                     src_plan)
                h = graph_norm(layer["gn"], h, cfg.eps)
                if train:
                    h = drop(h, rates.dp_2wl)
                return jax.nn.relu(h)

            e = branch(params["conv2"][i], src1, coeffA, selfA,
                       arrays.e1_plan,
                       arrays.e1_gather_plan or None) + branch(
                params["conv2r"][i], arrays.e2_src, coeffB, selfB,
                arrays.e2_plan, arrays.e2_gather_plan or None,
            )

    sel = take_rows(e, sel_idx)  # [B, T, C]
    paired = sel[0::2] * sel[1::2]
    logits = jnp.einsum("btc,tco->bto", paired, params["pred_w"])[..., 0]
    return logits + params["pred_b"][None, :, 0]


@partial(jax.jit, static_argnames=("cfg", "optimizer", "num_nodes"))
def train_step_trials(
    params,
    opt_state,
    key,
    pos_ids,
    neg_ids,
    arrays: SplitArrays,
    cfg: TwoWLConfig,
    optimizer,  # optax.adam(1.0); per-trial lr applied to its updates
    lrs,  # [T] learning rates
    num_nodes: int,
    rates: TrialRates,
):
    """One step of T simultaneous trials (shared batch schedule, per-trial
    params/dropout/lr). Per-trial Adam with lr via update scaling: Adam's
    direction is invariant to gradient scale, so scaling the unit-lr
    updates by lr_t is exactly per-trial Adam."""
    num_msg = arrays.msg_src.shape[0]
    idx1 = double_index(pos_ids)
    idx2 = double_index(neg_ids) + num_msg
    removed = jnp.zeros((num_msg,), dtype=bool).at[idx1].set(True)
    msg_mask = ~removed
    deg = segment_sum_planned(
        num_nodes, msg_mask[arrays.msg_perm].astype(jnp.float32),
        *arrays.msg_plan,
    ).astype(jnp.int32)

    sel = jnp.concatenate([idx1, idx2])
    y = jnp.concatenate(
        [jnp.ones_like(pos_ids, dtype=jnp.float32),
         jnp.zeros_like(neg_ids, dtype=jnp.float32)]
    )

    def loss_fn(p):
        logits = forward_trials(p, cfg, deg, arrays, msg_mask, sel, key, rates)
        per_trial = optax.sigmoid_binary_cross_entropy(
            logits, y[:, None]
        ).mean(axis=0)  # [T]
        return per_trial.sum(), per_trial

    (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    axes = _trial_axes(updates)
    updates = jax.tree_util.tree_map(
        lambda u, ax: u * _bcast_trial(lrs, u.ndim, ax), updates, axes
    )
    params = optax.apply_updates(params, updates)
    return params, opt_state, losses


@partial(
    jax.jit,
    static_argnames=("cfg", "optimizer", "num_nodes", "num_epochs"),
)
def train_scan_trials(
    params,
    opt_state,
    key,
    pos_ids_epochs,  # [E, P] shared across trials
    neg_ids_epochs,
    trn: SplitArrays,
    val: SplitArrays,
    val_y,
    node_deg,
    cfg: TwoWLConfig,
    optimizer,
    lrs,  # [T]
    num_nodes: int,
    num_epochs: int,
    rates: TrialRates,
    init_best=None,  # optional (best_params, best_aucs) from a prior chunk
):
    """Whole T-trial sweep as one `lax.scan`: per epoch, one trial-major
    step + per-trial val AUC; best-val params tracked per trial.

    `init_best` seeds the best-val carry for chunked long runs (see
    `train_scan`).

    Returns (final_params, final_opt_state, best_params, best_val_aucs [T],
    history (losses [E, T], aucs [E, T]))."""
    from linkpred.utils.metrics import roc_auc_trials

    num_msg_v = val.msg_src.shape[0]
    num_pred_v = val.pos1_src.shape[0] - num_msg_v
    val_sel = num_msg_v + jnp.arange(num_pred_v, dtype=jnp.int32)
    val_msg_mask = jnp.ones((num_msg_v,), dtype=bool)
    n_trials = lrs.shape[0]
    axes = _trial_axes(params)

    def epoch(carry, inp):
        params, opt_state, best_params, best_auc, key = carry
        pos_ids, neg_ids = inp
        key, k_step = jax.random.split(key)
        params, opt_state, losses = train_step_trials(
            params, opt_state, k_step, pos_ids, neg_ids,
            trn, cfg, optimizer, lrs, num_nodes, rates,
        )
        logits = forward_trials(
            params, cfg, node_deg, val, val_msg_mask, val_sel, None, None
        )  # [V, T]
        auc = roc_auc_trials(val_y, logits)  # [T]
        improved = auc > best_auc
        best_params = jax.tree_util.tree_map(
            lambda new, old, ax: jnp.where(
                _bcast_trial(improved, new.ndim, ax), new, old
            ),
            params, best_params, axes,
        )
        best_auc = jnp.where(improved, auc, best_auc)
        return (params, opt_state, best_params, best_auc, key), (losses, auc)

    best_p0, best_a0 = (
        init_best if init_best is not None
        else (params, jnp.full((n_trials,), -1.0, jnp.float32))
    )
    init = (params, opt_state, best_p0, best_a0, key)
    (params, opt_state, best_params, best_auc, _), hist = jax.lax.scan(
        epoch, init, (pos_ids_epochs, neg_ids_epochs), length=num_epochs
    )
    return params, opt_state, best_params, best_auc, hist

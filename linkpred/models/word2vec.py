"""Skip-gram negative-sampling (word2vec) trainer, fully on-device.

Replaces gensim's C/Cython `Word2Vec` used by the reference for node
embeddings (`LogisticRegression_Linkprediction/utils/feature_extraction.py:17`
with `window=10, sg=1, workers=8`; `SEAL/config/data.py:66` with
`size=dim, window=10, sg=1, iter=1`) and Spark MLlib's Word2Vec
(`node2vec_spark/.../Word2vec.scala:35-39`).

Design: one jit-compiled `lax.scan` over SGD steps. Each step samples a
batch of (center, context) pairs *directly from the walk matrix on device*,
with gensim's "reduced window" triangular offset distribution reproduced by
rejecting offsets larger than a per-center uniform window cap. Negatives
come from the unigram^0.75 noise distribution via a precomputed alias
table. Updates are plain SGD with gensim's linear learning-rate decay.
There is no hogwild — collisions within a batch are resolved exactly by
scatter-add, so results are deterministic given the PRNG key.

Throughput structure: a random row gather/scatter on a [235k, 128] table is
bound by the number of rows it touches more than by their bytes, so the step
is engineered to minimize *random row touches*:

- **center-major sampling** — each sampled center position emits
  `ctx_per_center` context candidates sharing ONE center gather and ONE
  center scatter (context grads are summed over the ctx axis first);
  the per-center window cap is drawn once, which is exactly gensim's
  per-position reduced window.
- **shared negative pool** — instead of `negatives` per-pair noise rows
  (the dominant row count: B*K gathers + B*K scatter rows), each step
  draws one pool of `neg_pool` noise rows; every pair scores against the
  whole pool with weight `negatives/neg_pool`. The expected gradient is
  identical (each pool row is an iid draw from the same unigram^0.75
  distribution) with lower variance, and both the scoring and the pool
  update become [B, D] x [D, neg_pool] matmuls touching `neg_pool`
  random rows per step instead of B*K.

Setting `neg_pool=0` restores the classic per-pair negative path (strict
gensim per-pair semantics; exercised by
`tests/test_word2vec.py::TestSGNS::test_classic_negatives_path`).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from linkpred.ops.walk import alias_setup_rows


@dataclasses.dataclass(frozen=True)
class SGNSConfig:
    dim: int = 100
    window: int = 10
    negatives: int = 5
    epochs: int = 5
    batch_size: int = 8192
    lr: float = 0.025
    min_lr: float = 1e-4
    ns_exponent: float = 0.75
    # Context candidates emitted per sampled center position (module
    # docstring: amortizes the center row gather/scatter). 1 = one pair
    # per center draw.
    ctx_per_center: int = 8
    # Shared negative pool size per step; 0 = classic per-pair negatives.
    neg_pool: int = 512
    # Frequent-word subsampling threshold (gensim `sample`). Default off: on
    # random-walk corpora over small graphs the per-node frequency is ~1/N,
    # so gensim's default 1e-3 threshold only suppresses hub nodes — and
    # link-prediction features need hub embeddings trained, not starved.
    subsample: float = 0.0


def _noise_alias(counts: np.ndarray, ns_exponent: float):
    """Alias table over the unigram^0.75 noise distribution.

    Routed through the threaded C++ alias builder (`native.build_alias_rows`)
    when the host library is available: the pure-Python Vose loop costs
    seconds at a 235k-entry vocabulary and used to be paid *inside* every
    `train_sgns` call, contaminating throughput measurements (round-2
    bench). Fallback is the numpy/Python reference implementation."""
    from linkpred import native

    p = counts.astype(np.float64) ** ns_exponent
    p = p / p.sum()
    valid = np.ones((1, len(p)), dtype=bool)
    if native.available():
        J, q = native.build_alias_rows(p[None, :], valid)
    else:
        J, q = alias_setup_rows(p[None, :], valid)
    return J[0], q[0]


@dataclasses.dataclass(frozen=True)
class SGNSPrep:
    """Host-side preparation for one walk corpus: noise alias + subsample
    keep-probabilities. Build once per corpus (`prepare_sgns`) and reuse
    across `train_sgns` calls — the alias depends only on token counts, not
    on the PRNG key or schedule, so rebuilding it per call is pure waste
    (gensim likewise builds its cumulative noise table once in
    `make_cum_table`, reference `requirements.txt:13` dependency)."""

    noise_J: np.ndarray
    noise_q: np.ndarray
    keep: np.ndarray
    prep_seconds: float


def prepare_sgns(
    walks_np: np.ndarray, num_nodes: int, cfg: SGNSConfig = SGNSConfig()
) -> SGNSPrep:
    import time

    t0 = time.perf_counter()
    counts = np.bincount(walks_np.reshape(-1), minlength=num_nodes)
    noise_J, noise_q = _noise_alias(counts, cfg.ns_exponent)
    keep = _keep_prob(counts, cfg.subsample)
    return SGNSPrep(noise_J, noise_q, keep, time.perf_counter() - t0)


def _keep_prob(counts: np.ndarray, sample: float) -> np.ndarray:
    """gensim subsampling keep-probability per word:
    keep = (sqrt(f/t) + 1) * t/f, clipped to 1, where f is the corpus
    frequency and t the `sample` threshold."""
    total = counts.sum()
    if sample <= 0 or total == 0:
        return np.ones_like(counts, dtype=np.float32)
    f = np.maximum(counts, 1) / total
    keep = (np.sqrt(f / sample) + 1) * (sample / f)
    return np.minimum(keep, 1.0).astype(np.float32)


@partial(jax.jit, static_argnames=("cfg", "num_steps"), donate_argnums=(1, 2))
def _train(
    key,
    w_in: jnp.ndarray,
    w_out: jnp.ndarray,
    walks: jnp.ndarray,
    noise_J: jnp.ndarray,
    noise_q: jnp.ndarray,
    keep: jnp.ndarray,
    cfg: SGNSConfig,
    num_steps: int,
):
    num_nodes = w_in.shape[0]
    W, L = walks.shape
    K = cfg.negatives
    nc = max(1, min(cfg.ctx_per_center, cfg.batch_size))
    Bc = max(1, cfg.batch_size // nc)  # centers per step
    lrs = jnp.linspace(cfg.lr, cfg.min_lr, num_steps)

    def sample_pairs(ks):
        """Center-major pair sampling: [Bc] centers x [Bc, nc] contexts.
        One [Bc]-row gather pulls each sampled walk ROW; center/context
        tokens come from `take_along_axis` on it — Bc row transactions
        instead of Bc*(1+nc) scalar gathers (row-transaction bound,
        module docstring)."""
        widx = jax.random.randint(ks[0], (Bc,), 0, W)
        t = jax.random.randint(ks[1], (Bc,), 0, L)
        # per-CENTER window cap = gensim's per-position reduced window
        cap = jax.random.randint(ks[2], (Bc, 1), 1, cfg.window + 1)
        direction = jax.random.randint(ks[3], (Bc, nc), 0, 2) * 2 - 1
        mag = jax.random.randint(ks[4], (Bc, nc), 1, cfg.window + 1)
        ctx_t = t[:, None] + direction * mag
        valid = (mag <= cap) & (ctx_t >= 0) & (ctx_t < L)
        ctx_t = jnp.clip(ctx_t, 0, L - 1)
        rows = walks[widx]  # [Bc, L]
        center = jnp.take_along_axis(rows, t[:, None], axis=1)[:, 0]
        context = jnp.take_along_axis(rows, ctx_t, axis=1)  # [Bc, nc]
        valid &= center[:, None] != context  # stalled-walker self pairs
        if cfg.subsample > 0:
            # subsampling: center once per occurrence, contexts per pair
            uc = jax.random.uniform(ks[5], (Bc,))
            ux = jax.random.uniform(ks[6], (Bc, nc))
            valid &= (uc < keep[center])[:, None] & (ux < keep[context])
        return center, context, valid

    def draw_noise(k, shape):
        un = jax.random.uniform(k, (2,) + shape)
        kk = jnp.minimum((un[0] * num_nodes).astype(jnp.int32), num_nodes - 1)
        return jnp.where(un[1] < noise_q[kk], kk, noise_J[kk]).astype(
            jnp.int32)

    def step_pooled(carry, inp):
        w_in, w_out = carry
        k, lr = inp
        ks = jax.random.split(k, 8)
        center, context, valid = sample_pairs(ks)
        pool = draw_noise(ks[7], (cfg.neg_pool,))  # [P] shared noise rows

        vc = w_in[center]  # [Bc, D]
        uo = w_out[context.reshape(-1)].reshape(Bc, nc, -1)
        U = w_out[pool]  # [P, D]

        validf = valid.astype(vc.dtype)
        pos_score = jnp.einsum("bd,bnd->bn", vc, uo)
        neg_score = vc @ U.T  # [Bc, P]
        g_pos = (jax.nn.sigmoid(pos_score) - 1.0) * validf  # [Bc, nc]
        # per pair the negative term depends only on the center, so a
        # center with v valid pairs takes v pooled-negative gradients,
        # each worth `negatives/neg_pool` of the pool sum
        nvalid = validf.sum(axis=1) * (K / cfg.neg_pool)  # [Bc]
        g_neg = jax.nn.sigmoid(neg_score) * nvalid[:, None]  # [Bc, P]

        grad_vc = jnp.einsum("bn,bnd->bd", g_pos, uo) + g_neg @ U
        grad_uo = g_pos[:, :, None] * vc[:, None, :]  # [Bc, nc, D]
        grad_pool = g_neg.T @ vc  # [P, D]

        w_in = w_in.at[center].add(-lr * grad_vc)
        w_out = w_out.at[context.reshape(-1)].add(
            -lr * grad_uo.reshape(Bc * nc, -1))
        w_out = w_out.at[pool].add(-lr * grad_pool)
        return (w_in, w_out), None

    def step_classic(carry, inp):
        """Per-pair negatives — exact gensim semantics, B*K noise rows."""
        w_in, w_out = carry
        k, lr = inp
        ks = jax.random.split(k, 8)
        center, context, valid = sample_pairs(ks)
        neg = draw_noise(ks[7], (Bc, nc, K))

        vc = w_in[center]  # [Bc, D]
        uo = w_out[context.reshape(-1)].reshape(Bc, nc, -1)
        un_ = w_out[neg.reshape(-1)].reshape(Bc, nc, K, -1)

        validf = valid.astype(vc.dtype)
        pos_score = jnp.einsum("bd,bnd->bn", vc, uo)
        neg_score = jnp.einsum("bd,bnkd->bnk", vc, un_)
        g_pos = (jax.nn.sigmoid(pos_score) - 1.0) * validf
        g_neg = jax.nn.sigmoid(neg_score) * validf[:, :, None]

        grad_vc = jnp.einsum("bn,bnd->bd", g_pos, uo) + jnp.einsum(
            "bnk,bnkd->bd", g_neg, un_)
        grad_uo = g_pos[:, :, None] * vc[:, None, :]
        grad_un = g_neg[:, :, :, None] * vc[:, None, None, :]

        w_in = w_in.at[center].add(-lr * grad_vc)
        w_out = w_out.at[context.reshape(-1)].add(
            -lr * grad_uo.reshape(Bc * nc, -1))
        w_out = w_out.at[neg.reshape(-1)].add(
            -lr * grad_un.reshape(Bc * nc * K, -1))
        return (w_in, w_out), None

    step = step_pooled if cfg.neg_pool > 0 else step_classic
    keys = jax.random.split(key, num_steps)
    (w_in, w_out), _ = jax.lax.scan(step, (w_in, w_out), (keys, lrs))
    return w_in, w_out


def train_sgns_device(
    key,
    walks,
    num_nodes: int,
    cfg: SGNSConfig = SGNSConfig(),
    prep: SGNSPrep | None = None,
) -> jnp.ndarray:
    """`train_sgns` but returns the DEVICE array: downstream consumers
    that gather pair features on device (the pipelines) skip the [N, dim]
    device->host pull."""
    walks_np = np.asarray(walks)
    if prep is None:
        prep = prepare_sgns(walks_np, num_nodes, cfg)
    noise_J, noise_q, keep = prep.noise_J, prep.noise_q, prep.keep

    # Batch-synchronous SGD sums colliding row updates; on tiny
    # vocabularies a large batch piles O(batch/num_nodes) sequential-SGD
    # steps into one linearized jump and diverges. Cap the batch at ~16
    # pair-candidates per node (the fb-pages-food collision rate that is
    # empirically stable at gensim's lr).
    batch_size = max(64, min(cfg.batch_size, 16 * num_nodes))
    if batch_size != cfg.batch_size:
        cfg = dataclasses.replace(cfg, batch_size=batch_size)

    # Pair-candidate budget per epoch. gensim trains ~2*E[reduced window]
    # ≈ `window` pairs per token; our sampler proposes candidates of which
    # only ~40-55% are valid (offset cap + range + self-pair masks), so
    # budget `2 * window` candidates per token to land near gensim's
    # effective update count. Effective per-step pair count is the
    # center-major grid Bc*nc, which floors batch_size.
    pairs_per_epoch = walks_np.size * cfg.window * 2
    nc = max(1, min(cfg.ctx_per_center, cfg.batch_size))
    pairs_per_step = max(1, cfg.batch_size // nc) * nc
    num_steps = max(int(cfg.epochs * pairs_per_epoch / pairs_per_step), 1)

    k_init, k_train = jax.random.split(jax.random.PRNGKey(0) if key is None else key)
    w_in = (
        jax.random.uniform(k_init, (num_nodes, cfg.dim), minval=-0.5, maxval=0.5)
        / cfg.dim
    ).astype(jnp.float32)
    w_out = jnp.zeros((num_nodes, cfg.dim), dtype=jnp.float32)

    w_in, _ = _train(
        k_train,
        w_in,
        w_out,
        jnp.asarray(walks_np),
        jnp.asarray(noise_J),
        jnp.asarray(noise_q),
        jnp.asarray(keep),
        cfg,
        num_steps,
    )
    return w_in


def train_sgns(
    key,
    walks,
    num_nodes: int,
    cfg: SGNSConfig = SGNSConfig(),
    prep: SGNSPrep | None = None,
) -> np.ndarray:
    """Train SGNS embeddings from a walk matrix; returns [num_nodes, dim].

    Nodes never visited by a walk keep their (tiny random) init — the SEAL
    pipeline overwrites those rows with the average embedding, matching
    reference `SEAL/config/data.py:68-76`.

    Pass a `prepare_sgns` result as `prep` to skip the host-side noise
    -table build (it depends only on the corpus).
    """
    return np.asarray(train_sgns_device(key, walks, num_nodes, cfg, prep))

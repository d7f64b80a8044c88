"""Model family C: TwoWL — 2-WL edge-level GNN with hyperparameter search.

A rebuild of the reference pipeline (`TwoWL/TwoWL_work.py:18-149`,
`TwoWL/model/train.py`):

1. load the edge CSV, 85/5/10 split with doubled directed edges and ei2
   edge-pair graphs (`linkpred.data.twowl`),
2. per epoch: one minibatch of val-sized positive+negative pair samples,
   with the batch positives *masked out* of the message graph
   (leakage prevention, reference `sample_block` -> static masks here),
3. early-stopped training (`train.py:86-107`), best-val checkpointing of
   the test score, `AUC:x Time:y` record + `fpr.json`/`tpr.json` dumps
   (`train.py:110-134`),
4. a 10-trial random hyperparameter search over the reference's Optuna
   space (`TwoWL_work.py:67-79`), rebuilding the dataset with 10%%
   probability per trial (`TwoWL_work.py:59-66`), best params ->
   `logs.json` (`TwoWL_work.py:138-144`).

The search driver here is seeded random search rather than TPE: with 10
trials over this space the two are statistically indistinguishable, and it
keeps the framework dependency-free (optuna is not available on the image).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from linkpred.data import io
from linkpred.data.twowl import TwoWLData, TwoWLSplit, build_twowl_data
from linkpred.models import twowl as m
from linkpred.utils import checkpoint, metrics, plots, records
from linkpred.utils.timer import StepTimer


@dataclasses.dataclass(frozen=True)
class TwoWLRunConfig:
    epochs: int = 1000
    early_stop: int = 800
    chunk_epochs: int = 250  # scan chunk size (progress + early-stop check)
    seed: int = 0
    dataset: str = "fb-pages-food"
    records_dir: str = records.DEFAULT_RECORDS_DIR
    val_ratio: float = 0.05
    test_ratio: float = 0.1


def _split_arrays(s: TwoWLSplit) -> m.SplitArrays:
    return m.SplitArrays.from_split(s)


def evaluate(params, cfg: m.TwoWLConfig, data: TwoWLData, s: TwoWLSplit):
    feat = (jnp.asarray(data.node_deg) if cfg.degree_feature
            else jnp.arange(data.num_nodes, dtype=jnp.int32))
    scores = np.asarray(
        m.eval_scores(
            params,
            feat,
            _split_arrays(s),
            cfg=cfg,
            num_nodes=data.num_nodes,
        )
    )
    return metrics.roc_auc_score(s.y, scores), scores


def train_routine(
    data: TwoWLData,
    cfg: m.TwoWLConfig,
    run: TwoWLRunConfig,
    key=None,
    verbose: bool = False,
) -> dict:
    """Early-stopped training; mirrors reference `train_routine`
    (`train.py:71-135`). Returns best-val/test AUC and the test ROC."""
    key = key if key is not None else jax.random.PRNGKey(run.seed)
    key, k_init = jax.random.split(key)
    params = m.init_params(k_init, cfg)
    optimizer = optax.adam(cfg.learning_rate)
    opt_state = optimizer.init(params)

    trn = _split_arrays(data.train)
    n_pos_pairs = data.train.num_msg // 2
    n_neg_pairs = len(data.train.pred) // 2
    # batch sizing follows the reference: one val-split-sized minibatch per
    # epoch, half positives half negatives (`train.py:14-23,79`)
    P = min(len(data.val.y), n_pos_pairs, n_neg_pairs)

    rng = np.random.default_rng(run.seed)
    best_val, tst_score, since_best = 0.0, 0.0, 0
    best_roc = (None, None)
    t_eval = 0.0
    # warm the test-eval program shape ONCE so recorded Times are warm
    # evals comparable to the reference's 0.07-0.14 s (`train.py:99-101`);
    # round-2 records were ~10x off because the first new-best epoch's
    # timed eval included the jit compile.
    evaluate(params, cfg, data, data.test)
    from linkpred.utils.progress import LiveProgress

    progress = LiveProgress(run.epochs, label="twowl") if verbose else None
    for epoch in range(run.epochs):
        pos_ids = jnp.asarray(
            rng.permutation(n_pos_pairs)[:P].astype(np.int32)
        )
        neg_ids = jnp.asarray(
            rng.permutation(n_neg_pairs)[:P].astype(np.int32)
        )
        key, k_step = jax.random.split(key)
        params, opt_state, loss, logits, y = m.train_step(
            params, opt_state, k_step, pos_ids, neg_ids,
            trn, cfg, optimizer, data.num_nodes,
        )
        val_auc, _ = evaluate(params, cfg, data, data.val)
        if progress is not None:
            # live progress + loss/val charts — the reference's
            # in-training Streamlit surface (`TwoWL_work.py:119-129`)
            progress.update(epoch + 1, loss=float(loss), auc=val_auc)
        since_best += 1
        if val_auc > best_val:
            best_val, since_best = val_auc, 0
            t0 = time.perf_counter()
            tst_score, tst_scores = evaluate(params, cfg, data, data.test)
            t_eval = time.perf_counter() - t0
            fpr, tpr, _ = metrics.roc_curve(data.test.y, tst_scores)
            best_roc = (fpr, tpr)
            if verbose:
                print(
                    f"epoch {epoch:04d} loss {float(loss):.4f} "
                    f"val {val_auc:.4f} tst {tst_score:.4f}"
                )
        if since_best > run.early_stop:
            break
    return {
        "best_val": best_val,
        "test_auc": tst_score,
        "test_eval_seconds": t_eval,
        "fpr": best_roc[0],
        "tpr": best_roc[1],
        "params": params,
    }


def train_routine_fused(
    data: TwoWLData,
    cfg: m.TwoWLConfig,
    run: TwoWLRunConfig,
    key=None,
    verbose: bool = False,
) -> dict:
    """Fused variant of `train_routine`: the whole epoch loop runs as one
    on-device `lax.scan` (`models.twowl.train_scan`) with on-device val AUC
    and best-val parameter tracking — zero host round-trips per epoch.

    Early stop is EPOCH-EXACT: the scan carries an epochs-since-best
    counter and freezes every epoch after it exceeds `run.early_stop`
    into a no-op `lax.cond` branch (`models.twowl.train_scan`), matching
    the reference contract (`train.py:86-107`) epoch-for-epoch; the
    chunk loop exits at the first boundary
    where the counter reports stopped. The test split is scored once at
    the end with the best parameters (eval shape warmed before timing so
    the recorded Time is a warm eval)."""
    key = key if key is not None else jax.random.PRNGKey(run.seed)
    key, k_init = jax.random.split(key)
    params = m.init_params(k_init, cfg)
    optimizer = optax.adam(cfg.learning_rate)
    opt_state = optimizer.init(params)

    trn = _split_arrays(data.train)
    val = _split_arrays(data.val)
    n_pos_pairs = data.train.num_msg // 2
    n_neg_pairs = len(data.train.pred) // 2
    P = min(len(data.val.y), n_pos_pairs, n_neg_pairs)

    rng = np.random.default_rng(run.seed)
    E = run.epochs
    pos_ids = np.stack(
        [rng.permutation(n_pos_pairs)[:P] for _ in range(E)]
    ).astype(np.int32)
    neg_ids = np.stack(
        [rng.permutation(n_neg_pairs)[:P] for _ in range(E)]
    ).astype(np.int32)

    # chunk the fused scan for progress output and the early-stop check;
    # identical-shape chunks compile once and thread the (params, opt,
    # best) carry through
    chunk = min(E, run.chunk_epochs)
    # explicit initial best: passing None for the first chunk and a tuple
    # after changes the arg pytree structure and forces a second compile
    best = (params, jnp.float32(0.0), jnp.int32(0))
    hists = []
    val_y = jnp.asarray(data.val.y)
    node_deg = jnp.asarray(data.node_deg)
    from linkpred.utils.progress import LiveProgress

    progress = LiveProgress(E, label="twowl-fused") if verbose else None
    for start in range(0, E, chunk):
        stop = min(start + chunk, E)
        key, k_scan = jax.random.split(key)
        params, opt_state, best_p, best_a, since, h = m.train_scan(
            params, opt_state, k_scan,
            jnp.asarray(pos_ids[start:stop]), jnp.asarray(neg_ids[start:stop]),
            trn, val, val_y, node_deg,
            cfg, optimizer, data.num_nodes, stop - start,
            init_best=best, early_stop=run.early_stop,
        )
        best = (best_p, best_a, since)
        hists.append(h)
        if verbose:
            loss_np, auc_np = np.asarray(h[0]), np.asarray(h[1])
            for k in range(len(loss_np)):
                progress.update(start + k + 1, loss=float(loss_np[k]),
                                auc=float(auc_np[k]))
            loss_c = float(loss_np.mean())
            val_c = float(auc_np[-1])
            print(f"  epochs {start:4d}-{stop:<4d} loss {loss_c:.4f} "
                  f"val {val_c:.4f} best {float(best_a):.4f}", flush=True)
        if int(since) > run.early_stop:
            if verbose:
                stopped_at = stop - (int(since) - run.early_stop - 1)
                print(f"  early stop at epoch {stopped_at} "
                      f"(no val improvement in > {run.early_stop} epochs)",
                      flush=True)
            break
    best = best[:2]
    best_params, best_auc = best
    hist = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0), *hists
    )
    best_val = float(best_auc)

    evaluate(best_params, cfg, data, data.test)  # warm the eval shape
    t0 = time.perf_counter()
    tst_score, tst_scores = evaluate(best_params, cfg, data, data.test)
    t_eval = time.perf_counter() - t0
    fpr, tpr, _ = metrics.roc_curve(data.test.y, tst_scores)
    if verbose:
        print(f"fused: best val {best_val:.4f} test {tst_score:.4f}")
    return {
        "best_val": best_val,
        "test_auc": tst_score,
        "test_eval_seconds": t_eval,
        "fpr": fpr,
        "tpr": tpr,
        "params": best_params,
        "history": np.asarray(hist[1]),
    }


def refine_vmapped(
    data: TwoWLData,
    cfg: m.TwoWLConfig,
    run: TwoWLRunConfig,
    n_trials: int = 32,
    key=None,
    rng: np.random.Generator | None = None,
    verbose: bool = False,
) -> dict:
    """Trial-major refinement sweep: with the architecture fixed (cfg's
    channels/depths/acts), train `n_trials` (learning-rate x dropout)
    configurations SIMULTANEOUSLY in ONE compiled program. The trial axis
    lives in trailing dims (`models.twowl` trial-major section), not an
    outer vmap. This is the batched version of Optuna's sequential
    trials: the device trains 32 models in one program.

    Returns per-trial val AUCs, the best trial's test AUC and params.
    """
    key = key if key is not None else jax.random.PRNGKey(run.seed)
    rng = rng or np.random.default_rng(run.seed + 17)

    lrs = np.asarray(
        rng.choice(SEARCH_SPACE["lr"], size=n_trials)
    ).astype(np.float32)
    rates_np = {
        f: np.asarray(rng.choice(SEARCH_SPACE[f], n_trials), np.float32)
        for f in m.TrialRates._fields
    }
    best_params, best_aucs = _train_trial_batch(
        data, cfg, run, key, rng, lrs, rates_np, verbose)
    return _finish_refine(
        data, cfg, best_params, best_aucs, lrs,
        m.TrialRates(**{f: jnp.asarray(v) for f, v in rates_np.items()}),
        verbose,
    )


def _train_trial_batch(data, cfg, run, key, rng, lrs, rates_np,
                       verbose=False):
    """Train one trial-major batch (lrs [T] + rates dict of [T]) for the
    full chunked schedule; returns (best_params trial-major, best_aucs).

    Unit-lr Adam with per-trial lr applied as an update scale (Adam's
    direction is gradient-scale invariant, so this IS per-trial Adam —
    see models.twowl.train_step_trials). Chunked for progress output;
    the explicit initial best avoids a None-vs-tuple recompile on chunk
    2."""
    n_trials = len(lrs)
    rates = m.TrialRates(**{
        f: jnp.asarray(v, jnp.float32) for f, v in rates_np.items()})
    optimizer = optax.adam(1.0)
    key, k_init = jax.random.split(key)
    params = m.init_params_trials(k_init, cfg, n_trials)
    opt_state = optimizer.init(params)

    trn = _split_arrays(data.train)
    val = _split_arrays(data.val)
    n_pos_pairs = data.train.num_msg // 2
    n_neg_pairs = len(data.train.pred) // 2
    P = min(len(data.val.y), n_pos_pairs, n_neg_pairs)
    E = run.epochs
    pos_ids = jnp.asarray(np.stack(
        [rng.permutation(n_pos_pairs)[:P] for _ in range(E)]
    ).astype(np.int32))
    neg_ids = jnp.asarray(np.stack(
        [rng.permutation(n_neg_pairs)[:P] for _ in range(E)]
    ).astype(np.int32))

    chunk = min(E, run.chunk_epochs)
    best = (params, jnp.full((n_trials,), -1.0, jnp.float32))
    val_y = jnp.asarray(data.val.y)
    node_deg = jnp.asarray(data.node_deg)
    lrs_j = jnp.asarray(lrs)
    for start in range(0, E, chunk):
        stop = min(start + chunk, E)
        key, k_scan = jax.random.split(key)
        params, opt_state, best_p, best_a, _ = m.train_scan_trials(
            params, opt_state, k_scan,
            pos_ids[start:stop], neg_ids[start:stop], trn, val,
            val_y, node_deg, cfg, optimizer, lrs_j, data.num_nodes,
            stop - start, rates, init_best=best,
        )
        best = (best_p, best_a)
        if verbose:
            a = np.asarray(best_a)
            print(f"  refine epochs {start:4d}-{stop:<4d} "
                  f"best val {a.max():.4f} (median {np.median(a):.4f} "
                  f"over {n_trials} trials)", flush=True)
    return best


def refine_halving(
    data: TwoWLData,
    cfg: m.TwoWLConfig,
    run: TwoWLRunConfig,
    n_trials: int = 64,
    eta: int = 2,
    min_trials: int = 8,
    key=None,
    rng: np.random.Generator | None = None,
    verbose: bool = False,
) -> dict:
    """Successive-halving refinement — the adaptive-search round that
    supersedes the reference's Optuna TPE capability (`TwoWL_work.py:112-132`)
    rather than approximating it: instead of modeling the response surface
    sequentially, spend the SAME epoch budget evaluating `eta`x more
    configurations and promote survivors.

    Mechanics: start `n_trials` (lr x dropout) configs in ONE trial-major
    program; each rung trains `run.chunk_epochs` epochs, then the top
    1/eta by best-val AUC survive WARM — parameters, running best, and the
    Adam moments are sliced along the trial axis (`models.twowl.take_trials`)
    so no learning is thrown away. Once `min_trials` remain they train out
    the rest of `run.epochs`. Total trial-epochs with the default schedule
    (64->8 at eta=2, 250-epoch rungs, 1000 total) equal a 30-trial flat
    random search while having inspected 64 configurations.
    Measured AUC-vs-budget comparison: `benchmarks/halving.py`.
    """
    key = key if key is not None else jax.random.PRNGKey(run.seed)
    rng = rng or np.random.default_rng(run.seed + 17)

    lrs = np.asarray(
        rng.choice(SEARCH_SPACE["lr"], size=n_trials)
    ).astype(np.float32)
    rates_np = {
        f: np.asarray(rng.choice(SEARCH_SPACE[f], n_trials), np.float32)
        for f in m.TrialRates._fields
    }

    optimizer = optax.adam(1.0)  # per-trial lr applied as update scale
    key, k_init = jax.random.split(key)
    params = m.init_params_trials(k_init, cfg, n_trials)
    opt_state = optimizer.init(params)

    trn = _split_arrays(data.train)
    val = _split_arrays(data.val)
    n_pos_pairs = data.train.num_msg // 2
    n_neg_pairs = len(data.train.pred) // 2
    P = min(len(data.val.y), n_pos_pairs, n_neg_pairs)
    E = run.epochs
    pos_ids = jnp.asarray(np.stack(
        [rng.permutation(n_pos_pairs)[:P] for _ in range(E)]
    ).astype(np.int32))
    neg_ids = jnp.asarray(np.stack(
        [rng.permutation(n_neg_pairs)[:P] for _ in range(E)]
    ).astype(np.int32))

    val_y = jnp.asarray(data.val.y)
    node_deg = jnp.asarray(data.node_deg)
    chunk = min(E, run.chunk_epochs)
    best = (params, jnp.full((n_trials,), -1.0, jnp.float32))
    alive = np.arange(n_trials)
    start = 0
    while start < E:
        stop = min(start + chunk, E)
        key, k_scan = jax.random.split(key)
        params, opt_state, best_p, best_a, _ = m.train_scan_trials(
            params, opt_state, k_scan,
            pos_ids[start:stop], neg_ids[start:stop], trn, val,
            val_y, node_deg, cfg, optimizer,
            jnp.asarray(lrs[alive]), data.num_nodes,
            stop - start,
            m.TrialRates(**{
                f: jnp.asarray(rates_np[f][alive]) for f in m.TrialRates._fields
            }),
            init_best=best,
        )
        best = (best_p, best_a)
        aucs = np.asarray(best_a)
        if verbose:
            print(f"  rung epochs {start:4d}-{stop:<4d} {len(alive)} trials "
                  f"best val {aucs.max():.4f} median {np.median(aucs):.4f}",
                  flush=True)
        start = stop
        survivors = max(min_trials, len(alive) // eta)
        if start < E and survivors < len(alive):
            keep = np.argsort(-aucs)[:survivors].astype(np.int32)
            keep.sort()  # stable trial identity for reproducibility
            alive = alive[keep]
            kj = jnp.asarray(keep)
            params = m.take_trials(params, kj)
            # Adam moments are params-shaped pytrees; slice them the same
            # way so survivors keep their optimizer state (count is shared)
            s0, *rest = opt_state
            opt_state = (s0._replace(mu=m.take_trials(s0.mu, kj),
                                     nu=m.take_trials(s0.nu, kj)),
                         *rest)
            best = (m.take_trials(best[0], kj), best[1][kj])

    best_params, best_aucs = best
    res = _finish_refine(
        data, cfg, best_params, best_aucs, lrs[alive],
        m.TrialRates(**{
            f: jnp.asarray(rates_np[f][alive]) for f in m.TrialRates._fields
        }),
        verbose,
    )
    res["configs_inspected"] = int(n_trials)
    res["survivors"] = alive.tolist()
    return res


def refine_adaptive(
    data: TwoWLData,
    cfg: m.TwoWLConfig,
    run: TwoWLRunConfig,
    n_trials: int = 32,
    n_batches: int = 4,
    gamma: float = 0.25,
    explore: float = 0.2,
    key=None,
    rng: np.random.Generator | None = None,
    verbose: bool = False,
) -> dict:
    """Model-based (TPE-class) refinement — closes the last HPO delta vs
    the reference's Optuna TPE sampler (`TwoWL_work.py:112-132`): later
    trials are sampled from a density model of the GOOD observed configs
    instead of uniformly.

    Mechanics: `n_batches` trial-major rounds of `n_trials / n_batches`
    configurations, each trained on the full schedule in one compiled
    program. Round 1 samples uniformly; every later round samples each
    dimension, with probability `1 - explore`, from a grid-KDE over the
    top-`gamma` quantile of all observed configs (pick a good config's
    grid value, then move one grid step with prob 0.3 — the discrete
    analog of TPE's l(x) kernel), else uniformly (the g(x) exploration
    floor). A/B against flat and halving: `benchmarks/halving.py`.
    """
    key = key if key is not None else jax.random.PRNGKey(run.seed)
    rng = rng or np.random.default_rng(run.seed + 17)
    dims = ("lr",) + m.TrialRates._fields
    grids = {d: np.asarray(SEARCH_SPACE[d], np.float32) for d in dims}
    seen_idx: list[np.ndarray] = []  # per-trial grid indices [len(dims)]
    seen_auc: list[float] = []
    batches = []

    def sample_round(nb):
        if not seen_auc:
            return np.stack([
                rng.integers(0, len(grids[d]), nb) for d in dims], axis=1)
        order = np.argsort(-np.asarray(seen_auc))
        good = np.stack([seen_idx[i] for i in
                         order[:max(1, int(len(order) * gamma))]])
        out = np.zeros((nb, len(dims)), np.int64)
        for t in range(nb):
            for j, d in enumerate(dims):
                if rng.random() < explore:
                    out[t, j] = rng.integers(0, len(grids[d]))
                else:
                    v = good[rng.integers(len(good)), j]
                    if rng.random() < 0.3:
                        v = np.clip(v + rng.choice([-1, 1]), 0,
                                    len(grids[d]) - 1)
                    out[t, j] = v
        return out

    nb = max(1, n_trials // n_batches)
    for b in range(n_batches):
        idx = sample_round(nb)
        lrs = grids["lr"][idx[:, 0]]
        rates_np = {d: grids[d][idx[:, j + 1]]
                    for j, d in enumerate(m.TrialRates._fields)}
        key, k_b = jax.random.split(key)
        best_p, best_a = _train_trial_batch(
            data, cfg, run, k_b, rng, lrs, rates_np, verbose)
        aucs = np.asarray(best_a)
        for t in range(nb):
            seen_idx.append(idx[t])
            seen_auc.append(float(aucs[t]))
        batches.append((float(aucs.max()), best_p, best_a, lrs, rates_np))
        if verbose:
            print(f"  adaptive round {b + 1}/{n_batches}: best val "
                  f"{aucs.max():.4f} median {np.median(aucs):.4f}",
                  flush=True)

    _, best_p, best_a, lrs, rates_np = max(batches, key=lambda r: r[0])
    res = _finish_refine(
        data, cfg, best_p, best_a, lrs,
        m.TrialRates(**{f: jnp.asarray(v) for f, v in rates_np.items()}),
        verbose,
    )
    res["configs_inspected"] = len(seen_auc)
    res["round_best_vals"] = [round(b[0], 4) for b in batches]
    return res


def _finish_refine(data, cfg, best_params, best_aucs, lrs, rates, verbose):
    best_aucs = np.asarray(best_aucs)
    winner = int(best_aucs.argmax())
    winner_params = m.extract_trial(best_params, winner)
    tst_auc, tst_scores = evaluate(winner_params, cfg, data, data.test)
    fpr, tpr, _ = metrics.roc_curve(data.test.y, tst_scores)
    if verbose:
        print(
            f"refine: {len(best_aucs)} trials, best val {best_aucs[winner]:.4f} "
            f"(lr {lrs[winner]}, dropouts "
            f"{[float(r[winner]) for r in rates]}) test {tst_auc:.4f}"
        )
    return {
        "best_val": float(best_aucs[winner]),
        "test_auc": tst_auc,
        "val_aucs": best_aucs,
        "winner": {
            "lr": float(lrs[winner]),
            **{f: float(getattr(rates, f)[winner]) for f in rates._fields},
        },
        "params": winner_params,
        "fpr": fpr,
        "tpr": tpr,
    }


# ---------------------------------------------------------------------------
# hyperparameter search (reference space, `TwoWL_work.py:67-79`)
# ---------------------------------------------------------------------------

SEARCH_SPACE = {
    "lr": [0.0005, 0.001, 0.005, 0.01, 0.05],
    "depth1": [1, 2, 3],
    "depth2": [1, 2, 3],
    "channels_1wl": [24, 32, 64],
    "channels_2wl": [16, 24],
    "dp_emb": np.round(np.arange(0.0, 0.51, 0.1), 1).tolist(),
    "dp_1wl0": np.round(np.arange(0.0, 0.51, 0.1), 1).tolist(),
    "dp_1wl1": np.round(np.arange(0.0, 0.51, 0.1), 1).tolist(),
    "dp_2wl": np.round(np.arange(0.0, 0.51, 0.1), 1).tolist(),
    "act0": [True, False],
    "act1": [True, False],
}


def sample_trial(rng: np.random.Generator) -> dict:
    return {k: v[rng.integers(len(v))] for k, v in SEARCH_SPACE.items()}


def _load_sweep_state(state_file: str) -> dict:
    import os

    done = {}
    if state_file and os.path.exists(state_file):
        with open(state_file) as f:
            for line in f:
                if line.strip():
                    rec = json.loads(line)
                    done[rec["trial"]] = rec
    return done


def run_twowl(
    run: TwoWLRunConfig = TwoWLRunConfig(),
    n_trials: int = 10,
    data_dir: Optional[str] = None,
    verbose: bool = True,
    log_file: str = "logs.json",
    fused: bool = True,
    state_file: str = "logs/twowl_sweep_state.jsonl",
    refine_trials: int = 0,
    refine_mode: str = "flat",
) -> dict:
    """10-trial sweep with crash-resume: per-trial results append to
    `state_file`; on restart, completed trials replay from it (the RNG
    stream is re-drawn identically so pending trials are unaffected).
    Delete the state file for a fresh sweep.

    `refine_trials > 0` adds a trial-major refinement round after the
    search: the winner's ARCHITECTURE is fixed and `refine_trials`
    (lr x dropout) configurations train simultaneously in one compiled
    program (`refine_vmapped`); if the refined winner's val AUC improves,
    its result replaces the sweep winner (record appended, logs.json
    updated with the refined lr/dropouts)."""
    import os

    timer = StepTimer()
    rng = np.random.default_rng(run.seed)
    done = _load_sweep_state(state_file)
    if not done:
        # fresh sweep: reset the record/ROC artifacts like the reference's
        # Model page does before training (`pages/🛠️Model.py:33-37`), so
        # the record file holds exactly one line per trial of THIS sweep.
        # A resumed sweep (non-empty journal) keeps its partial records.
        rec_path = records.record_path(run.dataset, "twowl", run.records_dir)
        if os.path.exists(rec_path):
            os.remove(rec_path)

    with timer.span("dataset"):
        _, edges = io.load_fb_pages_food(data_dir)
        num_nodes = int(edges.max()) + 1
        data = build_twowl_data(
            edges, num_nodes, rng=rng,
            val_ratio=run.val_ratio, test_ratio=run.test_ratio,
        )

    results = []
    best = {"value": -1.0, "params": None, "result": None}
    for trial in range(n_trials):
        t0 = time.perf_counter()
        if trial > 0 and rng.random() < 0.1:  # reference TwoWL_work.py:59-66
            with timer.span(f"dataset rebuild (trial {trial})"):
                data = build_twowl_data(
                    edges, num_nodes, rng=rng,
                    val_ratio=run.val_ratio, test_ratio=run.test_ratio,
                )
        hp = sample_trial(rng)
        cfg = m.TwoWLConfig(
            max_degree=data.max_degree,
            channels_1wl=hp["channels_1wl"],
            channels_2wl=hp["channels_2wl"],
            depth1=hp["depth1"],
            depth2=hp["depth2"],
            dp_emb=hp["dp_emb"],
            dp_1wl0=hp["dp_1wl0"],
            dp_1wl1=hp["dp_1wl1"],
            dp_2wl=hp["dp_2wl"],
            act0=hp["act0"],
            act1=hp["act1"],
            learning_rate=hp["lr"],
        )
        routine = train_routine_fused if fused else train_routine
        if trial in done:
            rec = done[trial]
            res = {
                "best_val": rec["val"], "test_auc": rec["test"],
                "test_eval_seconds": rec.get("eval_seconds", 0.0),
                "fpr": None, "tpr": None, "params": None,
            }
            trial_seconds = rec.get("seconds", 0.0)
        else:
            with timer.span(f"trial {trial}"):
                res = routine(
                    data, cfg, run,
                    key=jax.random.PRNGKey(run.seed + trial), verbose=verbose,
                )
            trial_seconds = time.perf_counter() - t0
            records.write_record(
                run.dataset, "twowl", res["test_auc"], res["test_eval_seconds"],
                run.records_dir, append=trial > 0,
            )
            if state_file:
                records.MetricsLogger(state_file).log(
                    trial=trial, val=float(res["best_val"]),
                    test=float(res["test_auc"]),
                    eval_seconds=res["test_eval_seconds"],
                    seconds=trial_seconds, **hp,
                )
        results.append({**hp, "val": res["best_val"], "test": res["test_auc"],
                        "seconds": trial_seconds})
        if verbose:
            print(
                f"trial {trial}: val {res['best_val']:.4f} "
                f"test {res['test_auc']:.4f} ({trial_seconds:.1f}s) {hp}"
            )
        if res["best_val"] > best["value"]:
            best = {"value": res["best_val"], "params": hp, "result": res,
                    "cfg": cfg, "trial": trial}

    if refine_trials > 0:
        refine_fn = {"halving": refine_halving,
                     "adaptive": refine_adaptive}.get(refine_mode,
                                                      refine_vmapped)
        with timer.span(f"refine[{refine_mode}] x{refine_trials}"):
            ref = refine_fn(
                data, best["cfg"], run, n_trials=refine_trials,
                key=jax.random.PRNGKey(run.seed + 10_000), verbose=verbose,
            )
        if ref["best_val"] > best["value"]:
            hp = {**best["params"], "lr": ref["winner"]["lr"],
                  **{k: v for k, v in ref["winner"].items() if k != "lr"}}
            best = {
                "value": ref["best_val"], "params": hp, "trial": -1,
                "cfg": best["cfg"],
                "result": {
                    "best_val": ref["best_val"], "test_auc": ref["test_auc"],
                    "test_eval_seconds": 0.0, "fpr": ref["fpr"],
                    "tpr": ref["tpr"], "params": ref["params"],
                },
            }
            records.write_record(
                run.dataset, "twowl", ref["test_auc"], 0.0,
                run.records_dir, append=True,
            )

    if best["result"] is not None and best["result"]["params"] is None:
        # the winner was a resumed (replayed) trial — retrain it once to
        # regenerate the checkpoint/ROC artifacts
        routine = train_routine_fused if fused else train_routine
        best["result"] = routine(
            data, best["cfg"], run,
            key=jax.random.PRNGKey(run.seed + best["trial"]), verbose=False,
        )

    with open(log_file, "w") as f:
        json.dump(best["params"], f)
    if best["result"]["fpr"] is not None:
        records.write_roc_json(best["result"]["fpr"], best["result"]["tpr"])
        plots.plot_roc(
            best["result"]["fpr"], best["result"]["tpr"],
            best["result"]["test_auc"], "TwoWL ROC", "assets/img/twowl_roc.png",
        )
    checkpoint.save_pytree("checkpoints/twowl/model", best["result"]["params"])
    records.MetricsLogger("logs/metrics.jsonl").log(
        family="twowl", auc=float(best["result"]["test_auc"]),
        best_val=float(best["value"]), n_trials=n_trials,
        total_seconds=timer.total, best_params=best["params"],
    )
    if verbose:
        print(timer.report())
        print(
            f"twowl: best val {best['value']:.4f} "
            f"test {best['result']['test_auc']:.4f} (reference best 0.8947)"
        )
    return {
        "best_params": best["params"],
        "best_val": best["value"],
        "test_auc": best["result"]["test_auc"],
        "trials": results,
        "total_seconds": timer.total,
    }

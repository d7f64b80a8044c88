"""Evaluation metrics (numpy + jit-able JAX variants).

The reference relies on sklearn's `roc_auc_score` / `roc_curve`
(`LogisticRegression_Linkprediction/model/build_model.py:25`,
`SEAL/operators/seal_link_predict.py:91`, `TwoWL/model/train.py:43,66-67`).
Here they are implemented directly so the framework is standalone, plus a
jit-able AUC for on-device eval loops.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np


def roc_auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Area under the ROC curve via the rank statistic (ties averaged).

    Equivalent to sklearn's trapezoidal AUC for binary labels.
    """
    y_true = np.asarray(y_true).reshape(-1).astype(np.float64)
    y_score = np.asarray(y_score).reshape(-1).astype(np.float64)
    n_pos = float(y_true.sum())
    n_neg = float(len(y_true) - n_pos)
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty(len(y_score), dtype=np.float64)
    ranks[order] = np.arange(1, len(y_score) + 1)
    # average ranks of ties
    sorted_scores = y_score[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            avg = (i + j) / 2.0 + 1.0
            ranks[order[i : j + 1]] = avg
        i = j + 1
    return float((ranks[y_true == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def roc_curve(
    y_true: np.ndarray, y_score: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) at each distinct score, descending thresholds."""
    y_true = np.asarray(y_true).reshape(-1).astype(np.float64)
    y_score = np.asarray(y_score).reshape(-1).astype(np.float64)
    order = np.argsort(-y_score, kind="mergesort")
    y_true, y_score = y_true[order], y_score[order]
    distinct = np.where(np.diff(y_score))[0]
    idx = np.concatenate([distinct, [len(y_true) - 1]])
    tps = np.cumsum(y_true)[idx]
    fps = 1 + idx - tps
    n_pos, n_neg = tps[-1], fps[-1]
    tpr = tps / max(n_pos, 1)
    fpr = fps / max(n_neg, 1)
    thresholds = y_score[idx]
    # prepend the (0, 0) origin like sklearn
    return (
        np.concatenate([[0.0], fpr]),
        np.concatenate([[0.0], tpr]),
        np.concatenate([[np.inf], thresholds]),
    )


def roc_auc_jax(y_true: jnp.ndarray, y_score: jnp.ndarray) -> jnp.ndarray:
    """Jit-able AUC (rank statistic; ties get the lower rank, which matches
    the exact AUC when scores are continuous, as model logits are)."""
    y_true = y_true.reshape(-1).astype(jnp.float32)
    y_score = y_score.reshape(-1)
    order = jnp.argsort(y_score)
    ranks = jnp.zeros_like(y_score).at[order].set(
        jnp.arange(1, y_score.shape[0] + 1, dtype=y_score.dtype)
    )
    n_pos = jnp.sum(y_true)
    n_neg = y_true.shape[0] - n_pos
    pos_rank_sum = jnp.sum(ranks * y_true)
    return (pos_rank_sum - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    return float((y_true == y_pred).mean())


def roc_auc_trials(y_true: "jnp.ndarray", scores: "jnp.ndarray") -> "jnp.ndarray":
    """Jit-able AUC per trial column: `y_true` [V], `scores` [V, T] -> [T].

    Scatter-free rank statistic (rank = double argsort along the sample
    axis) — the `.at[order].set` ranks of `roc_auc_jax` are a scatter,
    which batches poorly; sorts batch fine.
    """
    y = y_true.reshape(-1, 1).astype(jnp.float32)
    ranks = jnp.argsort(jnp.argsort(scores, axis=0), axis=0) + 1
    n_pos = jnp.sum(y)
    n_neg = y.shape[0] - n_pos
    pos_rank_sum = jnp.sum(ranks.astype(scores.dtype) * y, axis=0)
    return (pos_rank_sum - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)

"""L2-regularized logistic regression via jit-compiled Newton (IRLS).

Replaces sklearn's `LogisticRegression(class_weight="balanced")` used by the
reference (`LogisticRegression_Linkprediction/model/build_model.py:20-22`).
sklearn minimizes  C * sum_i w_i * logloss_i + 0.5 ||beta||^2  (C=1.0
default, intercept unpenalized); with `class_weight="balanced"` the sample
weights are n / (2 * n_class). Feature dims here are ~100, so a dense
Newton solve (D+1 x D+1) on the device converges in a handful of iterations —
far less work than an LBFGS loop.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("num_iters",))
def _newton_fit(x, y, sample_weight, c, num_iters: int):
    n, d = x.shape
    xb = jnp.concatenate([x, jnp.ones((n, 1), x.dtype)], axis=1)  # bias col
    beta = jnp.zeros((d + 1,), x.dtype)
    # penalty: 1/C on weights, 0 on intercept
    reg = jnp.concatenate([jnp.full((d,), 1.0 / c), jnp.zeros((1,))])

    def newton_step(beta, _):
        z = xb @ beta
        p = jax.nn.sigmoid(z)
        w = sample_weight * p * (1 - p) + 1e-10
        grad = xb.T @ (sample_weight * (p - y)) + reg * beta
        h = (xb * w[:, None]).T @ xb + jnp.diag(reg)
        delta = jax.scipy.linalg.solve(h, grad, assume_a="pos")
        return beta - delta, None

    beta, _ = jax.lax.scan(newton_step, beta, None, length=num_iters)
    return beta


def fit_logistic(
    x: np.ndarray,
    y: np.ndarray,
    class_weight: str | None = "balanced",
    c: float = 1.0,
    num_iters: int = 16,
) -> np.ndarray:
    """Fit and return coefficients [D+1] (last entry = intercept)."""
    x = jnp.asarray(x, dtype=jnp.float32)
    y = jnp.asarray(np.asarray(y).reshape(-1), dtype=jnp.float32)
    n = x.shape[0]
    if class_weight == "balanced":
        n_pos = float(np.asarray(y).sum())
        n_neg = n - n_pos
        w = np.where(np.asarray(y) == 1, n / (2 * n_pos), n / (2 * n_neg))
    else:
        w = np.ones(n)
    beta = _newton_fit(x, y, jnp.asarray(w, dtype=jnp.float32), c, num_iters)
    return np.asarray(beta)


def predict_proba(beta: np.ndarray, x: np.ndarray) -> np.ndarray:
    """P(link=1 | x): [N] probabilities."""
    x = jnp.asarray(x, dtype=jnp.float32)
    z = x @ jnp.asarray(beta[:-1]) + beta[-1]
    return np.asarray(jax.nn.sigmoid(z))

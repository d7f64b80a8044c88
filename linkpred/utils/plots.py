"""ROC / comparison plot artifacts (matplotlib, headless).

Replaces the reference's Streamlit-bound plotting (`assets/theme.py:41-92`
saves ROC PNGs into `assets/img/` then `st.pyplot`s them; the Compare view
draws a bar chart of the three families, `pages/🛠️Model.py:51-70`). Same
artifacts, no UI dependency. matplotlib is optional (the `plots` extra):
without it each plot prints one line and writes no PNG; records, AUCs and
checkpoints are unaffected.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def pyplot(out_path: str):
    """Headless `matplotlib.pyplot`, or None (after saying so) when
    matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib not installed; skipped {out_path}")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_roc(
    fpr: np.ndarray,
    tpr: np.ndarray,
    auc: float,
    title: str,
    out_path: str,
) -> str | None:
    plt = pyplot(out_path)
    if plt is None:
        return None
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(fpr, tpr, label=f"AUC = {auc:.4f}")
    ax.plot([0, 1], [0, 1], linestyle="--", linewidth=0.8)
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.set_title(title)
    ax.legend(loc="lower right")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_family_comparison(
    families: Sequence[str],
    aucs: Sequence[Optional[float]],
    out_path: str,
    title: str = "Best test ROC-AUC per model family",
    times: Sequence[Optional[float]] | None = None,
) -> str | None:
    """AUC bar chart, optionally annotated with wall times — the Compare
    view of `pages/🛠️Model.py:51-70` (which annotates bars with the
    recorded times)."""
    plt = pyplot(out_path)
    if plt is None:
        return None
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(5, 4))
    xs = np.arange(len(families))
    vals = [a if a is not None else 0.0 for a in aucs]
    ax.bar(xs, vals)
    for i, (x, v) in enumerate(zip(xs, vals)):
        label = f"{v:.4f}"
        if times is not None and times[i] is not None:
            label += f"\n{times[i]:.2f}s"
        ax.text(x, v + 0.005, label, ha="center", fontsize=9)
    ax.set_xticks(xs)
    ax.set_xticklabels(families)
    ax.set_ylim(0, 1.1)
    ax.set_ylabel("ROC-AUC")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path

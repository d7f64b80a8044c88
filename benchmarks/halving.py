"""AUC-vs-budget A/B of the three TwoWL refine modes.

All searchers spend (approximately) the SAME number of trial-epochs on
the same trial-major engine:
- flat: uniform random configs, full schedule each;
- halving: ~2x as many configurations, top half promoted warm (params +
  Adam moments) each 250-epoch rung — breadth early, depth where it pays;
- adaptive: TPE-class model-based sampling — 4 rounds, later rounds drawn
  from a grid-KDE over the top observed quantile (the capability match
  for the reference's Optuna TPE, `TwoWL_work.py:112-132`).

Budget math at the defaults (epochs=1000, chunk=250, eta=2):
  flat     16 trials x 1000 epochs                 = 16,000 trial-epochs
  halving  32 -> 16 -> 8 -> 8 over 250-epoch rungs = 16,000 trial-epochs
  adaptive 4 rounds x 4 trials x 1000 epochs       = 16,000 trial-epochs

Run: `python benchmarks/halving.py [--seeds K]`; prints one JSON line per
(mode, seed) and a summary line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main():
    import jax

    from linkpred.data import io, split as sp
    from linkpred.data.twowl import build_twowl_data
    from linkpred.models import twowl as m
    from linkpred.pipelines.twowl_pipeline import (
        TwoWLRunConfig,
        refine_adaptive,
        refine_halving,
        refine_vmapped,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--flat-trials", type=int, default=16)
    ap.add_argument("--halving-trials", type=int, default=32)
    ap.add_argument("--adaptive-trials", type=int, default=16,
                    help="same trial-epoch budget as flat, spent over 4 "
                         "model-guided rounds")
    args = ap.parse_args()

    _, edges = io.load_fb_pages_food()
    pairs = sp._dedup_upper(edges)

    results = {"flat": [], "halving": [], "adaptive": []}
    for seed in range(args.seeds):
        data = build_twowl_data(
            pairs, int(edges.max()) + 1, rng=np.random.default_rng(seed)
        )
        cfg = m.TwoWLConfig(
            max_degree=int(np.asarray(data.node_deg).max()) + 1
        )
        run = TwoWLRunConfig(epochs=args.epochs, seed=seed)
        for mode, fn, n in (
            ("flat", refine_vmapped, args.flat_trials),
            ("halving", refine_halving, args.halving_trials),
            ("adaptive", refine_adaptive, args.adaptive_trials),
        ):
            t0 = time.perf_counter()
            out = fn(data, cfg, run, n_trials=n,
                     key=jax.random.PRNGKey(seed + 100))
            dt = time.perf_counter() - t0
            rec = {
                "mode": mode, "seed": seed, "start_trials": n,
                "best_val": round(float(out["best_val"]), 4),
                "test_auc": round(float(out["test_auc"]), 4),
                "wall_seconds": round(dt, 1),
            }
            results[mode].append(rec)
            print(json.dumps(rec), flush=True)

    summary = {
        "metric": "refine_mode_ab",
        "budget_trial_epochs": args.flat_trials * args.epochs,
        "seeds": args.seeds,
    }
    for mode, recs in results.items():
        summary[f"{mode}_mean_test_auc"] = round(
            float(np.mean([r["test_auc"] for r in recs])), 4)
        summary[f"{mode}_mean_best_val"] = round(
            float(np.mean([r["best_val"] for r in recs])), 4)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()

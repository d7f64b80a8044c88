"""ei2 cap-sensitivity study.

Does the per-node ei2 product budget (`build_ei2_capped`, uniform random
truncation) destroy the 2-WL signal? Two experiments, same schedule:

1. **8k nodes** — exact ei2 is tractable: train with cap None (exact)
   and caps 64/128/256; the AUC delta vs exact IS the cap's cost.
2. **50k nodes** — the gate scale: caps 64/128/256; measures the
   throughput side of the trade (ei2 columns ∝ step time).

Writes one JSON line per run and a summary to logs/twowl_cap_study.json.
Run on the GPU: `python benchmarks/twowl_cap_study.py`.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    from linkpred.pipelines.twowl_scale import (
        ScaleTwoWLConfig,
        run_twowl_scale,
    )

    results = []

    def run(tag, **kw):
        out = run_twowl_scale(ScaleTwoWLConfig(**kw), verbose=False)
        row = {"tag": tag, "cap": kw.get("ei2_cap_per_node", 256),
               "nodes": kw["nodes"],
               "ei2_columns": out["ei2_columns"],
               "test_auc": out["test_auc"],
               "best_val_auc": out["best_val_auc"],
               "epochs_per_s": out["epochs_per_s"],
               "epochs": out["epochs"]}
        print(json.dumps(row), flush=True)
        results.append(row)
        return row

    # --- 8k: exact vs capped (the AUC-delta question) -------------------
    small = dict(nodes=8000, edges=40000, epochs=96, chunk_epochs=16,
                 warmup_epochs=8)
    exact = run("small_exact", ei2_cap_per_node=None, **small)
    for cap in (256, 128, 64):
        r = run(f"small_cap{cap}", ei2_cap_per_node=cap, **small)
        r["auc_delta_vs_exact"] = round(r["test_auc"] - exact["test_auc"],
                                        4)
        print(json.dumps({"cap": cap,
                          "auc_delta_vs_exact": r["auc_delta_vs_exact"]}),
              flush=True)

    # --- 50k: throughput side of the trade ------------------------------
    big = dict(nodes=50000, edges=250000, epochs=96, chunk_epochs=16,
               warmup_epochs=8)
    for cap in (256, 128, 64):
        run(f"big_cap{cap}", ei2_cap_per_node=cap, **big)

    os.makedirs("logs", exist_ok=True)
    with open("logs/twowl_cap_study.json", "w") as f:
        json.dump(results, f, indent=1)
    print("saved logs/twowl_cap_study.json")


if __name__ == "__main__":
    main()

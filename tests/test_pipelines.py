"""End-to-end pipeline smoke tests at tiny settings (golden-AUC style).

The reference's de-facto regression fixture is record replay (SURVEY.md §4);
here each family runs a miniature end-to-end pass on the real fb-pages-food
data and must clear a loose AUC floor — enough to catch wiring regressions
without slow full training in CI.
"""

import os

import numpy as np
import pytest

from linkpred.models.word2vec import SGNSConfig


@pytest.fixture(autouse=True)
def _workdir(tmp_path, monkeypatch):
    """Isolate record/artifact writes from the repo tree."""
    monkeypatch.chdir(tmp_path)


class TestPipelines:
    def test_seal_small(self):
        from linkpred.pipelines.seal_pipeline import SEALConfig, run_seal

        res = run_seal(
            SEALConfig(epochs=3, dimension=32, max_neighbors=50),
            verbose=False,
        )
        assert res["auc"] > 0.75
        assert os.path.exists("records_auc/fb-pages-food_auc_record_seal.txt")
        assert os.path.exists("checkpoints/seal/model-1000.npz")

    def test_twowl_small(self):
        import jax

        from linkpred.data import io
        from linkpred.data.twowl import build_twowl_data
        from linkpred.models import twowl as m
        from linkpred.pipelines.twowl_pipeline import (
            TwoWLRunConfig,
            train_routine_fused,
        )

        _, edges = io.load_fb_pages_food()
        d = build_twowl_data(edges, int(edges.max()) + 1,
                             rng=np.random.default_rng(0))
        cfg = m.TwoWLConfig(max_degree=d.max_degree, channels_1wl=24,
                            channels_2wl=16, depth1=2, depth2=2,
                            learning_rate=0.01)
        res = train_routine_fused(
            d, cfg, TwoWLRunConfig(epochs=120),
            key=jax.random.PRNGKey(0),
        )
        assert res["best_val"] > 0.6
        assert 0.0 <= res["test_auc"] <= 1.0

    def test_logistic_small(self):
        from linkpred.pipelines.logistic_pipeline import (
            LogisticConfig,
            run_logistic,
        )

        res = run_logistic(
            LogisticConfig(
                num_walks=10,
                embed=SGNSConfig(dim=32, window=5, negatives=5, epochs=1),
            ),
            verbose=False,
        )
        assert res["auc"] > 0.6
        assert os.path.exists(
            "records_auc/fb-pages-food_auc_record_logistic.txt"
        )

    def test_seal_two_hop_stress(self):
        """BASELINE.json stress config: 2-hop enclosing subgraphs with
        node2vec features fused — exercises the sampler's frontier
        expansion + max_neighbors truncation + padding at hop 2."""
        from linkpred.pipelines.seal_pipeline import SEALConfig, run_seal

        res = run_seal(
            SEALConfig(epochs=3, dimension=32, max_neighbors=40, hop=2),
            verbose=False,
        )
        assert res["hop"] == 2
        assert res["auc"] > 0.75

    def test_twowl_sweep_with_refine(self, tmp_path):
        import numpy as np

        from linkpred.pipelines.twowl_pipeline import (
            TwoWLRunConfig,
            run_twowl,
        )

        res = run_twowl(
            TwoWLRunConfig(epochs=12, chunk_epochs=12),
            n_trials=2, verbose=False, refine_trials=3,
            state_file="",
        )
        assert 0.0 <= res["test_auc"] <= 1.0
        assert res["best_params"] is not None
        assert os.path.exists("logs.json")


class TestSEALScale:
    def test_end_to_end_tiny(self):
        """Collab-scale SEAL pipeline (CSR extraction + native DRNL +
        batched DGCNN) at toy size: loss must decrease and held-out AUC
        must beat chance."""
        from linkpred.pipelines.seal_scale import (
            ScaleSEALConfig,
            run_seal_scale,
        )

        out = run_seal_scale(
            ScaleSEALConfig(nodes=600, edges=2400, target_pairs=256,
                            epochs=6, batch_size=32, max_neighbors=40),
            verbose=False,
        )
        assert out["loss_decreased"], out
        assert out["test_auc"] > 0.6, out
        assert out["subgraphs_per_s"] > 0


class TestScaleCLI:
    def test_scale_family_seal_parses_and_runs(self, capsys):
        from linkpred import cli

        cli.main(["--quiet", "scale", "--family", "seal", "--nodes", "400",
                  "--edges", "1600", "--hop", "1"])
        out = capsys.readouterr().out
        assert '"test_auc"' in out

    def test_scale_family_twowl_parses_and_runs(self, capsys):
        from linkpred import cli

        cli.main(["--quiet", "scale", "--family", "twowl", "--nodes", "1200",
                  "--edges", "5000", "--steps", "20"])
        out = capsys.readouterr().out
        assert '"test_auc"' in out
        assert '"ei2_cap_per_node"' in out

    def test_load_edge_pairs_whitespace_and_one_based(self, tmp_path):
        """Whitespace-separated 1-based dumps (the karate-style format)
        parse and relabel correctly."""
        from linkpred.data.io import load_edge_pairs

        path = tmp_path / "ws.edgelist"
        path.write_text("1 2\n2 3\n3 1\n3 1\n4 4\n")  # dup + self loop
        lo, hi, n = load_edge_pairs(str(path))
        assert n == 4  # ids 1..4 relabeled to 0..3
        assert len(lo) == 3  # dup deduped, self loop dropped
        assert (lo < hi).all()

    def test_scale_edges_file_real_graph(self, tmp_path, capsys):
        """`cli scale --edges-file` must replace the synthetic generator
        with a real edge dump: arbitrary ids,
        header row, comma separation, extra columns all tolerated."""
        import json

        import numpy as np

        from linkpred import cli
        from linkpred.data.io import load_edge_pairs

        # a "real" dump: shuffled non-contiguous ids + header + weights
        rng = np.random.default_rng(3)
        n = 300
        ids = rng.choice(10_000_000, n, replace=False)
        lo, hi, years = [], [], []
        for _ in range(1500):
            a, b = rng.integers(0, n, 2)
            if a != b:
                lo.append(ids[a]); hi.append(ids[b]); years.append(2019)
        path = tmp_path / "real.csv"
        with open(path, "w") as f:
            f.write("src,dst,year\n")
            for a, b, y in zip(lo, hi, years):
                f.write(f"{a},{b},{y}\n")

        l2, h2, n2 = load_edge_pairs(str(path))
        assert n2 <= n and n2 > 200
        assert l2.max() < n2 and (l2 < h2).all()

        cli.main(["--quiet", "scale", "--family", "gcn",
                  "--edges-file", str(path), "--steps", "8"])
        out = capsys.readouterr().out
        res = json.loads(out.strip().splitlines()[-1])
        assert res["nodes"] == n2
        assert "test_auc" in res


class TestReportCLI:
    def test_report_writes_selfcontained_html(self, tmp_path, capsys):
        """`cli report` (the L5 static-surface parity artifact) must emit
        one self-contained HTML file with the per-family tables and the
        reference-comparison deltas."""
        from linkpred import cli

        out_file = tmp_path / "report.html"
        cli.main(["report", "--output", str(out_file)])
        html = out_file.read_text()
        assert "<h1>linkpred" in html
        for family in ("logistic", "seal", "twowl"):
            assert family in html
        assert "0.8947" in html  # reference TwoWL AUC column
        # images inlined, not referenced
        assert "src='data:image/png;base64," in html or "Artifacts" not in html

"""Device bring-up surface: compile cache, peak table, optional plots, the
multi-device paths on four virtual devices, and `chip_smoke.py`'s own logic
(everything of it that runs without a GPU)."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from linkpred.utils import hardware, plots  # noqa: E402


class TestCompileCache:
    def test_env_dir_is_honoured_without_override(self, monkeypatch,
                                                  tmp_path):
        calls = []
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        assert hardware.enable_compile_cache() == str(tmp_path)
        assert calls == []

    def test_default_is_fixed_path_in_checkout(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            a = hardware.enable_compile_cache()
            b = hardware.enable_compile_cache()
            assert a == b == hardware.DEFAULT_CACHE_DIR
            assert jax.config.jax_compilation_cache_dir == a
            repo = os.path.realpath(ROOT)
            assert os.path.realpath(a) == os.path.join(repo, ".jax_cache")
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


class TestPeaks:
    def test_h100_figures(self):
        p = hardware.device_peaks("NVIDIA H100 80GB HBM3")
        assert p == {"hbm_gbs": 3350.0, "bf16_tflops": 989.0}

    def test_unknown_kind_raises(self):
        with pytest.raises(KeyError, match="no published peaks"):
            hardware.device_peaks("cpu")

    def test_nvidia_smi_absent_gives_empty(self, monkeypatch):
        monkeypatch.setattr(hardware.shutil, "which", lambda name: None)
        assert hardware.gpu_name_and_power_limit() == []

    def test_bench_result_names_the_device(self, monkeypatch):
        import bench

        monkeypatch.setattr(hardware.shutil, "which", lambda name: None)
        rec = bench.device_record()
        assert rec == {"platform": "cpu", "device_kind": "cpu",
                       "devices": 8, "nvidia_smi": []}


class TestPlotsOptional:
    def test_plot_roc_skips_without_matplotlib(self, monkeypatch, tmp_path,
                                               capsys):
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        out = tmp_path / "roc.png"
        got = plots.plot_roc(np.array([0.0, 1.0]), np.array([0.0, 1.0]),
                             0.5, "t", str(out))
        assert got is None and not out.exists()
        assert "matplotlib not installed" in capsys.readouterr().out

    def test_cli_compare_and_stats_without_matplotlib(self, monkeypatch,
                                                       tmp_path, capsys):
        from linkpred import cli

        monkeypatch.setitem(sys.modules, "matplotlib", None)
        monkeypatch.chdir(tmp_path)
        cli.main(["compare"])
        cli.main(["stats"])
        out = capsys.readouterr().out
        assert "family" in out and "nodes:" in out
        assert not (tmp_path / "assets").exists()


class TestChipSmoke:
    def test_exits_nonzero_without_gpu(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
            capture_output=True, text=True, env=env, timeout=300)
        assert r.returncode != 0
        assert "no GPU" in r.stdout + r.stderr
        assert '"ok"' not in r.stdout

    def test_result_line_keys(self):
        class Dev:
            platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

        line = json.loads(chip_smoke.result_line([Dev()]))
        assert line == {"ok": True, "device": {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
            "count": 1}}

    def test_multi_selects_only_the_multi_phase(self):
        assert chip_smoke.phases_for(multi=True) == ["device", "multi"]
        single = chip_smoke.phases_for(multi=False)
        assert "multi" not in single and single[0] == "device"

    def test_numerics_phase_at_tiny_size(self, tmp_path, monkeypatch):
        """The numerics phase's float64 references agree with the device
        paths (here the CPU backend) at a tiny size."""
        monkeypatch.chdir(tmp_path)
        tiny = chip_smoke.Sizes(
            collab_nodes=1500, collab_edges=6000, feats=16, gcn_hidden=16,
            twowl_nodes=600, twowl_edges=2400, seal_batch=16, seal_k=20,
            logistic_rows=300, logistic_dim=12)
        smoke = chip_smoke.Smoke(tiny, str(tmp_path))
        smoke.numerics()

    def test_scale_phase_at_tiny_size(self, tmp_path, monkeypatch):
        """The scale phase drives `cli scale` (TwoWL, GCN) and collab SEAL
        and reads their results; at a tiny graph each must train."""
        monkeypatch.chdir(tmp_path)
        tiny = chip_smoke.Sizes(scale_nodes=600, scale_edges=2400)
        chip_smoke.Smoke(tiny, str(tmp_path)).scale()


class TestFourDevices:
    def test_dryrun_multichip_on_four_devices(self):
        import __graft_entry__ as ge

        ge.dryrun_multichip(4)

    def test_train_collab_four_shards_matches_one(self):
        from linkpred.parallel import make_mesh
        from linkpred.pipelines.gcn_scale import ScaleGCNConfig, train_collab

        cfg = ScaleGCNConfig(nodes=400, edges=1600, steps=8,
                             batch_edges=128, emb_dim=8, hidden=16,
                             max_degree=8, dtype="f32")
        one = train_collab(cfg, mesh=make_mesh(1, shape=(1, 1)),
                           verbose=False)
        four = train_collab(cfg, mesh=make_mesh(4, shape=(1, 4)),
                            verbose=False)
        assert one["shards"] == 1 and four["shards"] == 4
        assert len(one["losses"]) == cfg.steps
        np.testing.assert_allclose(four["losses"], one["losses"],
                                   atol=1e-3)

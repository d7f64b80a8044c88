"""Checkpoint round-trips and artifact writers."""

import os

import jax
import numpy as np
import pytest

from linkpred.utils import checkpoint, plots


class TestCheckpoint:
    def test_roundtrip_nested_pytree(self, tmp_path, rng):
        tree = {
            "a": np.float32(rng.standard_normal((3, 4))),
            "nested": [
                {"w": np.float32(rng.standard_normal((2, 2))), "b": np.zeros(2)},
                {"w": np.float32(rng.standard_normal((2, 2))), "b": np.ones(2)},
            ],
        }
        path = checkpoint.save_pytree(str(tmp_path / "model"), tree, step=7)
        like = jax.tree_util.tree_map(np.zeros_like, tree)
        restored = checkpoint.restore_pytree(path, like)
        for a, b in zip(
            jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(restored)
        ):
            np.testing.assert_allclose(a, b)

    def test_latest_checkpoint(self, tmp_path):
        tree = {"x": np.zeros(2)}
        for step in (1, 10, 5):
            checkpoint.save_pytree(str(tmp_path / "m"), tree, step=step)
        latest = checkpoint.latest_checkpoint(str(tmp_path), "m")
        assert latest.endswith("m-10.npz")

    def test_shape_mismatch_raises(self, tmp_path):
        path = checkpoint.save_pytree(str(tmp_path / "m"), {"x": np.zeros(3)})
        with pytest.raises(ValueError):
            checkpoint.restore_pytree(path, {"x": np.zeros(4)})

    def test_twowl_params_roundtrip(self, tmp_path):
        from linkpred.models import twowl as m

        cfg = m.TwoWLConfig(max_degree=5, channels_1wl=8, channels_2wl=8,
                            depth1=1, depth2=1)
        params = m.init_params(jax.random.PRNGKey(0), cfg)
        path = checkpoint.save_pytree(str(tmp_path / "twowl"), params)
        like = jax.tree_util.tree_map(np.zeros_like, params)
        restored = checkpoint.restore_pytree(path, like)
        np.testing.assert_allclose(
            np.asarray(params["emb"]), restored["emb"], rtol=1e-6
        )


class TestPlots:
    def test_roc_plot_written(self, tmp_path):
        fpr = np.linspace(0, 1, 20)
        tpr = np.sqrt(fpr)
        out = plots.plot_roc(fpr, tpr, 0.75, "test", str(tmp_path / "roc.png"))
        assert os.path.exists(out) and os.path.getsize(out) > 0

    def test_comparison_plot_written(self, tmp_path):
        out = plots.plot_family_comparison(
            ["logistic", "seal", "twowl"], [0.8, 0.87, None],
            str(tmp_path / "cmp.png"),
        )
        assert os.path.exists(out) and os.path.getsize(out) > 0

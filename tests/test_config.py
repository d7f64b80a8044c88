"""Config tree, CLI overrides, degree cap, profiling counters."""

import numpy as np
import pytest

from linkpred.config import Config, apply_overrides
from linkpred.data.graph import Graph
from linkpred.utils.profiling import ThroughputCounter


class TestConfig:
    def test_defaults(self):
        cfg = Config()
        assert cfg.twowl.epochs == 1000
        assert cfg.seal.hop == "auto"

    def test_override_nested(self):
        cfg = apply_overrides(Config(), ["twowl.epochs=500", "seal.learning_rate=0.001"])
        assert cfg.twowl.epochs == 500
        assert cfg.seal.learning_rate == pytest.approx(0.001)
        assert cfg.logistic.seed == 35  # untouched

    def test_override_bool_and_str(self):
        cfg = apply_overrides(Config(), ["logistic.negatives=two_hop"])
        assert cfg.logistic.negatives == "two_hop"

    def test_unknown_key_raises(self):
        with pytest.raises(ValueError, match="unknown config field"):
            apply_overrides(Config(), ["nope.x=1"])

    def test_top_level(self):
        cfg = apply_overrides(Config(), ["seed=42", "twowl_trials=3"])
        assert cfg.seed == 42 and cfg.twowl_trials == 3


class TestDegreeCap:
    def test_cap_applied(self, rng):
        src = np.repeat(np.arange(5), 20)
        dst = rng.integers(5, 100, 100)
        g = Graph.from_edges(src, dst, num_nodes=100)
        capped = g.with_degree_cap(7, rng)
        assert capped.degree.max() <= 7
        assert capped.num_nodes == g.num_nodes
        # capped edge set is a subset of the original
        orig = set(zip(g.src.tolist(), g.dst.tolist()))
        assert all((s, d) in orig for s, d in zip(capped.src, capped.dst))

    def test_noop_when_under_cap(self, rng):
        g = Graph.from_undirected_edges([0, 1], [1, 2], num_nodes=3)
        capped = g.with_degree_cap(30, rng)
        assert capped.num_edges == g.num_edges


class TestThroughput:
    def test_counter(self):
        tc = ThroughputCounter("items")
        with tc.span(100):
            pass
        assert tc.items == 100
        assert tc.rate > 0
        assert "items/s" in tc.report()

"""Compiled peak-memory regression guards (SURVEY §5 race/aliasing row).

JAX's functional purity gives data-race freedom for free; the memory
hazard in THIS framework is different: the 2-WL structures put S ~ 100x
num_edges slot columns through every layer, so one careless intermediate
layout multiplies peak device memory by the slot count. That has
happened: a one-hot einsum over small trailing dims once inflated a
1.7 GB tensor to 21 GB at the 50k-node shape.

These tests pin the XLA-computed peak temp memory of the big compiled
programs at a fixed medium shape. They catch that incident class in CI
(virtual CPU mesh — `memory_analysis()` works on every backend) without
needing a GPU.

Buffer donation is deliberately NOT used on these scans: the donatable
carries (params + optimizer moments) are ~10 MB at the 50k-node scale
config against ~GB-sized plan/temp buffers. The budget below is the
check that matters.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from linkpred.data.twowl import build_twowl_data
from linkpred.models import twowl as m


@pytest.fixture(scope="module")
def medium_data():
    rng = np.random.default_rng(0)
    n = 1500
    lo = rng.integers(0, n, 9000)
    hi = rng.integers(0, n, 9000)
    keep = lo != hi
    pairs = np.stack([np.minimum(lo, hi)[keep],
                      np.maximum(lo, hi)[keep]], axis=1)
    pairs = np.unique(pairs, axis=0)
    return build_twowl_data(pairs, n, rng=rng, ei2_cap_per_node=128)


class TestCompiledMemoryBudget:
    def test_twowl_train_scan_peak_temp(self, medium_data):
        """Peak temp bytes of the fused epoch scan must stay within a
        small multiple of the ei2 slot payload. Measured healthy ratio:
        3.2x slot payload at this shape; the 21 GB incident class was a
        ~12x blowup. Budget 8x = 2.5x headroom over healthy, and the
        incident class fails immediately."""
        d = medium_data
        cfg = m.TwoWLConfig(max_degree=d.max_degree, channels_1wl=24,
                            channels_2wl=16, depth1=2, depth2=2,
                            dp_emb=0.0, dp_1wl0=0.0, dp_1wl1=0.0,
                            dp_2wl=0.0, act0=True, act1=False)
        params = m.init_params(jax.random.PRNGKey(0), cfg)
        opt = optax.adam(0.01)
        state = opt.init(params)
        trn = m.SplitArrays.from_split(d.train)
        val = m.SplitArrays.from_split(d.val)
        E, P = 4, 64
        rng = np.random.default_rng(1)
        n_pos = d.train.num_msg // 2
        n_neg = len(d.train.pred) // 2
        pos = jnp.asarray(np.stack(
            [rng.permutation(n_pos)[:P] for _ in range(E)]).astype(np.int32))
        neg = jnp.asarray(np.stack(
            [rng.permutation(n_neg)[:P] for _ in range(E)]).astype(np.int32))
        lowered = m.train_scan.lower(
            params, state, jax.random.PRNGKey(2), pos, neg, trn, val,
            jnp.asarray(d.val.y), jnp.asarray(d.node_deg), cfg, opt,
            d.num_nodes, E, early_stop=800, eval_every=2)
        ma = lowered.compile().memory_analysis()
        slots = int(trn.e1_src.shape[0])
        slot_payload = slots * cfg.channels_2wl * 4
        budget = 8 * slot_payload
        assert ma.temp_size_in_bytes < budget, (
            f"peak temp {ma.temp_size_in_bytes/1e6:.1f} MB exceeds "
            f"{budget/1e6:.1f} MB (= 25x ei2 slot payload; "
            f"slots={slots}) — an intermediate is materializing per-slot "
            f"tensors at a padded layout")

    def test_eval_forward_peak_temp(self, medium_data):
        """The eval forward (no autodiff residuals) must stay well under
        the train budget."""
        d = medium_data
        cfg = m.TwoWLConfig(max_degree=d.max_degree, channels_1wl=24,
                            channels_2wl=16, depth1=2, depth2=2,
                            act0=True, act1=False)
        params = m.init_params(jax.random.PRNGKey(0), cfg)
        val = m.SplitArrays.from_split(d.val)
        lowered = m.eval_scores.lower(
            params, jnp.asarray(d.node_deg), val, cfg, d.num_nodes)
        ma = lowered.compile().memory_analysis()
        slots = int(val.e1_src.shape[0])
        budget = 12 * slots * cfg.channels_2wl * 4
        assert ma.temp_size_in_bytes < budget, (
            ma.temp_size_in_bytes, budget)

"""Test configuration: run all tests on a virtual 8-device CPU mesh.

This must set env vars before the first `import jax` anywhere in the test
process (pytest imports conftest first). Multi-device sharding tests then
see 8 XLA host devices. The checks that need a GPU run on the card through
`chip_smoke.py`; a test that needs one carries the registered `gpu` marker
and decides inside a fixture, never at import, whether a card is present.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Pin the config as well as the env var: a site-wide JAX configuration
# could name another platform, and the config outranks the env var.
jax.config.update("jax_platforms", "cpu")
# Tests compile fresh: `cli.main` points the persistent compilation cache at
# a directory, and this keeps that from taking effect inside the suite.
jax.config.update("jax_enable_compilation_cache", False)
assert jax.devices()[0].platform == "cpu", jax.devices()
assert len(jax.devices()) == 8, jax.devices()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def fb_graph():
    from linkpred.data.io import load_fb_pages_food

    g, edges = load_fb_pages_food()
    return g, edges

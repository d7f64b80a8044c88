"""Profiling hooks: jax.profiler traces + throughput counters.

The reference's only tracing is wall-clock spans accumulated in a global
(`assets/theme.py:28-35`); `linkpred.utils.timer.StepTimer` covers that.
This module adds the device-level story: XLA device profiler traces viewable
in XProf/TensorBoard, and an edges/sec counter helper for the BASELINE
throughput metric.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def device_trace(log_dir: str = "logs/profile"):
    """Capture a jax.profiler trace (TensorBoard/XProf readable)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class ThroughputCounter:
    """Accumulates (items, seconds) spans; reports items/sec."""

    def __init__(self, unit: str = "edges"):
        self.unit = unit
        self.items = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def span(self, items: int):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds += time.perf_counter() - t0
            self.items += items

    @property
    def rate(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0

    def report(self) -> str:
        return f"{self.rate:,.0f} {self.unit}/s ({self.items} in {self.seconds:.3f}s)"

"""What the program knows about the device it runs on.

- `enable_compile_cache`: where JAX keeps its persistent compilation cache.
- `DEVICE_PEAKS` / `device_peaks`: published peak rates keyed by JAX's
  `device_kind`, the divisors of every roofline share the benchmark reports.
- `gpu_name_and_power_limit`: the card's name and power limit as
  `nvidia-smi` reports them, to print beside every measured time.
"""

from __future__ import annotations

import os
import shutil
import subprocess

# fixed in-checkout cache path, used when JAX_COMPILATION_CACHE_DIR is
# unset: the path is part of the cache key, so it must not move between runs
DEFAULT_CACHE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache"))

# Published dense peaks (no sparsity) of each supported device kind.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part (3.35 TB/s HBM3,
# 989 TFLOP/s bf16 tensor core), at its full 700 W power limit.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbs": 3350.0, "bf16_tflops": 989.0},
}


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
    sets no other directory. Otherwise the cache lives at the fixed
    `DEFAULT_CACHE_DIR` inside the checkout. Call before the first
    compilation of the process.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def device_peaks(device_kind: str) -> dict:
    """Peak rates of `device_kind` (`jax.devices()[0].device_kind`).

    A kind missing from `DEVICE_PEAKS` is an error, never a default."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(DEVICE_PEAKS)}") from None


def gpu_name_and_power_limit() -> list[str]:
    """One `name, power.limit` line per card, from `nvidia-smi`; an empty
    list where `nvidia-smi` is absent or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return []
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]

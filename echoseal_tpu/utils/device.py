"""Accelerator identity for the measurement scripts (bench.py, chip_smoke.py).

A measurement path that finds no GPU fails: it never falls back to the CPU,
so no CPU number can be printed under a device metric.
"""
from __future__ import annotations

import subprocess


def gpu_info() -> dict:
    """JAX's device view plus the card's name and power limit.

    Returns ``{"platform", "kind", "count", "cards"}``; ``cards`` holds one
    ``"<name>, <power limit>"`` line per card as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints it (run as a child that does not import JAX).  Raises
    ``RuntimeError`` unless every device JAX reports is a GPU.
    """
    import jax

    devs = jax.devices()
    platforms = sorted({d.platform for d in devs})
    if platforms != ["gpu"]:
        raise RuntimeError(
            f"no GPU: JAX reports platform(s) {platforms}; this path "
            "measures the GPU only and has no CPU fallback")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs),
            "cards": [ln.strip() for ln in smi.stdout.splitlines()
                      if ln.strip()]}

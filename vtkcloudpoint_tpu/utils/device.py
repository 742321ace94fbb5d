"""The device a measurement ran on.

Every timed path requires a GPU and stamps what JAX reports about it, beside
the card's name and power limit as nvidia-smi gives them (a card set below
its maximum power runs slower under load, so a time means little without
its limit).
"""
from __future__ import annotations

import subprocess


def require_gpu() -> dict:
    """JAX's devices as {"platform", "kind", "count"}; exits with status 2
    when the default platform is not a GPU (no fallback to the CPU)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's devices are {devs[0].platform!r} "
                         f"({len(devs)}); this path measures the GPU only")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_lines() -> list[str]:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`,
    one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]

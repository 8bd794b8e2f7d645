"""What the benchmark and the smoke script report about the device they ran on."""
from __future__ import annotations

import subprocess


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of each card as ``nvidia-smi`` reports them, one
    line per card, or a note when the tool is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"
    return out or "nvidia-smi reported no card"


def jax_device_summary() -> dict:
    """Platform, device kind and count as JAX reports them."""
    import jax

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }

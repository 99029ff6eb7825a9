"""What a measurement ran on: the JAX device and the card's power limit.

A card set below its maximum power runs slower under load, so every number
the benchmark prints carries the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` reports
them. nvidia-smi runs as a child process that never touches JAX.
"""

from __future__ import annotations

import shutil
import subprocess


def nvidia_smi_name_power() -> str | None:
    """The first card's "name, power.limit" line, or None without a card."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def device_summary() -> dict:
    """platform / device_kind / count of the default JAX backend, plus the
    card's power limit ("not measured" off a GPU)."""
    import jax

    devices = jax.devices()
    smi = nvidia_smi_name_power() if devices[0].platform == "gpu" else None
    power = smi.split(",", 1)[1].strip() if smi and "," in smi else None
    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "count": len(devices),
        "power_limit": power or "not measured",
    }

"""The GPU that measurements run on, and the refusal to run anywhere else.

Every timing this program reports names its device: JAX's platform, device
kind and count, plus the card's name and power limit as ``nvidia-smi``
reports them (a card set below its maximum power runs slower under load).
"""

from __future__ import annotations

import subprocess

__all__ = ["require_gpu", "card_lines", "device_record"]

_SMI = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


def require_gpu():
    """JAX's default device, or RuntimeError when it is not a GPU: a
    measurement never falls back to the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU found: JAX's default device is {dev.platform} "
            f"({dev.device_kind})"
        )
    return dev


def card_lines() -> list[str]:
    """One ``name, power.limit`` line per card, exactly as nvidia-smi gives it."""
    out = subprocess.run(_SMI, check=True, capture_output=True, text=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def device_record() -> dict:
    """Platform, device kind, device count and card lines for a result."""
    import jax

    dev = require_gpu()
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "cards": card_lines(),
    }

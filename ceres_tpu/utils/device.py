"""The accelerator a driver script runs on: refuse anything but a GPU, and
describe the card so that every number can be printed beside it."""

from __future__ import annotations

import subprocess

import jax


class NoGPUError(RuntimeError):
    """JAX's first device is not a GPU."""


def require_gpu() -> dict:
    """{"platform", "kind", "count"} of JAX's devices; raises NoGPUError
    when the first device is not a GPU (there is no CPU fallback)."""
    devices = jax.devices()
    stamp = {"platform": devices[0].platform,
             "kind": devices[0].device_kind,
             "count": len(devices)}
    if stamp["platform"] != "gpu":
        raise NoGPUError(f"no GPU: JAX's first device is {devices[0]!r}")
    return stamp


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every card, one line
    each, as the tool prints it. A card below its maximum power limit runs
    slower under load, so this goes beside every measurement."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()

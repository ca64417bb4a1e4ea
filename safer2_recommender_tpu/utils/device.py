"""Which device a measurement ran on.

Timings and rates mean something only for the device that produced
them, so every measuring script names it and refuses to run on any
other backend than the GPU (no silent CPU fallback).
"""

from __future__ import annotations

import subprocess


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s ``name, power.limit`` line for each card, read in
    a child process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu() -> dict:
    """The JAX device description ({platform, kind, count}); raises
    ``SystemExit`` unless JAX's default backend is the GPU."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(
            f"needs a GPU: JAX's default backend is {backend!r}")
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}

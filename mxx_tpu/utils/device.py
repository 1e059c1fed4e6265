"""The accelerator a run reports its numbers for (entry points only)."""

from __future__ import annotations

import subprocess
import sys

import jax


def require_gpu(program: str):
    """JAX's first device; exits with status 1 unless it is a GPU.

    There is no CPU fallback: a number measured elsewhere must not be
    reported under the card's name."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"{program}: no GPU found (jax.devices()[0].platform is "
              f"{dev.platform!r})", file=sys.stderr)
        raise SystemExit(1)
    return dev


def nvidia_smi_cards() -> list[str]:
    """`name, power.limit` of every card, one entry per card, as nvidia-smi
    reports them (run as a subprocess, outside JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]

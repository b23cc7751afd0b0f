"""Which accelerator a measurement runs on: JAX's view of it and the card's
name and power limit from nvidia-smi.  Measurement scripts (chip_smoke.py,
bench.py, profile_video.py) print both and refuse to run without a GPU."""

from __future__ import annotations

import subprocess
import sys

import jax


def device_line(devices=None) -> dict:
    """{"platform", "kind", "count"} of the devices JAX sees."""
    devices = devices if devices is not None else jax.devices()
    d = devices[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devices)}


def card_info() -> list:
    """One 'name, power limit' line per card, as nvidia-smi reports them
    (a subprocess: it never touches JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def require_gpu(tool: str) -> dict:
    """The device line, printed with each card's name and power limit.
    Exits with status 2, before any work, when JAX finds no GPU: a number
    from another backend must never stand in for a GPU measurement."""
    dev = device_line()
    if dev["platform"] != "gpu":
        print(f"{tool}: JAX finds no GPU (platform {dev['platform']!r}); "
              "nothing was run", file=sys.stderr)
        raise SystemExit(2)
    print(f"device: {dev['kind']} x{dev['count']} ({dev['platform']})", flush=True)
    for line in card_info():
        print(f"card: {line}", flush=True)
    return dev

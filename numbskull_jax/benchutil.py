"""Device-rate timing shared by bench.py and the experiment drivers."""

from __future__ import annotations

import subprocess
import time

import jax


def timed_rate(run, units_per_epoch: float, epochs: int, reps: int = 3):
    """(units/s, s/epoch) of ``run(epochs)``.

    ``run(epochs)`` returns the device arrays of one run. The first call
    compiles and is not timed; each timed call ends in
    ``block_until_ready``, so the time covers the device work and the
    host dispatch that a user also waits for. Returns the best of
    ``reps`` timed calls."""
    jax.block_until_ready(run(epochs))
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(epochs))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return units_per_epoch * epochs / best, best / epochs


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()

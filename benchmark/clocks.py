"""The card's clocks, throttle reasons, power and temperature beside each
window, read with nvidia-smi (which reads and sets nothing else)."""

from __future__ import annotations

import subprocess

FIELDS = "clocks.sm,clocks_throttle_reasons.active,power.draw,power.limit,temperature.gpu"


def sample() -> str:
    """One CSV line per card, or what went wrong; never raises."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={FIELDS}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    if out.returncode != 0:
        return f"nvidia-smi failed: {out.stderr.strip()[:200]}"
    return f"{FIELDS}: " + out.stdout.strip().replace("\n", " | ")

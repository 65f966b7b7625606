"""What the run prints about the machine beside its numbers: the card's
name, clocks, power and power limit (nvidia-smi), and the host's CPUs and
load."""

from __future__ import annotations

import os
import subprocess

SMI_FIELDS = "name,power.limit,power.draw,clocks.sm,clocks.mem,temperature.gpu"


def smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={SMI_FIELDS}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return " | ".join(out.stdout.strip().splitlines())
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def host() -> str:
    load = " ".join(f"{v:.2f}" for v in os.getloadavg())
    return f"{os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} usable, load {load}"

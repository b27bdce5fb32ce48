"""What the run ran on: the card as PyTorch and ``nvidia-smi`` see it."""

from __future__ import annotations

import subprocess
from typing import Dict

QUERY = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"


def nvidia_smi() -> str:
    """One line a card: name, power limit, SM clock and its maximum, memory clock, temperature."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={QUERY}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e!r}"


def device_record(count: int, device) -> Dict:
    import torch

    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=int(count),
                memory_peak_bytes=int(max(torch.cuda.max_memory_allocated(i) for i in range(count))))

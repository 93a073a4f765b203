"""Device selection for the package's entry points, and the card's name."""

from __future__ import annotations

import subprocess
from typing import Optional

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for (the
    entry points' default) and no CUDA device is present, so nothing
    silently runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev


def card_name(device) -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    power limit bounds the card's speed under load, so it goes beside every
    time taken there); None for a CPU device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        lines = []
    if index < len(lines):
        return lines[index].strip()
    return f"{torch.cuda.get_device_name(dev)}, power limit not read"

"""Device selection for the package's entry points."""

from __future__ import annotations

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

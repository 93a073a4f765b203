"""Parameter export: ``best_model.npz`` with the JAX package's keys.

The keys are "emb" (joint table), or "user_emb" and "item_emb" (split
tables), as numpy arrays, so a file written by either package loads in the
other.  Full training state (optimizer, epoch, generator) comes with the
training slice.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch


def save_params_npz(path, params: Dict[str, torch.Tensor]) -> None:
    flat = {k: v.detach().cpu().numpy() for k, v in params.items()}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)


def load_params_npz(path, device="cpu") -> Dict[str, torch.Tensor]:
    with np.load(path) as z:
        return {k: torch.as_tensor(z[k], device=device) for k in z.files}

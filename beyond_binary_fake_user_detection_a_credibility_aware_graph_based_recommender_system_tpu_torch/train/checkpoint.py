"""Checkpointing: parameter export and full training state.

``best_model.npz`` has the JAX package's keys: "emb" (joint table), or
"user_emb" and "item_emb" (split tables), as numpy arrays, so a file
written by either package loads in the other.

:class:`TrainCheckpointer` keeps the full training state (params, Adam
moments and count, epoch, generator state, best-val score and params)
with ``torch.save``, under the contract of the JAX package's Orbax
checkpointer: the first step and then every ``every``-th step is saved,
the last ``keep`` are kept (the latest always), and a resumed run equals
an uninterrupted one.

Under ``torch.distributed`` the processes of the group share one directory:
rank 0 writes each saved step and every rank waits at a barrier until it
is on disk; every rank restores from it.  A trainer on a mesh saves its
tables and moments gathered and padded (the JAX package's Orbax
checkpointer saves the sharded arrays), and each rank keeps its block of
them on restore.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist


def save_params_npz(path, params: Dict[str, torch.Tensor]) -> None:
    flat = {k: v.detach().cpu().numpy() for k, v in params.items()}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)


def load_params_npz(path, device="cpu") -> Dict[str, torch.Tensor]:
    with np.load(path) as z:
        return {k: torch.as_tensor(z[k], device=device) for k in z.files}


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


class TrainCheckpointer:
    """One ``<step>.pt`` file per saved step under ``directory``.  Saves are
    synchronous, so :meth:`wait` has nothing to wait for."""

    def __init__(self, directory, keep: int = 3, every: int = 1):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = max(int(keep), 1)
        self.every = max(int(every), 1)

    def _path(self, step: int) -> Path:
        return self.directory / f"{step}.pt"

    def all_steps(self) -> List[int]:
        return sorted(int(p.stem) for p in self.directory.glob("*.pt")
                      if p.stem.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any]) -> bool:
        """Save ``state`` (tensors on any device) as ``step``; returns False
        when the cadence skips it.  In a process group only rank 0 writes,
        and every rank returns once the file is written."""
        if self.latest_step() is not None and step % self.every != 0:
            return False
        group = dist.is_initialized()
        if not group or dist.get_rank() == 0:
            path = self._path(step)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            torch.save(_to_cpu(state), tmp)
            os.replace(tmp, path)
            for old in self.all_steps()[:-self.keep]:
                self._path(old).unlink()
        if group:
            dist.barrier()
        return True

    def restore(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The state saved at ``step`` (default: the latest), tensors on
        the CPU; None when nothing is saved."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

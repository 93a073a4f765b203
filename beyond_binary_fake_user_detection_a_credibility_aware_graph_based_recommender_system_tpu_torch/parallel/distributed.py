"""Multi-process initialisation of ``torch.distributed``.

One process per card, as ``torchrun`` starts them: NCCL between CUDA
devices, gloo between CPU processes (the tests).  Every collective of the
mesh path (``parallel/sharded_spmm.py``, ``parallel/sharded_topk.py``) is a
``torch.distributed`` call on a group of the mesh.

    torchrun --nproc-per-node 2 -m <package>.cli evaluate --mesh 2 ...

A single process is a no-op here: ``mesh.make_mesh`` then builds a world of
one itself.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

# what torchrun sets in every process it starts
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def launched() -> bool:
    """Whether a launcher's environment names this process's rank."""
    return all(os.environ.get(k) for k in LAUNCHER_ENV)


def launched_world_size() -> int:
    """The launcher's world size (1 without a launcher)."""
    return int(os.environ["WORLD_SIZE"]) if launched() else 1


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` for a bare ``"cuda"``,
    else ``device`` as named."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, device="cuda",
               backend: Optional[str] = None,
               timeout: Optional[timedelta] = None) -> bool:
    """Join the default process group when the run has several processes;
    a no-op returning False otherwise.

    Without arguments the launcher's environment decides (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``: ``env://``);
    ``init_method`` with ``world_size`` and ``rank`` name the group
    explicitly (``tcp://host:port``, ``file://path``).  The backend is NCCL
    for a CUDA ``device`` and gloo for the CPU unless ``backend`` says
    otherwise.  A failed initialisation raises."""
    if dist.is_initialized():
        return True
    if init_method is None and launched_world_size() <= 1:
        return False
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {"backend": backend or backend_for(dev),
              "init_method": init_method or "env://"}
    if world_size is not None:
        kwargs.update(world_size=world_size, rank=rank)
    if timeout is not None:
        kwargs["timeout"] = timeout
    dist.init_process_group(**kwargs)
    return True


def process_info(device="cuda") -> dict:
    """Rank, world size, local rank and device of this process."""
    up = dist.is_initialized()
    return {"rank": dist.get_rank() if up else 0,
            "world_size": dist.get_world_size() if up else 1,
            "local_rank": int(os.environ.get("LOCAL_RANK", 0)),
            "device": str(rank_device(device))}

"""The (data, model) device mesh on ``torch.distributed``.

Tables are row-sharded over ``model``; ``data`` holds replicas, which
evaluate the same users and train on their own columns of each batch
(``parallel/sharding.py``).  A :class:`ModelAxis` (and a :class:`DataAxis`)
is that axis as one rank sees it: its size, the rank's coordinate, the group
and the device.  The host planning of the sharded operators needs only the
first two, so the tests build plans for any size without a process group.

A table of N rows is row-sharded in P blocks of ``ceil(N/P)`` rows: it is
padded with zero rows to :func:`padded_row_count` first (:func:`pad_rows`),
as the JAX package's trainer pads (``JAX: train/trainer.py:138-157``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .distributed import backend_for

DATA_AXIS = "data"
MODEL_AXIS = "model"


def factor_mesh(n_devices: int) -> Tuple[int, int]:
    """Split n devices into (data, model) — as square as possible with the
    model axis taking the larger factor (embedding tables dominate memory)."""
    best = (1, n_devices)
    for d in range(1, int(np.sqrt(n_devices)) + 1):
        if n_devices % d == 0:
            best = (d, n_devices // d)
    return best


def _world_of_one(device_type: str) -> None:
    """The default process group of a single process: a store on
    localhost, NCCL on the card, gloo on the CPU."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a CUDA device; pass "
                           "device_type='cpu' (CLI: --device cpu)")
    store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
    dist.init_process_group(backend_for(device_type), store=store, rank=0,
                            world_size=1)


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, int]] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` over every rank of the default group, with the
    dimensions ``("data", "model")`` of ``shape`` (default
    :func:`factor_mesh`).  ``n_devices`` must equal the world size.  With no
    process group yet, a world of one is created here."""
    if not dist.is_initialized():
        _world_of_one(device_type)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs {n_devices} "
                         f"processes; the world has {world}")
    shape = tuple(shape) if shape is not None else factor_mesh(world)
    if shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {shape} does not hold {world} ranks")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


@dataclass(frozen=True)
class ModelAxis:
    """The model axis as one rank sees it.  ``group`` is None only for host
    planning (no collective can run)."""
    size: int
    coord: int = 0
    group: Optional[dist.ProcessGroup] = None
    device: torch.device = torch.device("cpu")


@dataclass(frozen=True)
class DataAxis:
    """The data axis as one rank sees it: the replicas that train on the
    other columns of each batch, and reduce the gradients with this rank."""
    size: int
    coord: int = 0
    group: Optional[dist.ProcessGroup] = None
    device: torch.device = torch.device("cpu")


def _device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _check_mesh(mesh) -> None:
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a DeviceMesh (parallel/mesh.make_mesh) or "
                        f"a ModelAxis, got {type(mesh).__name__}")


def model_axis(mesh) -> ModelAxis:
    """``mesh`` (a ``DeviceMesh``, or already a :class:`ModelAxis`) as this
    rank's :class:`ModelAxis`."""
    if isinstance(mesh, ModelAxis):
        return mesh
    _check_mesh(mesh)
    return ModelAxis(size=mesh[MODEL_AXIS].size(),
                     coord=mesh.get_local_rank(MODEL_AXIS),
                     group=model_group(mesh), device=_device(mesh))


def data_axis(mesh) -> DataAxis:
    """``mesh`` (a ``DeviceMesh``) as this rank's :class:`DataAxis`; a
    :class:`ModelAxis` (host planning) has one replica and no group."""
    if isinstance(mesh, ModelAxis):
        return DataAxis(size=1, device=mesh.device)
    _check_mesh(mesh)
    return DataAxis(size=mesh[DATA_AXIS].size(),
                    coord=mesh.get_local_rank(DATA_AXIS),
                    group=data_group(mesh), device=_device(mesh))


def model_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    return mesh.get_group(MODEL_AXIS)


def data_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    """The group of this rank's replicas (the sharded train step's batch
    axis)."""
    return mesh.get_group(DATA_AXIS)


def padded_row_count(rows: int, size: int) -> int:
    """``ceil(rows / size) * size``: the rows of a table row-sharded in
    ``size`` equal blocks."""
    return -(-rows // size) * size


def pad_rows(table: torch.Tensor, size: int) -> torch.Tensor:
    """``table`` with zero rows appended up to :func:`padded_row_count`
    (``table`` itself when no row is missing)."""
    rows = table.shape[0]
    padded = padded_row_count(rows, size)
    if padded == rows:
        return table
    return torch.cat([table, table.new_zeros((padded - rows,)
                                             + tuple(table.shape[1:]))])


def row_shard(table: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """This rank's rows of a table row-sharded over the model axis (the
    rows split in ``axis.size`` equal blocks, in coordinate order; pad a
    table whose rows do not split with :func:`pad_rows` first)."""
    if table.shape[0] % axis.size:
        raise ValueError(f"{table.shape[0]} rows do not split in "
                         f"{axis.size} equal shards (pad_rows first)")
    rows = table.shape[0] // axis.size
    return table[axis.coord * rows:(axis.coord + 1) * rows]

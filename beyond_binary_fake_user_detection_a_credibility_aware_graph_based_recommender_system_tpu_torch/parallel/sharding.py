"""Sharded training on a (data, model) device mesh.

The port of ``JAX: parallel/sharding.py``, with the same layout:

  * every 2-D parameter leaf (an embedding table) is padded with zero rows
    to ``ceil(N/P) * P`` and row-sharded over ``model``: each rank holds one
    block of ``ceil(N/P)`` rows (``parallel/mesh.py``);
  * the Adam moments follow their parameter; anything else is replicated;
  * the batches are sharded over ``data``: each replica takes its columns
    of every batch.

The JAX package lets GSPMD insert the collectives.  Here the step
(:func:`make_sharded_train_step`) names them:

  * **Forward.**  :func:`gather_params` all-gathers each table's blocks over
    the model group (``all_gather_into_tensor``) into the padded table, and
    the pad rows are sliced off.  The backward takes this rank's block of
    the cotangent, with no collective: inside one model group every rank
    computes the same loss on the same batch columns, so the cotangent is
    replicated there (the contract of ``parallel/sharded_spmm.py``).  The
    pad rows get exactly-zero gradients, so their moments stay 0.
  * **Loss.**  Each replica computes its share: the masked sum over its
    columns divided by the whole batch's mask count
    (``models/losses.py``), so the shares sum to the masked mean over the
    whole batch, not to a mean of the replicas' means.
  * **Gradients.**  One ``all_reduce`` (sum) over the data group a step, on
    one flat buffer of every block's gradient and the loss share: the
    summed gradient, and the loss every rank reports.
  * **Adam.**  The fused Adam kernel (``ops/adam.py``: one launch over every
    leaf) on the rank's parameter and moment blocks, in place.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..models import losses
from ..models.lightgcn import LightGCN, Params, ego_tables
from ..ops.adam import AdamState, adam_init, adam_step
from .mesh import (MODEL_AXIS, ModelAxis, data_axis, model_axis, pad_rows,
                   row_shard)
from .sharded_spmm import all_gather_rows

Shardings = Dict[str, Optional[str]]


def param_shardings(params: Params) -> Shardings:
    """The per-leaf rule: a 2-D leaf is row-sharded over the model axis
    (``MODEL_AXIS``), anything else replicated (None)."""
    return {k: MODEL_AXIS if v.dim() == 2 else None
            for k, v in params.items()}


def opt_state_shardings(p_shard: Shardings) -> Dict[str, Shardings]:
    """Adam moments mirror the parameter sharding (the step count is a
    host integer)."""
    return {"m": dict(p_shard), "v": dict(p_shard)}


def table_rows(model: LightGCN) -> Dict[str, int]:
    """The exact rows of each parameter table of ``model``."""
    if model.cfg.table_layout == "joint":
        return {"emb": model.num_users + model.num_items}
    return {"user_emb": model.num_users, "item_emb": model.num_items}


def shard_params(params: Params, axis: ModelAxis) -> Params:
    """This rank's leaves of exact-row ``params``: each table padded to
    ``ceil(N/P) * P`` rows and cut to its block, other leaves copied."""
    p_shard = param_shardings(params)
    return {k: (row_shard(pad_rows(v.detach(), axis.size), axis)
                if p_shard[k] else v.detach()).clone()
            for k, v in params.items()}


def gather_params(blocks: Params, axis: ModelAxis,
                  rows: Optional[Dict[str, int]] = None) -> Params:
    """The tables of this rank's ``blocks``, on every rank of the model
    group: padded, or cut to ``rows`` (by leaf); differentiable in the
    blocks.  Replicated leaves pass through."""
    p_shard = param_shardings(blocks)
    out = {}
    for k, v in blocks.items():
        if p_shard[k]:
            v = all_gather_rows(v, axis)
            if rows is not None:
                v = v[:rows[k]]
        out[k] = v
    return out


def make_sharded_train_step(model: LightGCN, mesh, lr: float,
                            loss_fn: Optional[Callable] = None,
                            backend: str = "auto"
                            ) -> Tuple[Callable, Callable, Callable]:
    """``(step, shard_state, oracle)`` of a train step of ``model`` (built
    on the mesh's sharded operators) on ``mesh``.

    ``loss_fn(tables, *batch)`` is this replica's loss share on the
    exact-row tables; the default is the JAX package's step loss: the full
    propagation, then BPR plus ``cfg.reg`` times the ego L2 on
    ``(users, pos, neg)``, each the mean over the whole batch (every
    replica's columns).

      * ``shard_state(params, opt_state=None)`` -> ``(blocks, opt_blocks,
        p_shard, o_shard)``: this rank's blocks of exact-row parameters and
        of their Adam moments (zeros without ``opt_state``);
      * ``step(blocks, opt_blocks, *batch)`` updates the blocks in place
        and returns the loss (0-d, equal on every rank);
      * ``oracle(params, opt_state, *batch)`` is the same step on
        unsharded parameters, on one replica's data.
    """
    axis, data = model_axis(mesh), data_axis(mesh)
    rows = table_rows(model)
    # the oracle's data are one replica's: its share is the whole loss
    oracle_loss = loss_fn or _bpr_step_loss(model, 1)
    loss_fn = loss_fn or _bpr_step_loss(model, data.size)

    def shard_state(params: Params, opt_state: Optional[AdamState] = None):
        blocks = shard_params(params, axis)
        if opt_state is None:
            opt = adam_init(blocks)
        else:
            opt = AdamState(m=shard_params(opt_state.m, axis),
                            v=shard_params(opt_state.v, axis),
                            count=opt_state.count)
        p_shard = param_shardings(params)
        return blocks, opt, p_shard, opt_state_shardings(p_shard)

    def step(blocks: Params, opt: AdamState, *batch) -> torch.Tensor:
        leaves = {k: b.detach().requires_grad_() for k, b in blocks.items()}
        loss = loss_fn(gather_params(leaves, axis, rows), *batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        # the data axis's one collective: every gradient block and the
        # loss share in one buffer
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [loss.detach().reshape(1).to(grads[0].dtype)])
        dist.all_reduce(flat, group=data.group)
        summed, at = {}, 0
        for k, g in zip(leaves, grads):
            summed[k] = flat[at:at + g.numel()].view(g.shape)
            at += g.numel()
        adam_step(blocks, summed, opt, lr, backend=backend)
        return flat[-1]

    def oracle(params: Params, opt: AdamState, *batch) -> torch.Tensor:
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = oracle_loss(leaves, *batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        adam_step(params, dict(zip(leaves, grads)), opt, lr, backend=backend)
        return loss.detach()

    return step, shard_state, oracle


def _bpr_step_loss(model: LightGCN, replicas: int) -> Callable:
    """The JAX package's ``make_sharded_train_step`` loss
    (``JAX: parallel/sharding.py:51-64``) as one replica's share of a batch
    ``replicas`` times its columns."""
    reg = model.cfg.reg

    def loss_fn(tables: Params, users, pos, neg) -> torch.Tensor:
        count = torch.tensor(float(users.numel() * replicas),
                             device=users.device)
        user_emb, item_emb = model.propagate(tables)
        pos_s = LightGCN.score(user_emb, item_emb, users, pos)
        neg_s = LightGCN.score(user_emb, item_emb, users, neg)
        ego_u, ego_i = ego_tables(tables, model.num_users)
        return (losses.bpr_loss(pos_s, neg_s, count=count)
                + reg * losses.ego_l2(ego_u[users], ego_i[pos], ego_i[neg],
                                      count=count))
    return loss_fn

"""SLAS-subgraph CredModel forward: fixed-shape sampled neighborhoods.

The reference trains CredModel on SLAS-sampled 2-hop subgraphs assembled in
per-user Python loops (main.py:809-883).  As in the JAX package's
``models/cred_slas.py``, the same architecture and sampling distribution
run on a fixed-shape sampled neighborhood per step:

  * seeds (B,) -> Gumbel-top-k similarity-weighted item draws (B, Ki) with
    the temporal-view edge filter (``ops/slas.py``);
  * each drawn item slot -> Gumbel-top-k user draws (Ki*B, Ku) with the
    labeled-user upweight;
  * stage 1: each item slot aggregates its seed + sampled users with
    normalized EWA weights; stage 2: each seed aggregates its item slots.

Differences vs the reference's assembly (documented, deliberate, the JAX
package's): item slots are NOT deduplicated across seeds, and the subgraph
holds the SAMPLED edges rather than every edge between sampled nodes.

:func:`slas_forward` is :func:`slas_draw` (the two draws, which depend on
the graph only) followed by :func:`slas_aggregate` (deterministic in the
parameters), so a test can hold the aggregation against the JAX package's
on the same draws.  All shapes are static; masked slots carry zero weight
through the normalized aggregation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..graph.hetero import HeteroGraph
from ..ops.slas import SlasSampler
from ..utils.config import CredConfig
from .cred_model import Params, ewa_raw_weights


@dataclass(frozen=True)
class SlasGraphData:
    """Device tensors of the sampled-subgraph forward."""
    user_x: torch.Tensor       # (U, Fu)
    item_x: torch.Tensor       # (I, Fi)
    edge_w_raw: torch.Tensor   # (E,) EWA raw weights per original edge
    sampler: SlasSampler


def build_slas_graph_data(hg: HeteroGraph, cfg: Optional[CredConfig] = None,
                          device="cpu") -> SlasGraphData:
    cfg = cfg or CredConfig()
    return SlasGraphData(
        user_x=torch.as_tensor(np.nan_to_num(hg.user_x, nan=0.0),
                               device=device),
        item_x=torch.as_tensor(np.nan_to_num(hg.item_x, nan=0.0),
                               device=device),
        edge_w_raw=torch.as_tensor(
            ewa_raw_weights(hg.edge_attr, cfg.beta, cfg.gamma), device=device),
        sampler=SlasSampler.build(hg, cfg, device=device),
    )


class SlasDraws(NamedTuple):
    """One sampled 2-hop neighborhood of a batch of seeds."""
    items: torch.Tensor        # (B, Ki) drawn item ids
    item_mask: torch.Tensor    # (B, Ki) bool, valid item slots
    nbr_users: torch.Tensor    # (B*Ki, Ku) drawn user ids per item slot
    user_mask: torch.Tensor    # (B*Ki, Ku) bool, valid user slots


def slas_draw(data: SlasGraphData, seeds: torch.Tensor,
              gen: Optional[torch.Generator], view: Optional[str],
              k_items: int, k_users: int, uniforms=None) -> SlasDraws:
    """The item draw for the seeds, then the user draw for every item slot
    (``uniforms``: an optional pair of the two draws' uniforms, (B, P) and
    (B*Ki, P), in place of ``gen``)."""
    s = data.sampler
    u_items, u_users = uniforms if uniforms is not None else (None, None)
    items, item_mask = s.sample_items_for_users(gen, seeds, k_items, view,
                                                uniforms=u_items)
    nbr_users, user_mask = s.sample_users_for_items(
        gen, items.reshape(-1), k_users, uniforms=u_users)
    # invalid item slots poison their user draws
    user_mask = user_mask & item_mask.reshape(-1, 1)
    return SlasDraws(items, item_mask, nbr_users, user_mask)


def slas_aggregate(params: Params, data: SlasGraphData, seeds: torch.Tensor,
                   draws: SlasDraws):
    """(cred (B,), h_u2 (B,H), h_i1 (B*Ki,H), aux) for the seed users on a
    drawn neighborhood, where aux = (w_seed_norm (B*Ki,), item_mask (B, Ki))
    feeds the smoothness term.  Mirrors ``forward_subgraph``
    (main.py:690-707) on the sampled fixed-shape neighborhood."""
    B, k_items = draws.items.shape
    flat_items = draws.items.reshape(-1)
    item_mask, user_mask = draws.item_mask, draws.user_mask
    s = data.sampler

    # ---- projections --------------------------------------------------
    h_u0_seed = data.user_x[seeds] @ params["user_proj_w"] \
        + params["user_proj_b"]                             # (B, H)
    h_i0 = data.item_x[flat_items.clamp(0, data.item_x.shape[0] - 1)] \
        @ params["item_proj_w"] + params["item_proj_b"]     # (B*Ki, H)
    h_u0_nbr = data.user_x[draws.nbr_users.clamp(0, data.user_x.shape[0] - 1)] \
        @ params["user_proj_w"] + params["user_proj_b"]     # (B*Ki, Ku, H)

    # ---- stage 1: item <- users (EWA-normalized) ----------------------
    # each item slot receives from its Ku sampled users and from its seed
    # (the edge that selected it)
    w_seed = _edge_w(data, s, seeds, draws.items)               # (B, Ki)
    w_nbr = _edge_w_items(data, s, flat_items, draws.nbr_users)  # (B*Ki, Ku)

    w_seed_f = (w_seed * item_mask).reshape(-1, 1)          # (B*Ki, 1)
    w_nbr_f = w_nbr * user_mask                             # (B*Ki, Ku)
    denom_i = (w_seed_f.sum(-1, keepdim=True) + w_nbr_f.sum(-1, keepdim=True)
               + 1e-12)
    msg_i = (w_seed_f * torch.repeat_interleave(h_u0_seed, k_items, dim=0)
             + torch.einsum("ek,ekh->eh", w_nbr_f, h_u0_nbr)) / denom_i
    h_i1 = torch.relu(torch.cat([h_i0, msg_i], dim=-1) @ params["item_upd_w"]
                      + params["item_upd_b"])               # (B*Ki, H)

    # ---- stage 2: seed user <- its item slots -------------------------
    w_ui = w_seed * item_mask                               # (B, Ki)
    denom_u = w_ui.sum(-1, keepdim=True) + 1e-12
    msg_u = torch.einsum("bk,bkh->bh", w_ui,
                         h_i1.reshape(B, k_items, -1)) / denom_u
    h_u2 = torch.relu(torch.cat([h_u0_seed, msg_u], dim=-1)
                      @ params["user_upd_w"] + params["user_upd_b"])  # (B, H)

    cred = torch.sigmoid(
        (h_u2 @ params["out_w"] + params["out_b"]).squeeze(-1))
    w_seed_norm = (w_seed_f / denom_i).squeeze(-1)          # (B*Ki,)
    return cred, h_u2, h_i1, (w_seed_norm, item_mask)


def slas_forward(params: Params, data: SlasGraphData, seeds: torch.Tensor,
                 gen: Optional[torch.Generator], view: Optional[str],
                 k_items: int, k_users: int, uniforms=None):
    """:func:`slas_draw` then :func:`slas_aggregate` (``JAX:
    models/cred_slas.py:67-122``)."""
    draws = slas_draw(data, seeds, gen, view, k_items, k_users, uniforms)
    return slas_aggregate(params, data, seeds, draws)


def _first_match_eids(rows: torch.Tensor, eid_rows: torch.Tensor,
                      slots: torch.Tensor) -> torch.Tensor:
    """Edge id of each drawn neighbor: the first slot of its row holding
    that id (argmax over a match mask takes the first maximum, as JAX's
    does; -1 where the row's slot is a pad)."""
    match = rows[:, None, :] == slots[:, :, None]
    slot = match.to(torch.int8).argmax(dim=-1)
    return torch.gather(eid_rows, 1, slot)


def _edge_w(data: SlasGraphData, s: SlasSampler, seeds: torch.Tensor,
            item_slots: torch.Tensor) -> torch.Tensor:
    """EWA raw weight of the (seed -> sampled item slot) edges.

    ``sample_items_for_users`` draws CSR slots of ``u_items``; recover each
    draw's edge id by matching the drawn item against the seed's neighbor
    row (first match — duplicate edges share attribute distribution)."""
    eids = _first_match_eids(s.u_items[seeds], s.u_eids[seeds], item_slots)
    return data.edge_w_raw[eids.clamp(min=0)] * (eids >= 0)


def _edge_w_items(data: SlasGraphData, s: SlasSampler, items: torch.Tensor,
                  user_slots: torch.Tensor) -> torch.Tensor:
    it = items.clamp(0, s.i_users.shape[0] - 1)
    eids = _first_match_eids(s.i_users[it], s.i_eids[it], user_slots)
    return data.edge_w_raw[eids.clamp(min=0)] * (eids >= 0)

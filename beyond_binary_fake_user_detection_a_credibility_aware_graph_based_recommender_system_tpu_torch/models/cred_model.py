"""CredModel: edge-weighted GraphSAGE-style credibility scorer (Stage A).

Reference: ``CredModel`` and its training harness (main.py:609-1025); the
JAX package's ``models/cred_model.py``.  Architecture (thesis Eq
3.12-3.16)::

  h_u0 = user_proj(x_u);  h_i0 = item_proj(x_i)
  w_e  = clamp(beta*clip01(verified) + gamma*rating_align, min=0)   (EWA)
  w~   = w / (sum over destination + 1e-12)          (per-dst normalization)
  h_i1 = relu(item_upd([h_i0 ; sum_e w~ h_u0[src]]))
  h_u2 = relu(user_upd([h_u0 ; sum_e w~ h_i1[item]]))
  cred = sigmoid(out(h_u2))

The full-graph forward runs the two aggregation stages over the whole graph
as weighted segment-sums: each temporal view ("early", "late", or ``None``
for all edges) bakes its normalized weights into two ``ops/spmm``
operators, built once on the host (the weights do not depend on the
parameters).  Gradients flow through the operators' ``_SpmmFn``, whose
backward is the same SpMM kernel on the transpose, so one view's forward
and backward are 2 + 2 kernel applications.  Each view also keeps the plans
of the smoothness term's two gathers (``ops/gather.py``), ``h_u2[src]`` and
``h_i1[dst]``, built from the edges' ids themselves, so they hold for any
operators (on one device they equal the plans of the default operators'
forward CSRs).  ``operator_factory`` puts other operators in place of the
default ones: the mesh's edge-sharded operators
(``parallel/sharded_spmm.py``), as the JAX package's does.

Parameters are a ``Dict[str, Tensor]`` of ``(fan_in, fan_out)`` weights and
``(fan_out,)`` biases, as in the JAX package, so a layer is ``x @ W + b``
and ``ops/adam`` updates the ten leaves one by one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..graph.hetero import HeteroGraph
from ..graph.operators import EdgeMap
from ..ops.gather import GatherPlan, gather_plans
from ..ops.spmm import SpmmOperator
from ..utils.config import CredConfig

Params = Dict[str, torch.Tensor]


def _linear_init(gen: torch.Generator, fan_in: int, fan_out: int):
    """torch.nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    drawn on the generator's device."""
    bound = float(1.0 / np.sqrt(fan_in))

    def uniform(shape):
        u = torch.rand(shape, generator=gen, device=gen.device)
        return u * (2.0 * bound) - bound

    return uniform((fan_in, fan_out)), uniform((fan_out,))


def init_cred_params(gen: torch.Generator, user_in: int, item_in: int,
                     hidden: int) -> Params:
    p = {}
    p["user_proj_w"], p["user_proj_b"] = _linear_init(gen, user_in, hidden)
    p["item_proj_w"], p["item_proj_b"] = _linear_init(gen, item_in, hidden)
    p["item_upd_w"], p["item_upd_b"] = _linear_init(gen, 2 * hidden, hidden)
    p["user_upd_w"], p["user_upd_b"] = _linear_init(gen, 2 * hidden, hidden)
    p["out_w"], p["out_b"] = _linear_init(gen, hidden, 1)
    return p


def cred_params_from_jax(params: Mapping[str, np.ndarray], device) -> Params:
    """The JAX package's CredModel parameters (numpy arrays, same keys and
    shapes) as this package's fp32 tensors on ``device``."""
    return {k: torch.as_tensor(np.array(v, np.float32), device=device)
            for k, v in params.items()}


def ewa_raw_weights(edge_attr: np.ndarray, beta: float = 1.0,
                    gamma: float = 1.0) -> np.ndarray:
    """Eq 3.12 (main.py:674-682): w = clamp(beta*clip01(verified) +
    gamma*rating_align, min=0)."""
    verified = np.clip(edge_attr[:, 0], 0.0, 1.0)
    align = edge_attr[:, 1]
    return np.maximum(beta * verified + gamma * align, 0.0).astype(np.float32)


def temporal_edge_mask(edge_attr: np.ndarray, view: Optional[str],
                       split: float = 0.5) -> np.ndarray:
    """NaN-safe temporal view mask (main.py:816-823): NaN timestamps are in
    NEITHER view, matching numpy NaN-compare semantics."""
    if view is None:
        return np.ones(edge_attr.shape[0], bool)
    tsn = edge_attr[:, 3]
    with np.errstate(invalid="ignore"):
        return (tsn < split) if view == "early" else (tsn >= split)


@dataclass
class CredView:
    """One temporal view: its normalized EWA weights baked into the two
    aggregation operators, and the edge arrays the smoothness term reads."""
    item_from_user: SpmmOperator      # aggregates h_u0 -> items
    user_from_item: SpmmOperator      # aggregates h_i1 -> users
    w_u2i_norm: torch.Tensor          # (E,) fp32 normalized weights
    src: torch.Tensor                 # (E,) int64 user per edge
    dst: torch.Tensor                 # (E,) int64 item per edge
    # the gather plans of h_u2[src] and h_i1[dst]
    smooth_plans: Tuple[GatherPlan, GatherPlan]


def build_cred_view(hg: HeteroGraph, cfg: CredConfig, view: Optional[str],
                    device, backend: str = "auto",
                    operator_factory=None) -> CredView:
    """normalize_per_dst over the view's edges only (masked weights), both
    directions (main.py:680-688), in float64 on the host as the JAX package
    does.  The operators are ``SpmmOperator(edge_map, device, backend)``
    unless ``operator_factory(edge_map)`` builds them; the smoothness
    gathers' plans come from the edges' ids (``ops/gather.gather_plans``)."""
    u = hg.edges[0].astype(np.int64)
    i = hg.edges[1].astype(np.int64)
    w = ewa_raw_weights(hg.edge_attr, cfg.beta, cfg.gamma)
    w = w * temporal_edge_mask(hg.edge_attr, view, cfg.temp_split)

    denom_i = np.zeros(hg.num_items, np.float64)
    np.add.at(denom_i, i, w)
    w_u2i = (w / (denom_i[i] + 1e-12)).astype(np.float32)

    denom_u = np.zeros(hg.num_users, np.float64)
    np.add.at(denom_u, u, w)
    w_i2u = (w / (denom_u[u] + 1e-12)).astype(np.float32)

    if operator_factory is None:
        def operator_factory(em):
            return SpmmOperator(em, device, backend=backend)

    item_from_user = operator_factory(EdgeMap(
        src=u.astype(np.int32), dst=i.astype(np.int32), w=w_u2i,
        num_src=hg.num_users, num_dst=hg.num_items))
    user_from_item = operator_factory(EdgeMap(
        src=i.astype(np.int32), dst=u.astype(np.int32), w=w_i2u,
        num_src=hg.num_items, num_dst=hg.num_users))
    src = torch.as_tensor(u, device=device)
    dst = torch.as_tensor(i, device=device)
    return CredView(
        item_from_user=item_from_user, user_from_item=user_from_item,
        w_u2i_norm=torch.as_tensor(w_u2i, device=device), src=src, dst=dst,
        smooth_plans=(gather_plans(src[None], hg.num_users)[0],
                      gather_plans(dst[None], hg.num_items)[0]),
    )


class CredModel:
    """Full-graph CredModel over the three precomputed views (``None``,
    "early", "late") on ``device``; ``operator_factory(edge_map)`` builds
    the views' operators in place of ``SpmmOperator``."""

    def __init__(self, hg: HeteroGraph, cfg: Optional[CredConfig] = None,
                 device="cuda", backend: str = "auto", operator_factory=None):
        self.cfg = cfg or CredConfig()
        self.hg = hg
        self.device = torch.device(device)
        # NaN features would poison the dense projections; the reference's
        # real dataset has none, so zero-fill is behavior-preserving there.
        self.user_x = torch.as_tensor(np.nan_to_num(hg.user_x, nan=0.0),
                                      device=self.device)
        self.item_x = torch.as_tensor(np.nan_to_num(hg.item_x, nan=0.0),
                                      device=self.device)
        self.views = {
            v: build_cred_view(hg, self.cfg, v, self.device, backend,
                               operator_factory)
            for v in (None, "early", "late")
        }

    def forward(self, params: Params, view: Optional[str]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(cred (U,), h_u2 (U,H), h_i1 (I,H)): ``forward_subgraph``
        (main.py:690-707) on the full graph through the view's operators."""
        v = self.views[view]
        h_u0 = self.user_x @ params["user_proj_w"] + params["user_proj_b"]
        h_i0 = self.item_x @ params["item_proj_w"] + params["item_proj_b"]

        m_i = v.item_from_user(h_u0)
        h_i1 = torch.relu(torch.cat([h_i0, m_i], dim=-1)
                          @ params["item_upd_w"] + params["item_upd_b"])

        m_u = v.user_from_item(h_i1)
        h_u2 = torch.relu(torch.cat([h_u0, m_u], dim=-1)
                          @ params["user_upd_w"] + params["user_upd_b"])

        cred = torch.sigmoid(
            (h_u2 @ params["out_w"] + params["out_b"]).squeeze(-1))
        return cred, h_u2, h_i1

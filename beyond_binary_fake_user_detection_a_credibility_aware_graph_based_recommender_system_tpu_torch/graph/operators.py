"""Per-edge propagation weight recipes.

Every propagation variant in the reference family reduces to "weighted
segment-sum with a precomputed per-edge scalar" — the four weight recipes
below (SURVEY.md C16-C19) all feed the same SpMM kernel:

  * symmetric  — D^-1/2 A D^-1/2 over the joint (U+I) graph
                 (reference lightgcn.py:352-372)
  * cred_eq322 — thesis Eq 3.23/3.24 asymmetric bipartite operators
                 (reference lightgcn_cu.py:368-399)
  * cu_message — cred-in-message bipartite operators with max(deg,1) clamp
                 (reference version_1/lightgcn_cu_message.py:347-385)
  * degree_aware — cu_message * alpha_i, alpha_i = 1/log1p(max(deg_i,1))
                 (reference version_1/lightgcn_cu_pop_Degree-Aware Message.py:349-403)

Parity trap (SURVEY.md §7): cred_eq322 guards the normalizer with
sqrt(max(deg_u*deg_i, 1e-12)) while cu_message clamps each degree to
max(deg, 1) — these are deliberately kept distinct.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .build import BipartiteGraph
from .csr import degrees_from_edges


@dataclass
class EdgeMap:
    """A sparse linear operator y[dst] += w[e] * x[src[e]].

    Plain numpy on the host; the ops layer turns it into a device SpMM plan.
    """

    src: np.ndarray          # (E,) int32 indices into the source space
    dst: np.ndarray          # (E,) int32 indices into the destination space
    w: np.ndarray            # (E,) float32
    num_src: int
    num_dst: int

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def to_dense(self) -> np.ndarray:
        """Dense (num_dst, num_src) matrix — test oracle only."""
        m = np.zeros((self.num_dst, self.num_src), dtype=np.float64)
        np.add.at(m, (self.dst, self.src), self.w.astype(np.float64))
        return m


def symmetric_norm_edge_map(graph: BipartiteGraph) -> EdgeMap:
    """Joint symmetric normalized adjacency over N = U + I nodes.

    A[u, U+i] = A[U+i, u] = 1; w = deg_r^-1/2 * deg_c^-1/2 with inf -> 0
    (lightgcn.py:352-372).  Items are offset by num_users, matching the
    single joint embedding table layout (lightgcn.py:315).
    """
    U, I = graph.num_users, graph.num_items
    u = graph.train_edges[0].astype(np.int64)
    it = graph.train_edges[1].astype(np.int64) + U

    row = np.concatenate([u, it])
    col = np.concatenate([it, u])
    N = U + I
    # each (r, c) appears once in row and once in col, so bincount(row) alone
    # equals the symmetric degree:
    deg = np.bincount(row, minlength=N).astype(np.float64)
    with np.errstate(divide="ignore"):
        dinv = 1.0 / np.sqrt(deg)
    dinv[~np.isfinite(dinv)] = 0.0
    w = (dinv[row] * dinv[col]).astype(np.float32)
    return EdgeMap(src=col.astype(np.int32), dst=row.astype(np.int32), w=w,
                   num_src=N, num_dst=N)


def _bipartite_degrees(graph: BipartiteGraph) -> Tuple[np.ndarray, np.ndarray]:
    return (degrees_from_edges(graph.train_edges[0], graph.num_users),
            degrees_from_edges(graph.train_edges[1], graph.num_items))


def cred_eq322_edge_maps(graph: BipartiteGraph,
                         cred: np.ndarray) -> Tuple[EdgeMap, EdgeMap]:
    """Thesis Eq 3.23/3.24 operators (lightgcn_cu.py:368-399).

    Returns (item_from_user, user_from_item):
      item<-user: w = cred[u] / sqrt(max(deg_u*deg_i, 1e-12))
      user<-item: w = 1      / sqrt(max(deg_u*deg_i, 1e-12))
    """
    u = graph.train_edges[0].astype(np.int64)
    i = graph.train_edges[1].astype(np.int64)
    deg_u, deg_i = _bipartite_degrees(graph)
    denom = np.sqrt(np.maximum(deg_u[u] * deg_i[i], 1e-12)).astype(np.float32)
    cred = np.asarray(cred, dtype=np.float32)
    item_from_user = EdgeMap(src=u.astype(np.int32), dst=i.astype(np.int32),
                             w=(cred[u] / denom).astype(np.float32),
                             num_src=graph.num_users, num_dst=graph.num_items)
    user_from_item = EdgeMap(src=i.astype(np.int32), dst=u.astype(np.int32),
                             w=(1.0 / denom).astype(np.float32),
                             num_src=graph.num_items, num_dst=graph.num_users)
    return item_from_user, user_from_item


def message_edge_maps(graph: BipartiteGraph, cred: np.ndarray,
                      degree_damping: bool = False) -> Tuple[EdgeMap, EdgeMap]:
    """Cred-in-message operators (version_1/lightgcn_cu_message.py:347-385),
    optionally with Method A degree-aware damping
    (version_1/..._Degree-Aware Message.py:349-403).

    Returns (item_from_user, user_from_item):
      base      w = 1/sqrt(max(deg_u,1)) * 1/sqrt(max(deg_i,1))
      item<-user: w_base * cred[u]            [* alpha_i if damping]
      user<-item: w_base                       [* alpha_i if damping]
      alpha_i = 1 / log1p(max(deg_i, 1))
    """
    u = graph.train_edges[0].astype(np.int64)
    i = graph.train_edges[1].astype(np.int64)
    deg_u, deg_i = _bipartite_degrees(graph)
    inv_sqrt_u = 1.0 / np.sqrt(np.maximum(deg_u, 1.0))
    inv_sqrt_i = 1.0 / np.sqrt(np.maximum(deg_i, 1.0))
    w_base = (inv_sqrt_u[u] * inv_sqrt_i[i]).astype(np.float32)
    if degree_damping:
        alpha_i = (1.0 / np.log1p(np.maximum(deg_i, 1.0))).astype(np.float32)
        w_base = w_base * alpha_i[i]
    cred = np.asarray(cred, dtype=np.float32)
    item_from_user = EdgeMap(src=u.astype(np.int32), dst=i.astype(np.int32),
                             w=(cred[u] * w_base).astype(np.float32),
                             num_src=graph.num_users, num_dst=graph.num_items)
    user_from_item = EdgeMap(src=i.astype(np.int32), dst=u.astype(np.int32),
                             w=w_base.astype(np.float32),
                             num_src=graph.num_items, num_dst=graph.num_users)
    return item_from_user, user_from_item


def build_edge_maps(graph: BipartiteGraph, weight_mode: str,
                    cred: Optional[np.ndarray] = None):
    """Dispatch table from RecConfig.weight_mode to edge maps.

    Returns either a single joint EdgeMap ("symmetric") or the
    (item_from_user, user_from_item) pair.
    """
    if cred is None:
        cred = np.ones(graph.num_users, dtype=np.float32)
    if weight_mode == "symmetric":
        return symmetric_norm_edge_map(graph)
    if weight_mode == "cred_eq322":
        return cred_eq322_edge_maps(graph, cred)
    if weight_mode == "cu_message":
        return message_edge_maps(graph, cred, degree_damping=False)
    if weight_mode == "degree_aware":
        return message_edge_maps(graph, cred, degree_damping=True)
    raise ValueError(f"Unknown weight_mode {weight_mode!r}")

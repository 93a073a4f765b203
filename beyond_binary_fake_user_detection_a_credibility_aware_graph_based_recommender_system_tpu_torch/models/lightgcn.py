"""LightGCN model family (Stage B): propagation and scoring.

One parameterized module covers all reference variants:

  * vanilla joint-adjacency LightGCN          reference lightgcn.py:306-349
  * CredLightGCN, synchronous (Jacobi) bipartite updates, Eq 3.22–3.26
                                              reference lightgcn_cu.py:405-463
  * cred-in-message Gauss-Seidel bipartite updates
                                 reference version_1/lightgcn_cu_message.py:391-452

Parity-critical semantics, as in the JAX package:
  * "bipartite_sync": e_i^{k+1} = A_iu e_u^k and e_u^{k+1} = A_ui e_i^k —
    the user update consumes the *previous* item layer;
  * "gauss_seidel": e_i^{k+1} = A_iu e_u^k then e_u^{k+1} = A_ui e_i^{k+1} —
    the user update consumes the *fresh* item layer;
  * final embeddings are the mean over layers 0..K (inclusive of layer 0);
  * Xavier-uniform init on an (N, D) table: limit = sqrt(6 / (N + D)).

bf16 precision: the ego tables are cast to bf16 once, every SpMM runs on
bf16 messages with fp32 per-destination sums, the layer mean accumulates in
fp32, and fp32 tables come back.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..graph.build import BipartiteGraph
from ..graph.operators import EdgeMap, build_edge_maps
from ..ops.gather import GatherPlan, gather_rows
from ..ops.segment_plan import PadLayout
from ..ops.spmm import SpmmOperator
from ..utils.config import RecConfig, kernel_backend

Params = Dict[str, torch.Tensor]


def xavier_uniform(gen: torch.Generator, shape: Tuple[int, int],
                   dtype=torch.float32) -> torch.Tensor:
    """torch.nn.init.xavier_uniform_ on a 2-D (fan_out, fan_in) tensor,
    drawn on the generator's device."""
    fan_out, fan_in = shape
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)
    return u * (2.0 * limit) - limit


def init_params(gen: torch.Generator, cfg: RecConfig, num_users: int,
                num_items: int) -> Params:
    """"joint" = one (U+I, D) table (lightgcn.py:315);
    "split" = separate user/item tables (lightgcn_cu.py:415-418)."""
    if cfg.table_layout == "joint":
        return {"emb": xavier_uniform(gen, (num_users + num_items,
                                            cfg.emb_dim))}
    return {"user_emb": xavier_uniform(gen, (num_users, cfg.emb_dim)),
            "item_emb": xavier_uniform(gen, (num_items, cfg.emb_dim))}


def params_from_jax(params: Mapping[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter dict (as numpy arrays, same keys: "emb",
    or "user_emb" and "item_emb") as this package's tensors on ``device``."""
    return {k: torch.as_tensor(np.array(v), device=device)
            for k, v in params.items()}


def ego_tables(params: Params, num_users: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer-0 (ego) user/item tables regardless of layout."""
    if "emb" in params:
        return params["emb"][:num_users], params["emb"][num_users:]
    return params["user_emb"], params["item_emb"]


class LightGCN:
    """Propagation + scoring for one Stage-B configuration.

    Construction turns the edge-weight recipe into SpmmOperator(s) on
    ``device``; ``propagate(params)`` returns the layer-averaged
    (user_emb, item_emb).
    """

    def __init__(self, cfg: RecConfig, graph: BipartiteGraph,
                 cred: Optional[np.ndarray] = None, device="cuda",
                 operator_factory=None):
        """``operator_factory(edge_map) -> operator`` lets the same model run
        on single-device ``SpmmOperator``s (default, on ``cfg.spmm_backend``:
        under "chunked" on chunk plans, whose padded chain
        :meth:`_padded_chain` takes) or mesh-sharded ones
        (``parallel/sharded_spmm.ShardedSpmmOperator`` via
        ``functools.partial``)."""
        cfg.validate()
        self.cfg = cfg
        self.num_users = graph.num_users
        self.num_items = graph.num_items
        self.device = torch.device(device)

        if operator_factory is None:
            def operator_factory(em):
                return SpmmOperator(em, self.device,
                                    backend=cfg.spmm_backend,
                                    precision=cfg.spmm_precision)

        maps = build_edge_maps(graph, cfg.weight_mode, cred)
        if cfg.propagation == "symmetric":
            assert isinstance(maps, EdgeMap)
            self.joint_op = operator_factory(maps)
            self.item_from_user = self.user_from_item = None
        else:
            item_from_user_map, user_from_item_map = maps
            self.item_from_user = operator_factory(item_from_user_map)
            self.user_from_item = operator_factory(user_from_item_map)
            self.joint_op = None

    # -- propagation ------------------------------------------------------

    def _prop_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.cfg.spmm_precision == "bf16"
                else torch.float32)

    def _joint_table(self, params: Params) -> torch.Tensor:
        if "emb" in params:
            return params["emb"]
        return torch.cat([params["user_emb"], params["item_emb"]], dim=0)

    def _padded_chain(self):
        """Chunked operators expose tail-padded ``PadLayout``s and
        mesh-sharded ones padded span layouts (``parallel/sharded_spmm.py``);
        when the chain's layouts line up, the whole K-layer propagation
        stays in padded form (row-sharded on a mesh) and converts
        dense<->padded once per table and call instead of once per
        operator."""
        if self.cfg.propagation == "symmetric":
            op = self.joint_op
            if getattr(op, "padded_chain", False) and \
                    op.src_layout.equals(op.dst_layout):
                return op
            return None
        a, b = self.item_from_user, self.user_from_item
        if (getattr(a, "padded_chain", False)
                and getattr(b, "padded_chain", False)
                and a.dst_layout.equals(b.src_layout)
                and b.dst_layout.equals(a.src_layout)):
            return (a, b)
        return None

    def gather_table_rows(self) -> Tuple[int, int]:
        """The rows of the user and of the item tables whose rows
        :meth:`propagate_rows` gathers with a step's plans: the padded
        tables of a single-device bipartite chain, else the exact ones
        (the joint chain reads the exact-row views of its padded table; a
        mesh's chain takes no plans)."""
        chain = self._padded_chain()
        if (chain is None or self.cfg.propagation == "symmetric"
                or not isinstance(chain[0].src_layout, PadLayout)):
            return self.num_users, self.num_items
        return chain[0].src_layout.padded_rows, chain[1].src_layout.padded_rows

    def _bipartite_step(self, u: torch.Tensor, i: torch.Tensor,
                        apply_ifu=None, apply_ufi=None):
        apply_ifu = apply_ifu or self.item_from_user
        apply_ufi = apply_ufi or self.user_from_item
        if self.cfg.propagation == "bipartite_sync":
            # Jacobi: both updates read layer k (lightgcn_cu.py:429-439)
            return apply_ufi(i), apply_ifu(u)
        # gauss_seidel (lightgcn_cu_message.py:421-423)
        i = apply_ifu(u)
        return apply_ufi(i), i

    def propagate(self, params: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        K = self.cfg.num_layers
        prop_dtype = self._prop_dtype()
        chain = self._padded_chain()
        if self.cfg.propagation == "symmetric":
            x = self._joint_table(params).to(prop_dtype)
            apply_j = self.joint_op
            if chain is not None:
                x = chain.src_layout.to_padded(x)
                apply_j = chain.apply_padded
            acc = x.float()
            for _ in range(K):
                x = apply_j(x)
                acc = acc + x.float()
            final = acc / (K + 1)
            if chain is not None:
                final = chain.src_layout.from_padded(final)
            return final[:self.num_users], final[self.num_users:]

        u, i = ego_tables(params, self.num_users)
        u = u.to(prop_dtype)
        i = i.to(prop_dtype)
        applies = ()
        if chain is not None:
            ifu, ufi = chain
            u = ifu.src_layout.to_padded(u)
            i = ufi.src_layout.to_padded(i)
            applies = (ifu.apply_padded, ufi.apply_padded)
        acc_u, acc_i = u.float(), i.float()
        for _ in range(K):
            u, i = self._bipartite_step(u, i, *applies)
            acc_u = acc_u + u.float()
            acc_i = acc_i + i.float()
        acc_u, acc_i = acc_u / (K + 1), acc_i / (K + 1)
        if chain is not None:
            acc_u = ifu.src_layout.from_padded(acc_u)
            acc_i = ufi.src_layout.from_padded(acc_i)
        return acc_u, acc_i

    def propagate_rows(self, params: Params, user_rows: torch.Tensor,
                       item_rows: torch.Tensor,
                       plans: Optional[Tuple[GatherPlan, GatherPlan]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer-mean embeddings for SELECTED rows only.

        Row-gather commutes with the per-layer accumulation bit-exactly
        (``(sum_k x_k)[r] == sum_k x_k[r]`` elementwise, same fp order), so
        a caller that needs a few rows skips the full-size combined tables.
        ``plans`` (of ``user_rows`` and ``item_rows`` into the tables of
        :meth:`gather_table_rows` rows, ``ops/gather.py``) give every
        layer's gathers the segment-sum backward; without them they are
        plain ``x[rows]``.

        On chunked operators whose tail-padded layouts chain the layers stay
        in padded form and each layer's rows are read from the padded
        tables (``PadLayout.rows_of``, a row's slot is the row; the joint
        table through its exact-row views).  On mesh-sharded operators whose
        span layouts chain each layer's rows are read at their slots of the
        whole padded table (``SpanLayout.rows_of``: row -> slot through
        ``fwd``, the JAX package's ``_slot``); ``plans`` do not apply there.
        The sharded train step does not come here: it combines whole tables,
        as the JAX package's mesh path does.
        """
        K = self.cfg.num_layers
        prop_dtype = self._prop_dtype()
        p_u, p_i = plans or (None, None)
        bk = kernel_backend(self.cfg.spmm_backend)
        chain = self._padded_chain()

        def rows(u, i):
            return (gather_rows(u, user_rows, p_u, bk).float(),
                    gather_rows(i, item_rows, p_i, bk).float())

        U = self.num_users
        if self.cfg.propagation == "symmetric":
            x = self._joint_table(params).to(prop_dtype)
            apply_j = self.joint_op

            def rows_j(x):
                return rows(x[:U], x[U:U + self.num_items])
            if chain is not None:
                lay = chain.src_layout
                x = lay.to_padded(x)
                apply_j = chain.apply_padded
                if not isinstance(lay, PadLayout):
                    ids = torch.cat([user_rows, item_rows + U])

                    def rows_j(x):
                        r = lay.rows_of(x, ids).float()
                        return r[:user_rows.numel()], r[user_rows.numel():]
            au, ai = rows_j(x)
            for _ in range(K):
                x = apply_j(x)
                ru, ri = rows_j(x)
                au, ai = au + ru, ai + ri
            return au / (K + 1), ai / (K + 1)

        u, i = ego_tables(params, U)
        u = u.to(prop_dtype)
        i = i.to(prop_dtype)
        applies, read = (), rows
        if chain is not None:
            ifu, ufi = chain
            u = ifu.src_layout.to_padded(u)
            i = ufi.src_layout.to_padded(i)
            applies = (ifu.apply_padded, ufi.apply_padded)
            lu, li = ifu.src_layout, ufi.src_layout
            if isinstance(lu, PadLayout):
                def read(u, i):
                    return (lu.rows_of(u, user_rows, p_u, bk).float(),
                            li.rows_of(i, item_rows, p_i, bk).float())
            else:
                def read(u, i):
                    return (lu.rows_of(u, user_rows).float(),
                            li.rows_of(i, item_rows).float())
        au, ai = read(u, i)
        for _ in range(K):
            u, i = self._bipartite_step(u, i, *applies)
            ru, ri = read(u, i)
            au, ai = au + ru, ai + ri
        return au / (K + 1), ai / (K + 1)

    # -- scoring ----------------------------------------------------------

    @staticmethod
    def score(user_emb: torch.Tensor, item_emb: torch.Tensor,
              users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        """Eq 3.26: dot-product (lightgcn_cu.py:450-454)."""
        return torch.sum(user_emb[users] * item_emb[items], dim=-1)

    @staticmethod
    def score_all_items(user_emb: torch.Tensor, item_emb: torch.Tensor,
                        users: torch.Tensor) -> torch.Tensor:
        """(B, I) dense scores for full-catalog evaluation
        (lightgcn.py:483)."""
        return user_emb[users] @ item_emb.T

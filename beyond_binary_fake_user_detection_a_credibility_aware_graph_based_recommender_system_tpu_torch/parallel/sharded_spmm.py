"""Edge-sharded SpMM over the model axis of a device mesh.

The port of ``JAX: parallel/sharded_spmm.py``, with the same host plans:

  * **Edge-count-balanced spans.**  Each node space is cut into P
    contiguous row spans of about equal edge count (:func:`balanced_spans`)
    and embedded in a *padded span layout* (:class:`SpanLayout`): P blocks
    of ``rows_max`` slots, rank d's block holding its span and then zeros.
    A padded table is row-sharded: each rank holds its ``rows_max`` slots.
  * **Each rank owns the edges that land in its destination span**, sorted
    by destination slot (stably, so a row's edges keep their input order).
  * **Source exchange**, one collective over the model group per apply:
    "allgather" gathers the whole padded source table
    (``all_gather_into_tensor``); "halo" ships only the rows each receiver
    needs (``index_select`` of the precomputed per-receiver lists, then one
    ``all_to_all_single``); "auto" picks per direction by volume.
  * **The local sum is the port's SpMM kernel** (K1/K2,
    ``csrc/segment_spmm.cu`` through ``ops/spmm_cuda.segment_spmm``,
    counted as ``sharded_spmm``) on the rank's edges as a destination CSR
    with its long-row pieces.  The JAX package sums with XLA's
    ``segment_sum``; its stock counterparts here would be the atomic
    ``index_add_`` (not reproducible) or the sorted ``index_put_``.  A
    destination row's edges sit on its owner rank in the order the
    single-device ``SpmmOperator`` sums them, with the same pieces, so a
    sharded apply equals the single-device one bit for bit.
  * **Backward** is the transpose plan's own apply, with its own exchange,
    on the cotangent (``ops/spmm._SpmmFn``, as on one device); no autograd
    runs through a collective, and no backward scatters.
  * **Order.**  The kernels take PyTorch's current stream; a collective
    called without ``async_op`` starts after the work queued there and
    the stream waits for it, so exchanges and sums keep one order.

Layouts derive from edge degrees alone, so the two directions of a
bipartite model give equal layouts per node space and a K-layer chain stays
in padded form (``models/lightgcn.py``).

Autograd contract: :meth:`SpanLayout.from_padded` returns the exact-row
table on every rank, and its backward takes the rank's slots of a
cotangent *replicated within the model group*: every rank of one model group
must compute the same loss (on the same batch columns).  Data replicas may
compute different losses; the train step reduces their gradients over the
data axis on the parameter blocks (``parallel/sharding.py``), not here.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..graph.operators import EdgeMap
from ..ops.spmm import _MSG_DTYPES, CsrDirection, _SpmmFn
from ..ops.spmm_cuda import SHARDED_KERNEL, segment_spmm
from .mesh import ModelAxis, model_axis, row_shard


def _all_gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``all_gather_into_tensor`` (present in every torch this package
    runs on; newer releases mark it deprecated)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x, group=group)


def _need_group(axis: ModelAxis) -> None:
    if axis.group is None:
        raise RuntimeError("this ModelAxis has no process group: it plans on "
                           "the host only; build the operator on a mesh")


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, axis):
        _need_group(axis)
        ctx.axis = axis
        full = block.new_empty((axis.size * block.shape[0],)
                               + tuple(block.shape[1:]))
        _all_gather_into(full, block.contiguous(), axis.group)
        return full

    @staticmethod
    def backward(ctx, g):
        return row_shard(g, ctx.axis), None


def all_gather_rows(block: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Every model rank's ``block`` stacked in coordinate order, on every
    rank of the model group.  Its backward is this rank's block of the
    cotangent, with no collective: right when the cotangent is replicated
    within the model group (the contract below)."""
    return _AllGatherRows.apply(block, axis)


# ---------------------------------------------------------------------------
# Padded span layout of a node space
# ---------------------------------------------------------------------------

def balanced_spans(weights: np.ndarray, n_dev: int) -> np.ndarray:
    """(P+1,) span boundaries with ~equal total weight per span.

    A small uniform weight floor spreads zero-degree rows instead of piling
    them into the last span.
    """
    n = weights.shape[0]
    w = weights.astype(np.float64) + max(weights.sum() / max(n, 1), 1.0) * 0.05
    cum = np.concatenate([[0.0], np.cumsum(w)])
    targets = cum[-1] * np.arange(1, n_dev) / n_dev
    cuts = np.searchsorted(cum, targets, side="left")
    bounds = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    return np.maximum.accumulate(bounds)   # enforce monotone under ties


class SpanLayout:
    """Padded span layout: N rows -> (P * rows_max) slots, row-sharded over
    the model axis (rank d holds slots ``d * rows_max`` onwards).

    ``fwd`` (row -> slot), ``inv`` (slot -> row, pad -> 0) and ``mask``
    ((padded_rows, 1), 1 on real slots) are the global host maps; the rank
    keeps on its device ``fwd`` and its own block of ``inv`` and ``mask``.
    """

    def __init__(self, boundaries: np.ndarray, mesh):
        axis = model_axis(mesh)
        self.axis = axis
        self.P = axis.size
        if boundaries.shape[0] != self.P + 1:
            raise ValueError(f"{boundaries.shape[0]} boundaries for "
                             f"{self.P} spans")
        self.boundaries = boundaries.astype(np.int64)
        self.num_rows = int(boundaries[-1])
        spans = np.diff(self.boundaries)
        self.rows_max = max(int(spans.max()), 1)
        self.padded_rows = self.P * self.rows_max

        rows = np.arange(self.num_rows, dtype=np.int64)
        dev = np.searchsorted(self.boundaries, rows, side="right") - 1
        fwd = dev * self.rows_max + (rows - self.boundaries[dev])
        inv = np.zeros(self.padded_rows, np.int64)
        mask = np.zeros(self.padded_rows, bool)
        inv[fwd] = rows
        mask[fwd] = True
        self.fwd = fwd.astype(np.int32)
        self.inv = inv.astype(np.int32)
        self.mask = mask.astype(np.float32)[:, None]

        mine = slice(axis.coord * self.rows_max,
                     (axis.coord + 1) * self.rows_max)
        self._fwd_dev = torch.as_tensor(fwd, device=axis.device)
        self._inv_local = torch.as_tensor(inv[mine], device=axis.device)
        self._mask_local = torch.as_tensor(self.mask[mine],
                                           device=axis.device)

    def equals(self, other: "SpanLayout") -> bool:
        return (other is self or
                np.array_equal(self.boundaries, other.boundaries))

    def slot_of(self, rows: np.ndarray) -> np.ndarray:
        """Host-side global row -> padded slot."""
        return self.fwd[rows]

    # the two conversions are a dual pair of gathers: each one's backward
    # is the other's forward (never a scatter)
    def to_padded(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated (N, D) table -> this rank's (rows_max, D) slots."""
        return _ToPadded.apply(x, self)

    def from_padded(self, p: torch.Tensor) -> torch.Tensor:
        """This rank's (rows_max, D) slots -> the (N, D) table, on every
        rank of the model group."""
        return _FromPadded.apply(p, self)

    def rows_of(self, p: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """The rows ``rows`` (global row ids, on the layout's device) of the
        table whose padded shard is ``p``, on every rank of the model group:
        the whole padded table's slots ``fwd[rows]``.  Differentiable in
        ``p`` under the same contract as :meth:`from_padded` (the slots'
        gradient is summed by the stock ``index_select`` backward)."""
        self._check_shard(p)
        return all_gather_rows(p, self.axis).index_select(
            0, self._fwd_dev[rows])

    def _local_slots(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != self.num_rows:
            raise ValueError(f"table has {x.shape[0]} rows, layout holds "
                             f"{self.num_rows}")
        return (x.index_select(0, self._inv_local)
                * self._mask_local.to(x.dtype))

    def _check_shard(self, p: torch.Tensor) -> None:
        if p.shape[0] != self.rows_max:
            raise ValueError(f"padded shard has {p.shape[0]} rows, layout "
                             f"holds {self.rows_max} a rank")

    def _rows(self, p: torch.Tensor) -> torch.Tensor:
        self._check_shard(p)
        _need_group(self.axis)
        full = p.new_empty((self.padded_rows,) + tuple(p.shape[1:]))
        _all_gather_into(full, p.contiguous(), self.axis.group)
        return full.index_select(0, self._fwd_dev)


class _ToPadded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return layout._local_slots(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout._rows(g), None


class _FromPadded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, layout):
        ctx.layout = layout
        return layout._rows(p)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout._local_slots(g), None


# ---------------------------------------------------------------------------
# One direction's plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _DirPlan:
    """The (P, e_max) stacked plan of one direction, on the host (the JAX
    package's arrays, element for element)."""
    src_ref: np.ndarray    # (P, e_max) int32 — padded-slot (allgather) or
    #                        recv-buffer (halo) index per edge; pad -> 0
    dst_local: np.ndarray  # (P, e_max) int32 local dst slot (pad -> rows_max)
    w: np.ndarray          # (P, e_max) float32 (pad -> 0)
    send_idx: Optional[np.ndarray]   # (P, P, H_max) int32 local slots to ship
    e_max: int
    h_max: int
    pad_fraction: float
    edge_counts: tuple     # per-device real (unpadded) edge counts


def _plan_dir(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
              src_layout: SpanLayout, dst_layout: SpanLayout,
              mode: str) -> _DirPlan:
    n_dev = dst_layout.P
    E = src.shape[0]
    src_slot = src_layout.slot_of(src)
    dst_slot = dst_layout.slot_of(dst)
    owner = dst_slot // dst_layout.rows_max
    order = np.lexsort((dst_slot, owner))
    src_slot, dst_slot, w, owner = (src_slot[order], dst_slot[order],
                                    w[order], owner[order])

    counts = np.bincount(owner, minlength=n_dev)
    e_max = max(int(counts.max()), 1)
    pad_fraction = float(n_dev * e_max - E) / max(n_dev * e_max, 1)
    starts = np.zeros(n_dev + 1, np.int64)
    np.cumsum(counts, out=starts[1:])

    src_ref = np.zeros((n_dev, e_max), np.int32)
    dst_loc = np.full((n_dev, e_max), dst_layout.rows_max, np.int32)
    w_p = np.zeros((n_dev, e_max), np.float32)
    for d in range(n_dev):
        s, e = starts[d], starts[d + 1]
        k = e - s
        dst_loc[d, :k] = dst_slot[s:e] - d * dst_layout.rows_max
        w_p[d, :k] = w[s:e]

    send_idx = None
    h_max = 1
    if mode == "allgather":
        for d in range(n_dev):
            s, e = starts[d], starts[d + 1]
            src_ref[d, :e - s] = src_slot[s:e]
    else:
        # phase 1: per (owner o, receiver d) unique local row lists + ranks
        uniq_lists = {}
        ranks = [None] * n_dev           # per receiver: (owner, rank) arrays
        for d in range(n_dev):
            s, e = starts[d], starts[d + 1]
            ss = src_slot[s:e]
            so = ss // src_layout.rows_max
            sl = ss - so * src_layout.rows_max
            rank = np.zeros(e - s, np.int64)
            for o in range(n_dev):
                sel = so == o
                uniq, inverse = np.unique(sl[sel], return_inverse=True)
                uniq_lists[(o, d)] = uniq
                rank[sel] = inverse
                h_max = max(h_max, int(uniq.size))
            ranks[d] = (so, rank)
        # phase 2: recv-buffer index = owner * h_max + rank
        for d in range(n_dev):
            s, e = starts[d], starts[d + 1]
            so, rank = ranks[d]
            src_ref[d, :e - s] = (so * h_max + rank).astype(np.int32)
        send_idx = np.zeros((n_dev, n_dev, h_max), np.int32)
        for (o, d), u in uniq_lists.items():
            if u.size:
                send_idx[o, d, :u.size] = u

    return _DirPlan(src_ref=src_ref, dst_local=dst_loc, w=w_p,
                    send_idx=send_idx, e_max=e_max, h_max=h_max,
                    pad_fraction=pad_fraction,
                    edge_counts=tuple(int(c) for c in counts))


@dataclass(frozen=True)
class _LocalDir:
    """One direction as this rank runs it: its real edges as a CSR over its
    ``rows_max`` destination slots (sources index the exchanged buffer) and,
    in halo mode, the rows it ships to each receiver."""
    mode: str
    csr: CsrDirection
    src_rows_max: int          # the rows of a padded source shard
    send_idx: Optional[torch.Tensor]   # (P * h_max,) int64, halo only


def _local_dir(plan: _DirPlan, mode: str, src_layout: SpanLayout,
               dst_layout: SpanLayout, axis: ModelAxis) -> _LocalDir:
    d = axis.coord
    k = plan.edge_counts[d]
    num_src = (src_layout.padded_rows if mode == "allgather"
               else axis.size * plan.h_max)
    csr = CsrDirection.from_edges(plan.src_ref[d, :k], plan.dst_local[d, :k],
                                  plan.w[d, :k], num_src, dst_layout.rows_max,
                                  axis.device)
    send = None
    if mode == "halo":
        send = torch.as_tensor(plan.send_idx[d].reshape(-1).astype(np.int64),
                               device=axis.device)
    return _LocalDir(mode=mode, csr=csr, src_rows_max=src_layout.rows_max,
                     send_idx=send)


# ---------------------------------------------------------------------------
# The operator
# ---------------------------------------------------------------------------

class ShardedSpmmOperator:
    """y = A @ x over the mesh's model axis with edge-balanced spans.

    ``apply(x)`` is dense-to-dense (layout conversions inside);
    ``apply_padded`` chains in padded layout (``models/lightgcn.py`` uses
    it to convert once per propagate instead of once per operator).
    ``backend`` and ``precision`` are ``SpmmOperator``'s.
    """

    padded_chain = True

    def __init__(self, edge_map: EdgeMap, mesh, mode: str = "auto",
                 backend: str = "auto", precision: str = "fp32"):
        """``mesh``: a ``DeviceMesh`` (or a :class:`~.mesh.ModelAxis`, which
        plans without a process group).  ``mode``: "halo" (all-to-all of
        needed rows), "allgather", or "auto" — pick per DIRECTION by
        comparing the halo's P*P*h_max row-slot volume against the
        all-gather's (P-1)*padded_rows."""
        if mode not in ("halo", "allgather", "auto"):
            raise ValueError(f"unknown sharded SpMM mode {mode!r}")
        if precision not in _MSG_DTYPES:
            raise ValueError(f"unknown precision {precision!r}")
        axis = model_axis(mesh)
        self.axis = axis
        self.mode = mode
        self.backend = backend
        self.precision = precision
        self.num_src = edge_map.num_src
        self.num_dst = edge_map.num_dst
        n_dev = axis.size

        src_layout = SpanLayout(balanced_spans(
            np.bincount(edge_map.src, minlength=edge_map.num_src), n_dev),
            axis)
        dst_layout = SpanLayout(balanced_spans(
            np.bincount(edge_map.dst, minlength=edge_map.num_dst), n_dev),
            axis)
        self.src_layout = src_layout
        self.dst_layout = dst_layout

        def plan_one(src, dst, w, sl, dl):
            """Returns (plan, mode, halo_h_max_considered).  In auto mode
            the halo plan is always built for the volume comparison; its
            true h_max is kept even when allgather wins (the allgather plan
            reports a placeholder h_max=1)."""
            if mode != "auto":
                p = _plan_dir(src, dst, w, sl, dl, mode)
                return p, mode, (p.h_max if mode == "halo" else None)
            p = _plan_dir(src, dst, w, sl, dl, "halo")
            if n_dev * n_dev * p.h_max <= (n_dev - 1) * sl.padded_rows:
                return p, "halo", p.h_max
            return _plan_dir(src, dst, w, sl, dl, "allgather"), \
                "allgather", p.h_max

        fwd, self._fwd_mode, fwd_halo_h_max = plan_one(
            edge_map.src, edge_map.dst, edge_map.w, src_layout, dst_layout)
        bwd, self._bwd_mode, bwd_halo_h_max = plan_one(
            edge_map.dst, edge_map.src, edge_map.w, dst_layout, src_layout)
        self.pad_fraction = fwd.pad_fraction
        # the forward exchange's row-slots of width D an apply
        self.collective_rows = (n_dev * n_dev * fwd.h_max
                                if self._fwd_mode == "halo"
                                else (n_dev - 1) * src_layout.padded_rows)
        self.stats = {
            "mode": mode, "fwd_mode": self._fwd_mode,
            "bwd_mode": self._bwd_mode, "n_devices": int(n_dev),
            "num_src": self.num_src, "num_dst": self.num_dst,
            "num_edges": int(sum(fwd.edge_counts)),
            "src_padded_rows": src_layout.padded_rows,
            "dst_padded_rows": dst_layout.padded_rows,
            "fwd": {"edge_counts": list(fwd.edge_counts),
                    "e_max": fwd.e_max, "pad_fraction": fwd.pad_fraction,
                    "h_max": fwd.h_max,
                    "halo_h_max_considered": fwd_halo_h_max},
            "bwd": {"edge_counts": list(bwd.edge_counts),
                    "e_max": bwd.e_max, "pad_fraction": bwd.pad_fraction,
                    "h_max": bwd.h_max,
                    "halo_h_max_considered": bwd_halo_h_max},
            # per-application collective volume in row-slots of width D;
            # halo_rows uses the true halo h_max
            "halo_rows": int(n_dev * n_dev * (
                fwd_halo_h_max if fwd_halo_h_max is not None
                else fwd.h_max)),
            "allgather_rows": int((n_dev - 1) * src_layout.padded_rows),
        }
        self.fwd = _local_dir(fwd, self._fwd_mode, src_layout, dst_layout,
                              axis)
        self.bwd = _local_dir(bwd, self._bwd_mode, dst_layout, src_layout,
                              axis)

    def _exchange(self, d: _LocalDir, xp: torch.Tensor) -> torch.Tensor:
        """The source buffer this rank's edges index: the whole padded
        table (allgather) or the rows shipped to it (halo)."""
        _need_group(self.axis)
        group = self.axis.group
        if d.mode == "allgather":
            full = xp.new_empty((self.axis.size * xp.shape[0], xp.shape[1]))
            _all_gather_into(full, xp, group)
            return full
        buf = xp.index_select(0, d.send_idx)
        recv = torch.empty_like(buf)
        dist.all_to_all_single(recv, buf, group=group)
        return recv

    def _run(self, d: _LocalDir, xp: torch.Tensor) -> torch.Tensor:
        if xp.dim() != 2 or xp.shape[0] != d.src_rows_max:
            raise ValueError(f"padded shard of shape {tuple(xp.shape)}, "
                             f"operator expects ({d.src_rows_max}, D)")
        msg = xp.to(_MSG_DTYPES[self.precision]).contiguous()
        src = self._exchange(d, msg)
        c = d.csr
        return segment_spmm(c.indptr, c.src, c.w, src, backend=self.backend,
                            out_dtype=xp.dtype, pieces=c.pieces,
                            kernel=SHARDED_KERNEL)

    def apply_padded(self, xp: torch.Tensor) -> torch.Tensor:
        """This rank's (src rows_max, D) shard -> its (dst rows_max, D)
        shard, differentiable in ``xp`` (the backward runs the transpose
        plan, exchange included, as ``SpmmOperator``'s does)."""
        return _SpmmFn.apply(xp, self, self.fwd, self.bwd)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        xp = self.src_layout.to_padded(x)
        yp = self.apply_padded(xp)
        return self.dst_layout.from_padded(yp)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

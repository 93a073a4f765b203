"""Host planning of the edge-chunked SpMM layout (``JAX: ops/spmm_pallas.py``).

Edges are sorted by destination; destination rows are cut into blocks of
``R`` rows and each block's edge run into chunks of ``T`` edges (every block
owns at least one chunk, so an empty block still gets its zeroing chunk).
A window plan (``window=W``) further confines each chunk's rows to an
8-aligned ``W``-row window starting at ``win_start`` inside its block.  Work
is balanced by edge count: a hub row owns many chunks.

The planners are the JAX package's numpy code, copied (``_build_plain``,
the vectorized greedy ``_build_window``, ``auto_window``), so the arrays are
equal to ``build_pallas_segment_plan``'s.  :class:`SegmentPlan` holds them
as torch tensors on one device; the kernels that run a plan are in
``ops/chunk_spmm.py``.
:func:`build_sliced_segment_plans` cuts one direction into destination
slices on block-aligned cuts (``JAX: build_sliced_segment_plans``), and
:class:`PadLayout` is the tail-padded layout of a chain of such plans.

Pad edges carry ``local_id == R`` (plain) or ``== W`` (window), weight 0 and
source 0, and sit at the tail of a chunk.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

DEFAULT_BLOCK_ROWS = 512     # R: destination rows per output block
DEFAULT_CHUNK_EDGES = 256    # T: edges per chunk


@dataclass(frozen=True)
class SegmentPlan:
    """One operator direction's chunk plan (``PallasSegmentPlan``)."""
    src_padded: torch.Tensor      # (E_pad,) int32 source ids (pad -> 0)
    w_padded: torch.Tensor        # (E_pad,) float32 weights (pad -> 0)
    local_ids: torch.Tensor       # (E_pad,) int32 row id within block/window
    block_id: torch.Tensor        # (G,) int32 output block per chunk
    first_chunk: torch.Tensor     # (G,) int32 1 if first chunk of its block
    win_start: Optional[torch.Tensor]  # (G,) int32 8-aligned offset, or None
    num_dst: int
    num_src: int
    num_blocks: int
    block_rows: int
    chunk_edges: int
    window: int                   # 0 = full-block chunks; else W
    _cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def num_chunks(self) -> int:
        return self.block_id.numel()

    @property
    def padded_edges(self) -> int:
        return self.src_padded.numel()

    @property
    def device(self) -> torch.device:
        return self.src_padded.device

    def local_ids_as(self, dtype: torch.dtype) -> torch.Tensor:
        """``local_ids`` in ``dtype`` (int32 or int16), converted once."""
        if dtype == torch.int32:
            return self.local_ids
        if dtype != torch.int16:
            raise ValueError(f"local ids are int32 or int16, not {dtype}")
        limit = self.window or self.block_rows
        if limit > np.iinfo(np.int16).max:
            raise ValueError(f"int16 local ids need R <= 32767, got {limit}")
        if dtype not in self._cache:
            self._cache[dtype] = self.local_ids.to(dtype)
        return self._cache[dtype]

    def block_chunk_offsets(self) -> torch.Tensor:
        """``(num_blocks + 1,)`` int32: block ``b``'s chunks are
        ``[off[b], off[b + 1])``.  Built once, on the plan's device."""
        if "block_off" not in self._cache:
            counts = torch.bincount(self.block_id, minlength=self.num_blocks)
            off = torch.zeros(self.num_blocks + 1, dtype=torch.int32,
                              device=self.device)
            off[1:] = torch.cumsum(counts, 0)
            self._cache["block_off"] = off
        return self._cache["block_off"]

    def chunk_meta(self) -> torch.Tensor:
        """``(G, 8)`` int32, one row a chunk, for the staged kernel.

        A row that runs across a chunk boundary is summed in parts: its
        *span* is the chunks ``c_a .. c_b`` whose runs hold it (the last run
        of ``c_a``, then the first run of each later one), and its part in
        each is added in chunk order.  Per chunk: its block ``b``; the
        block-space row its local ids count from (``b*R + win_start``); the
        row that ends the rows it writes (the next chunk's first row, or
        its block's end when it is the block's last); ``first | last << 1
        | cont_in << 2 | opens << 3`` (its first run continues a span; its
        last run opens one); the first chunk and the length of the span its
        first run continues (else -1, 0); the length of the span it opens
        (else 0).  Built once, on the plan's device."""
        if "meta" not in self._cache:
            self._cache["meta"] = self._chunk_meta()
        return self._cache["meta"]

    def _chunk_meta(self) -> torch.Tensor:
        G, T, R = self.num_chunks, self.chunk_edges, self.block_rows
        dev = self.device
        idx = torch.arange(G, device=dev)
        b = self.block_id.long()
        off = self.block_chunk_offsets().long()
        blk_lo = b * R
        ws = self.win_start.long() if self.window else torch.zeros_like(b)
        base = blk_lo + ws
        first = self.first_chunk.bool()
        last = idx + 1 == off[b + 1]
        lid = self.local_ids.view(G, T).long()
        n = (lid < (self.window or R)).sum(1)       # real edges: a prefix
        head = base + lid[:, 0]
        tail = base + lid.gather(1, (n - 1).clamp(min=0)[:, None])[:, 0]
        hi = torch.where(last, blk_lo + R,
                         blk_lo + torch.roll(ws, -1) + torch.roll(lid[:, 0], -1))
        one_run = (n > 0) & (head == tail)
        cont_out = ~last & (tail == torch.roll(head, -1))
        cont_in = torch.zeros_like(first)
        cont_in[1:] = cont_out[:-1]
        opens = cont_out & ~(one_run & cont_in)
        # a span closes at the first chunk after its opener that is not a
        # one-run chunk passing the row on
        middle = one_run & cont_in & cont_out
        stop = torch.where(middle, G, idx)
        close = torch.flip(torch.cummin(torch.flip(stop, [0]), 0).values, [0])
        close_next = torch.roll(close, -1)
        open_len = torch.where(opens, close_next - idx + 1, 0)
        opener = torch.where(opens, idx, -1)
        prev_open = torch.cummax(opener, 0).values
        span_start = torch.full_like(idx, -1)
        span_start[1:] = prev_open[:-1]
        span_start = torch.where(cont_in, span_start, -1)
        span_len = torch.where(cont_in, open_len[span_start.clamp(min=0)], 0)
        flags = (first.long() | (last.long() << 1) | (cont_in.long() << 2)
                 | (opens.long() << 3))
        return torch.stack([b, base, hi, flags, span_start, span_len,
                            open_len, torch.zeros_like(b)],
                           1).to(torch.int32).contiguous()

    def arrays(self) -> dict:
        """The plan's arrays as numpy, under the JAX plan's field names."""
        out = {k: getattr(self, k).cpu().numpy() for k in
               ("src_padded", "w_padded", "local_ids", "block_id",
                "first_chunk")}
        out["win_start"] = (None if self.win_start is None
                            else self.win_start.cpu().numpy())
        return out


def _to_plan(src_p, w_p, lid_p, block_id, first, wstart, *, device,
             **meta) -> SegmentPlan:
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    return SegmentPlan(
        src_padded=t(np.asarray(src_p, np.int32)),
        w_padded=t(np.asarray(w_p, np.float32).reshape(-1)),
        local_ids=t(np.asarray(lid_p, np.int32).reshape(-1)),
        block_id=t(np.asarray(block_id, np.int32)),
        first_chunk=t(np.asarray(first, np.int32)),
        win_start=None if wstart is None else t(np.asarray(wstart, np.int32)),
        **meta)


def _empty_plan(num_dst, num_src, R, T, device) -> SegmentPlan:
    """Degenerate zero-edge plan: every block still gets its zeroing chunk."""
    num_blocks = max(-(-num_dst // R), 1)
    G0 = num_blocks
    return _to_plan(
        np.zeros(G0 * T, np.int32), np.zeros(G0 * T, np.float32),
        np.full(G0 * T, R, np.int32), np.arange(G0, dtype=np.int32),
        np.ones(G0, np.int32), None, device=device,
        num_dst=num_dst, num_src=num_src, num_blocks=num_blocks,
        block_rows=R, chunk_edges=T, window=0)


def _build_plain(src, dst, w, num_dst, num_blocks, R, T):
    """Vectorized plain plan: per-block edge runs padded to multiples of T."""
    E = src.shape[0]
    blk_of_edge = dst // R
    edges_per_block = np.bincount(blk_of_edge, minlength=num_blocks)
    chunks_per_block = np.maximum(-(-edges_per_block // T), 1)
    padded_per_block = chunks_per_block * T

    pad_start = np.zeros(num_blocks + 1, np.int64)
    np.cumsum(padded_per_block, out=pad_start[1:])
    edge_start = np.zeros(num_blocks + 1, np.int64)
    np.cumsum(edges_per_block, out=edge_start[1:])

    E_pad = int(pad_start[-1])
    G = E_pad // T

    pos = pad_start[blk_of_edge] + (np.arange(E) - edge_start[blk_of_edge])

    src_padded = np.zeros(E_pad, np.int32)
    w_padded = np.zeros(E_pad, np.float32)
    lid_flat = np.full(E_pad, R, np.int32)
    src_padded[pos] = src
    w_padded[pos] = w
    lid_flat[pos] = (dst - blk_of_edge * R).astype(np.int32)

    block_id = np.repeat(np.arange(num_blocks, dtype=np.int32),
                         chunks_per_block)
    first_chunk = np.zeros(G, np.int32)
    chunk_start = np.zeros(num_blocks, np.int64)
    np.cumsum(chunks_per_block[:-1], out=chunk_start[1:])
    first_chunk[chunk_start] = 1
    return src_padded, w_padded, lid_flat, block_id, first_chunk, None


def _build_window(src, dst, w, num_dst, num_blocks, R, T, W):
    """Greedy window chunking: each chunk holds <=T edges whose local row
    ids fit an 8-aligned W-row window (window start clamped to R-W).

    The chunk boundaries of every still-open block are computed together,
    one round per chunk depth, which equals the sequential per-block greedy
    (``build_window_plan`` in ``scripts/probe_window_kernel.py``)."""
    blk_of_edge = dst // R
    lid_all = (dst - blk_of_edge * R).astype(np.int64)
    counts = np.bincount(blk_of_edge, minlength=num_blocks)
    edge_start = np.zeros(num_blocks + 1, np.int64)
    np.cumsum(counts, out=edge_start[1:])
    # globally nondecreasing key: searchsorted respects block boundaries
    # because ws + W <= R keeps each probe inside its own block's span
    key_all = blk_of_edge.astype(np.int64) * R + lid_all

    cb, ci, cj, cws, crd = [], [], [], [], []
    b_ids = np.arange(num_blocks, dtype=np.int64)
    i_cur = edge_start[:-1].copy()
    end = edge_start[1:]
    open_m = i_cur < end
    rnd = 0
    while open_m.any():
        bo = b_ids[open_m]
        io = i_cur[open_m]
        ws = np.minimum((lid_all[io] // 8) * 8, R - W)
        j = np.searchsorted(key_all, bo * R + ws + W, side="left")
        j = np.minimum(np.minimum(j, io + T), end[open_m])
        cb.append(bo)
        ci.append(io)
        cj.append(j)
        cws.append(ws)
        crd.append(np.full(bo.shape[0], rnd, np.int64))
        i_cur[open_m] = j
        open_m = i_cur < end
        rnd += 1
    empty = b_ids[counts == 0]
    if empty.size:  # empty blocks still get their zeroing chunk
        z = edge_start[empty]
        cb.append(empty)
        ci.append(z)
        cj.append(z)
        cws.append(np.zeros(empty.size, np.int64))
        crd.append(np.zeros(empty.size, np.int64))
    cb = np.concatenate(cb)
    ci = np.concatenate(ci)
    cj = np.concatenate(cj)
    cws = np.concatenate(cws)
    crd = np.concatenate(crd)
    order = np.lexsort((crd, cb))  # block-major; chunk order within block
    cb, ci, cj, cws = cb[order], ci[order], cj[order], cws[order]

    G = cb.shape[0]
    E_pad = G * T
    n = cj - ci
    src_p = np.zeros(E_pad, np.int32)
    w_p = np.zeros(E_pad, np.float32)
    lid_p = np.full(E_pad, W, np.int32)
    # scatter every chunk's edge run at once: edge r of chunk g lands at
    # g*T + r and reads global edge ci[g] + r
    run_start = np.zeros(G, np.int64)
    np.cumsum(n[:-1], out=run_start[1:])
    off = np.arange(int(n.sum()), dtype=np.int64) - np.repeat(run_start, n)
    eidx = np.repeat(ci, n) + off
    pos = np.repeat(np.arange(G, dtype=np.int64) * T, n) + off
    src_p[pos] = src[eidx]
    w_p[pos] = w[eidx]
    lid_p[pos] = lid_all[eidx] - np.repeat(cws, n)

    first = np.zeros(G, np.int32)
    first[0] = 1
    first[1:][cb[1:] != cb[:-1]] = 1
    return (src_p, w_p, lid_p, cb.astype(np.int32), first,
            cws.astype(np.int32))


def _plain_padded_edges(dst, num_blocks, R, T) -> int:
    """Padded edge count of the plain plan (a bincount, no assembly)."""
    epb = np.bincount(dst // R, minlength=num_blocks)
    return int(np.maximum(-(-epb // T), 1).sum()) * T


def _window_chunk_count(dst, num_blocks, R, T, W) -> int:
    """Chunk count of the greedy window plan (the rounds of
    :func:`_build_window`, counting only)."""
    blk_of_edge = dst // R
    lid_all = (dst - blk_of_edge * R).astype(np.int64)
    counts = np.bincount(blk_of_edge, minlength=num_blocks)
    edge_start = np.zeros(num_blocks + 1, np.int64)
    np.cumsum(counts, out=edge_start[1:])
    key_all = blk_of_edge.astype(np.int64) * R + lid_all

    G = int((counts == 0).sum())        # zeroing chunks of empty blocks
    i_cur = edge_start[:-1].copy()
    end = edge_start[1:]
    b_ids = np.arange(num_blocks, dtype=np.int64)
    open_m = i_cur < end
    while open_m.any():
        io = i_cur[open_m]
        ws = np.minimum((lid_all[io] // 8) * 8, R - W)
        j = np.searchsorted(key_all, b_ids[open_m] * R + ws + W, side="left")
        j = np.minimum(np.minimum(j, io + T), end[open_m])
        G += int(open_m.sum())
        i_cur[open_m] = j
        open_m = i_cur < end
    return G


def auto_window(dst: np.ndarray, num_dst: int, E: int,
                block_rows: int = DEFAULT_BLOCK_ROWS,
                chunk_edges: int = DEFAULT_CHUNK_EDGES) -> int:
    """The "auto" window decision from padded-edge counts only.  ``dst``
    must be sorted.  W must cover a chunk's typical row span (T / mean dst
    degree) plus alignment slack, and is kept only while its padded edge
    count stays within 2% of the plain plan's."""
    R, T = int(block_rows), int(chunk_edges)
    if E == 0:
        return 0
    num_blocks = max(-(-num_dst // R), 1)
    mean_deg = E / max(num_dst, 1)
    need = T / max(mean_deg, 1e-9) + 16
    W = next((c for c in (64, 128, 256) if c >= need and c < R), 0)
    if not W:
        return 0
    dst = np.asarray(dst, np.int64)
    win_padded = _window_chunk_count(dst, num_blocks, R, T, W) * T
    if win_padded <= 1.02 * _plain_padded_edges(dst, num_blocks, R, T):
        return W
    return 0


def build_segment_plan(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                       num_dst: int, block_rows: int = DEFAULT_BLOCK_ROWS,
                       chunk_edges: int = DEFAULT_CHUNK_EDGES,
                       num_src: int | None = None,
                       window: int | str = "auto",
                       device="cpu") -> SegmentPlan:
    """Plan one direction on the host; ``src``/``dst``/``w`` must already
    be dst-sorted.  ``window``: 0 gives full-block chunks, an int W forces
    window chunks (0 < W < block_rows, both divisible by 8), "auto" decides
    with :func:`auto_window`.  The plan's tensors live on ``device``."""
    R, T = int(block_rows), int(chunk_edges)
    E = int(src.shape[0])
    num_src = int(num_src if num_src is not None else (src.max() + 1 if E else 1))
    num_blocks = max(-(-num_dst // R), 1)
    device = torch.device(device)
    if E == 0:
        return _empty_plan(num_dst, num_src, R, T, device)

    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(w, np.float32)
    if not np.all(np.diff(dst) >= 0):
        raise ValueError("edges must be sorted by dst")

    if window == "auto":
        win = auto_window(dst, num_dst, E, R, T)
    elif window:
        win = int(window)
        if not (0 < win < R and win % 8 == 0 and R % 8 == 0):
            raise ValueError(
                f"window={win} invalid: need 0 < W < block_rows={R} and "
                f"both divisible by 8 (win_start alignment promise)")
    else:
        win = 0

    if win:
        chosen = _build_window(src, dst, w, num_dst, num_blocks, R, T, win)
    else:
        chosen = _build_plain(src, dst, w, num_dst, num_blocks, R, T)
    return _to_plan(*chosen, device=device, num_dst=int(num_dst),
                    num_src=num_src, num_blocks=int(num_blocks),
                    block_rows=R, chunk_edges=T, window=win)


def build_sliced_segment_plans(src: np.ndarray, dst: np.ndarray,
                               w: np.ndarray, num_dst: int,
                               block_rows: int = DEFAULT_BLOCK_ROWS,
                               chunk_edges: int = DEFAULT_CHUNK_EDGES,
                               num_src: int | None = None,
                               window: int | str = "auto",
                               slices: int | str = "auto",
                               device="cpu") -> tuple:
    """One operator direction cut into S destination slices on block-aligned
    dst cuts, each planned on its own (``JAX: ops/spmm_pallas.py:342-403``).
    ``slices="auto"`` is ``min(4, blocks)``.  The window is decided once on
    the whole direction and forced on every slice, so each slice's chunks
    are the unsliced plan's: the slices' block spaces, one after another,
    are the unsliced block space, row for row and in the same summation
    order.  Returns a tuple of :class:`SegmentPlan` (one when slicing is
    moot)."""
    R = int(block_rows)
    E = int(src.shape[0])
    blocks = max(-(-num_dst // R), 1)
    S = min(4, blocks) if slices == "auto" else int(slices)
    S = max(min(S, blocks), 1)
    if S == 1 or E == 0:
        return (build_segment_plan(
            src, dst, w, num_dst, block_rows=R, chunk_edges=chunk_edges,
            num_src=num_src, window=window, device=device),)
    dst = np.asarray(dst, np.int64)
    if not np.all(np.diff(dst) >= 0):
        raise ValueError("edges must be sorted by dst")
    if window == "auto":
        forced_window = auto_window(dst, num_dst, E, R, chunk_edges)
    else:
        forced_window = int(window)             # 0 = full-block chunks
    plans = []
    for s in range(S):
        lo = (blocks * s // S) * R
        hi = num_dst if s == S - 1 else min((blocks * (s + 1) // S) * R,
                                            num_dst)
        e_lo = np.searchsorted(dst, lo, side="left")
        e_hi = np.searchsorted(dst, hi, side="left")
        plans.append(build_segment_plan(
            src[e_lo:e_hi], dst[e_lo:e_hi] - lo, w[e_lo:e_hi], hi - lo,
            block_rows=R, chunk_edges=chunk_edges, num_src=num_src,
            window=forced_window, device=device))
    return tuple(plans)


def segment_plan_from_jax(plan, device="cpu") -> SegmentPlan:
    """The port's plan from a JAX ``PallasSegmentPlan`` (or any object with
    its field names whose arrays convert with ``np.asarray``), so both run
    the same chunks.  Checks that each chunk's pad edges form its tail,
    which the kernels rely on."""
    R, T, W = int(plan.block_rows), int(plan.chunk_edges), int(plan.window)
    lid = np.asarray(plan.local_ids).reshape(-1)
    valid = (lid < (W or R)).reshape(-1, T)
    if bool((~valid[:, :-1] & valid[:, 1:]).any()):
        raise ValueError("a chunk holds a pad edge before a real one")
    ws = plan.win_start
    return _to_plan(np.array(plan.src_padded), np.array(plan.w_padded),
                    np.array(lid), np.array(plan.block_id),
                    np.array(plan.first_chunk),
                    None if ws is None else np.array(ws),
                    device=torch.device(device), num_dst=int(plan.num_dst),
                    num_src=int(plan.num_src),
                    num_blocks=int(plan.num_blocks), block_rows=R,
                    chunk_edges=T, window=W)


@dataclass(frozen=True)
class PadLayout:
    """Tail padding of one node space to the kernel's block grid, so a
    K-layer chain can stay in the padded block space and truncate once."""
    rows: int
    padded_rows: int

    def equals(self, other) -> bool:
        return (isinstance(other, PadLayout) and self.rows == other.rows
                and self.padded_rows == other.padded_rows)

    def to_padded(self, x: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(
            x, (0, 0, 0, self.padded_rows - self.rows))

    def from_padded(self, p: torch.Tensor) -> torch.Tensor:
        return p[:self.rows]

    def rows_of(self, p: torch.Tensor, rows: torch.Tensor, plan=None,
                backend: str = "auto") -> torch.Tensor:
        """The rows ``rows`` of the padded table ``p`` (a row's slot is the
        row itself: the padding is at the tail).  ``plan`` (of ``rows``
        into the padded rows, ``ops/gather.py``) gives the gather its
        segment-sum backward; without it the gather is the stock
        ``p[rows]``."""
        from .gather import gather_rows
        if p.shape[0] != self.padded_rows:
            raise ValueError(f"padded table has {p.shape[0]} rows, layout "
                             f"holds {self.padded_rows}")
        return gather_rows(p, rows, plan, backend)

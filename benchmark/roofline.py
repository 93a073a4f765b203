"""Published peaks of one H100 SXM and the least time of the work the cells
run, counted from shapes.

Every count is of what the inputs need: each input byte read once and each
output byte written once, whatever a kernel reads again; a matrix of scores
that a ranking materialises is not needed and is not counted.  A least time
is the larger of the bytes at the memory rate and the operations at the
rate of the arithmetic used.  These are the rates at the card's full power
limit of 700 W; a run names the limit its card was set to.

``bound_ms`` and ``csr_bound_ms`` are copies of the port's
``probes/_timing.py`` arithmetic.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
FP32_FLOPS = 67e12            # fp32 outside the tensor cores
BF16_FLOPS = 989e12           # bf16 tensor cores, dense


def bound_ms(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS
             ) -> float:
    """The larger of the byte time and the operation time, in ms."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)


def csr_bound_ms(src_rows: int, edges: int, num_dst: int, D: int,
                 itemsize: int = 4) -> float:
    """One weighted segment-sum ``y[d] = sum w[e] x[src[e]]``: the
    ``src_rows`` referenced source rows, an int32 id and an fp32 weight an
    edge, int64 row pointers and one write of y; two operations an edge and
    column."""
    nbytes = (src_rows * D * itemsize + edges * 8 + (num_dst + 1) * 8
              + num_dst * D * itemsize)
    return bound_ms(nbytes, 2.0 * edges * D)


def adam_bound_ms(elements: int) -> float:
    """Adam over ``elements`` fp32 values: p, g, m, v read and p, m, v
    written, 28 bytes an element."""
    return bound_ms(28.0 * elements, 0.0)


def gather_backward_bound_ms(ids: int, table_rows: int, D: int) -> float:
    """The backward of ``table[ids]``: the ``ids`` gradient rows summed into
    a dense gradient of the whole table (a segment-sum with unit weights)."""
    return csr_bound_ms(ids, ids, table_rows, D)


def graph_stats(users: int, items: int, train: np.ndarray) -> dict:
    """The shapes a propagation's applications need: users, items, train
    edges and the rows each direction references."""
    return {"users": int(users), "items": int(items),
            "edges": int(train.shape[1]),
            "src_users": int(np.unique(train[0]).size),
            "src_items": int(np.unique(train[1]).size)}


def propagate_bound_ms(stats: dict, D: int, layers: int) -> float:
    """A Gauss-Seidel propagation: ``layers`` item<-user and user<-item
    applications in fp32."""
    E = stats["edges"]
    return layers * (csr_bound_ms(stats["src_users"], E, stats["items"], D)
                     + csr_bound_ms(stats["src_items"], E, stats["users"], D))


def train_epoch_spmm_ms(stats: dict, D: int, layers: int, batch: int,
                        steps: int, schedule: str) -> dict:
    """The least ms of an epoch's segment-sum applications by kind, and
    their count, as the port's trainer runs them.

    "per_epoch": one propagation for the cache, then a step gathers its
    batch rows of the combined tables and of the ego tables: four gather
    backwards (users into the user table, positives and negatives into the
    item table, twice).  "per_batch": a step propagates (``2 layers``
    applications), runs their transposes backward (``2 layers``) and
    gathers ``layers + 1`` user and item rows and the two ego rows
    (``2 layers + 4`` gather backwards)."""
    U, I = stats["users"], stats["items"]
    gathers = (gather_backward_bound_ms(batch, U, D)
               + gather_backward_bound_ms(2 * batch, I, D))
    prop = propagate_bound_ms(stats, D, layers)
    if schedule == "per_epoch":
        return {"ms": prop + steps * 2 * gathers,
                "spmm": 2 * layers, "gather_backward": 4 * steps}
    if schedule == "per_batch":
        return {"ms": steps * (2 * prop + (layers + 2) * gathers),
                "spmm": 4 * layers * steps,
                "gather_backward": (2 * layers + 4) * steps}
    raise ValueError(f"unknown schedule {schedule!r}")


def eval_batch_bound_ms(batch: int, items: int, D: int, k: int,
                        exclusions: int) -> float:
    """One full-catalogue batch on bf16 tables: the bf16 GEMM's operations
    at the bf16 rate, or the bytes of the bf16 item table, the batch's bf16
    user rows, its int32 exclusion ids and the top-k ids and fp32 scores."""
    nbytes = (items * D * 2 + batch * D * 2 + exclusions * 4
              + batch * k * 8)
    return bound_ms(nbytes, 2.0 * batch * D * items, BF16_FLOPS)

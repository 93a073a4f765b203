"""Bipartite graph assembly for Stage-B training.

Reference parity notes: the reference Stage-B scripts intern user/item ids in
*encounter order over positive interactions only* (lightgcn.py:167-193), so a
Stage-B id space is generally different from the Stage-A (all-records) id
space; the credibility CSV bridges the two by raw ``user_id``
(lightgcn_cu.py:305-362).  :func:`build_bipartite_graph` reproduces that id
space vectorized from an :class:`InteractionTable`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..data.ingest import InteractionTable, TRAIN, VAL, TEST
from .csr import CSR, edges_to_csr, degrees_from_edges


def _factorize_encounter_order(values: np.ndarray):
    """Renumber int array by order of first occurrence (vectorized).

    Equivalent to the reference's ``if uid not in user2idx: user2idx[uid] =
    len(user2idx)`` loop (lightgcn.py:174-177).
    """
    uniq, first_pos, inverse = np.unique(values, return_index=True, return_inverse=True)
    # rank of each unique value by its first position in the stream
    order = np.argsort(first_pos, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    return rank[inverse].astype(np.int32), uniq[order]


@dataclass
class BipartiteGraph:
    """Train/val/test positive edges over a compact bipartite id space."""

    num_users: int
    num_items: int
    train_edges: np.ndarray           # (2, E_tr) int32 [user; item]
    val_edges: np.ndarray             # (2, E_va) int32
    test_edges: np.ndarray            # (2, E_te) int32
    user_ids: Optional[List[str]] = None   # compact idx -> raw id
    item_ids: Optional[List[str]] = None
    _csr_cache: dict = field(default_factory=dict, repr=False)

    @property
    def user2idx(self) -> Dict[str, int]:
        return {u: i for i, u in enumerate(self.user_ids or [])}

    def edges(self, split: str) -> np.ndarray:
        return {"train": self.train_edges, "val": self.val_edges,
                "test": self.test_edges}[split]

    def user_csr(self, split: str) -> CSR:
        """Per-user sorted item lists for a split (lightgcn.py:532-534)."""
        key = ("user", split)
        if key not in self._csr_cache:
            e = self.edges(split)
            self._csr_cache[key] = edges_to_csr(e[0], e[1], self.num_users)
        return self._csr_cache[key]

    def item_csr(self, split: str) -> CSR:
        key = ("item", split)
        if key not in self._csr_cache:
            e = self.edges(split)
            self._csr_cache[key] = edges_to_csr(e[1], e[0], self.num_items)
        return self._csr_cache[key]

    def train_item_degrees(self) -> np.ndarray:
        return degrees_from_edges(self.train_edges[1], self.num_items)

    def train_user_degrees(self) -> np.ndarray:
        return degrees_from_edges(self.train_edges[0], self.num_users)

    def summary(self) -> str:
        return (f"Users={self.num_users:,} Items={self.num_items:,} "
                f"Train={self.train_edges.shape[1]:,} "
                f"Val={self.val_edges.shape[1]:,} "
                f"Test={self.test_edges.shape[1]:,}")

    def save_npz(self, path) -> None:
        np.savez_compressed(
            path,
            num_users=self.num_users, num_items=self.num_items,
            train_edges=self.train_edges, val_edges=self.val_edges,
            test_edges=self.test_edges,
            user_ids=np.asarray(self.user_ids if self.user_ids else [], dtype=object),
            item_ids=np.asarray(self.item_ids if self.item_ids else [], dtype=object),
            allow_pickle=True,
        )

    @classmethod
    def load_npz(cls, path) -> "BipartiteGraph":
        z = np.load(path, allow_pickle=True)
        uids = list(z["user_ids"]) or None
        iids = list(z["item_ids"]) or None
        return cls(int(z["num_users"]), int(z["num_items"]),
                   z["train_edges"], z["val_edges"], z["test_edges"],
                   user_ids=uids, item_ids=iids)


def build_bipartite_graph(table: InteractionTable) -> BipartiteGraph:
    """Compact positive-interaction graph in reference Stage-B id space."""
    mask = table.positive
    u_raw = table.uidx[mask]
    i_raw = table.iidx[mask]
    split = table.split[mask]

    u_new, u_order = _factorize_encounter_order(u_raw)
    i_new, i_order = _factorize_encounter_order(i_raw)

    user_ids = [table.user_ids[k] for k in u_order]
    item_ids = [table.item_ids[k] for k in i_order]

    def _edges(s):
        m = split == s
        return np.stack([u_new[m], i_new[m]]).astype(np.int32)

    return BipartiteGraph(
        num_users=len(user_ids),
        num_items=len(item_ids),
        train_edges=_edges(TRAIN),
        val_edges=_edges(VAL),
        test_edges=_edges(TEST),
        user_ids=user_ids,
        item_ids=item_ids,
    )


def synthetic_bipartite_graph(num_users: int = 200, num_items: int = 300,
                              edges_per_user: float = 8.0, seed: int = 0,
                              power: float = 1.0,
                              hash_split: str = "auto") -> BipartiteGraph:
    """Synthetic power-law bipartite graph for tests and benchmarks.

    Item popularity ~ Zipf(power) to mimic the reference dataset's skew
    (max item degree 1965 vs mean 1.42; SURVEY.md §7 "hard parts").
    Edges are deduplicated and content-hash split: "md5" uses the exact
    reference algorithm (Python loop, slow past ~1M edges); "fast" uses a
    vectorized 64-bit mix hash with the same 80/10/10 marginals; "auto"
    picks md5 below 1M edges.
    """
    rng = np.random.default_rng(seed)
    n_edges = int(num_users * edges_per_user)
    users = rng.integers(0, num_users, size=n_edges)
    p = 1.0 / np.arange(1, num_items + 1, dtype=np.float64) ** power
    p /= p.sum()
    items = rng.choice(num_items, size=n_edges, p=p)
    return _dedup_split_graph(users, items, num_users, num_items, hash_split)


def _dedup_split_graph(users: np.ndarray, items: np.ndarray, num_users: int,
                       num_items: int, hash_split: str) -> BipartiteGraph:
    """Dedup (u, i) pairs and content-hash split 80/10/10 into a graph."""
    pairs = np.unique(np.stack([users, items], axis=1), axis=0)
    users, items = pairs[:, 0], pairs[:, 1]

    if hash_split == "auto":
        hash_split = "md5" if users.size <= 1_000_000 else "fast"
    if hash_split == "md5":
        # content-hash split on the (u,i) pair, reference algorithm
        from ..data.ingest import md5_split_bucket
        buckets = np.array(
            [md5_split_bucket(f"u{u}", f"i{i}") for u, i in zip(users, items)],
            dtype=np.int8)
    else:
        # vectorized splitmix64-style mix of the pair
        h = (users.astype(np.uint64) << np.uint64(32)) ^ items.astype(np.uint64)
        h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        h = h ^ (h >> np.uint64(31))
        x = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        buckets = np.where(x < 0.8, 0, np.where(x < 0.9, 1, 2)).astype(np.int8)

    def _edges(b):
        m = buckets == b
        return np.stack([users[m], items[m]]).astype(np.int32)

    return BipartiteGraph(
        num_users=num_users, num_items=num_items,
        train_edges=_edges(TRAIN), val_edges=_edges(VAL), test_edges=_edges(TEST),
        user_ids=[f"u{k}" for k in range(num_users)],
        item_ids=[f"i{k}" for k in range(num_items)],
    )


def synthetic_bipartite_graph_planted(
        num_users: int = 200, num_items: int = 300,
        edges_per_user: float = 8.0, seed: int = 0, power: float = 1.0,
        coarse_clusters: int = 16, fine_per_coarse: int = 16,
        mix: tuple = (0.55, 0.25, 0.20),
        hash_split: str = "auto") -> BipartiteGraph:
    """Zipf bipartite graph with PLANTED two-level preference structure.

    The plain :func:`synthetic_bipartite_graph` draws users uniformly and
    items Zipf — there is no user-item affinity to learn beyond popularity,
    so full-catalog metrics freeze within ~3 epochs at the 10M scale
    (VERDICT r3 weak-1: a flat metric surface certifies nothing about
    ranking-perturbing eval fast paths).  Here every user and item carries
    a latent (coarse, fine) cluster pair — fine clusters nest inside
    coarse ones — and each interaction draws its item from a mixture:

      * ``mix[0]``: the user's FINE cluster (conditional Zipf within it),
      * ``mix[1]``: the user's COARSE cluster (ditto),
      * ``mix[2]``: the global Zipf (popularity noise floor).

    What this buys, measured at the 10M scale
    (`runs/eval_equiv_r4/train_exact.json`): VAL R@20 climbs steeply for
    ~4-5 epochs (0.043 -> 0.080) then saturates with 1e-4-level
    epoch-to-epoch jitter (6/11 strict improvements over 12 epochs) — a
    surface with learnable structure and borderline top-K boundaries,
    unlike the plain generator whose metrics freeze BIT-IDENTICAL from
    epoch 3.  It does NOT keep strictly improving for 10+ epochs; the
    eval-fast-path certification therefore rests on the per-user
    top-K set-overlap instrument computed on the same params (Jaccard@20,
    scripts/eval_equiv_r4.py), not on metric movement
    (VERDICT r4 item 7).  Item popularity stays Zipf(power) marginally: cluster
    ids are assigned round-robin over the popularity ranks, so every
    cluster spans head and tail items and the degree-skew properties the
    kernels are load-balanced for (SURVEY.md §7) are preserved.
    """
    assert abs(sum(mix) - 1.0) < 1e-9 and min(mix) >= 0.0, mix
    rng = np.random.default_rng(seed)
    C = coarse_clusters * fine_per_coarse           # total fine clusters
    n_edges = int(num_users * edges_per_user)

    # round-robin assignment over popularity rank: fine cluster f lives in
    # coarse cluster f // fine_per_coarse; item j -> fine cluster j % C
    item_fine = np.arange(num_items, dtype=np.int64) % C
    user_fine = rng.integers(0, C, size=num_users)

    p_global = 1.0 / np.arange(1, num_items + 1, dtype=np.float64) ** power
    p_global /= p_global.sum()

    users = rng.integers(0, num_users, size=n_edges)
    level = rng.choice(3, size=n_edges, p=list(mix))  # 0=fine 1=coarse 2=global
    items = np.empty(n_edges, np.int64)

    glob = level == 2
    if glob.any():
        items[glob] = rng.choice(num_items, size=int(glob.sum()), p=p_global)

    edge_fine = user_fine[users]
    # fine draws: loop over C fine clusters (vectorized choice inside each)
    fine_sel = level == 0
    for f in np.unique(edge_fine[fine_sel]):
        m = fine_sel & (edge_fine == f)
        idx = np.nonzero(item_fine == f)[0]
        pc = p_global[idx] / p_global[idx].sum()
        items[m] = rng.choice(idx, size=int(m.sum()), p=pc)
    # coarse draws: items of any fine cluster inside the user's coarse one
    coarse_sel = level == 1
    edge_coarse = edge_fine // fine_per_coarse
    item_coarse = item_fine // fine_per_coarse
    for c in np.unique(edge_coarse[coarse_sel]):
        m = coarse_sel & (edge_coarse == c)
        idx = np.nonzero(item_coarse == c)[0]
        pc = p_global[idx] / p_global[idx].sum()
        items[m] = rng.choice(idx, size=int(m.sum()), p=pc)

    return _dedup_split_graph(users, items, num_users, num_items, hash_split)

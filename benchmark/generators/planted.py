"""A frozen copy of the port's ``graph/build.py``
``synthetic_bipartite_graph_planted``: Zipf items drawn from the user's
fine cluster, its coarse cluster or the whole catalogue in the proportions
``mix``, deduplicated and split 80/10/10 by a hash of the pair."""

import numpy as np

from benchmark.graphs import dedup_split


def generate(users: int, items: int, edges_per_user: float, seed: int = 0,
             power: float = 1.0, coarse_clusters: int = 16,
             fine_per_coarse: int = 16, mix=(0.55, 0.25, 0.20),
             hash_split: str = "auto"):
    rng = np.random.default_rng(seed)
    C = coarse_clusters * fine_per_coarse
    n = int(users * edges_per_user)
    item_fine = np.arange(items, dtype=np.int64) % C
    user_fine = rng.integers(0, C, size=users)
    p_global = 1.0 / np.arange(1, items + 1, dtype=np.float64) ** power
    p_global /= p_global.sum()
    u = rng.integers(0, users, size=n)
    level = rng.choice(3, size=n, p=list(mix))
    it = np.empty(n, np.int64)
    glob = level == 2
    if glob.any():
        it[glob] = rng.choice(items, size=int(glob.sum()), p=p_global)
    edge_fine = user_fine[u]
    for sel, edge_c, item_c in (
            (level == 0, edge_fine, item_fine),
            (level == 1, edge_fine // fine_per_coarse,
             item_fine // fine_per_coarse)):
        for c in np.unique(edge_c[sel]):
            m = sel & (edge_c == c)
            idx = np.nonzero(item_c == c)[0]
            pc = p_global[idx] / p_global[idx].sum()
            it[m] = rng.choice(idx, size=int(m.sum()), p=pc)
    return dedup_split(u, it, hash_split)

"""Bipartite user-item heterograph with edge attributes (Stage A).

Reference: ``pass1_build_maps_and_stats`` / ``pass2_write_edges`` / PyG
export (reference main.py:423-606).  Parity semantics:

  * id spaces intern over ALL records with (user, item, rating) present, in
    encounter order — every such record is one edge (duplicates included);
  * user node features: the per-user engineered feature vector (Ru + 6/8);
  * user labels: {fake: 0, genuine: 1, unlabeled: -1};
  * item node features: [mean_rating, count];
  * 5 edge attributes in order (main.py:71): verified, rating_align =
    1 - |r - rbar_i|/4, rating, timestamp_norm = (ts-min)/(max-min),
    helpful_vote; missing timestamp/helpful give NaN, exactly like
    ``safe_float`` in the reference (NaN timestamps fall outside BOTH
    temporal views, matching the reference's NaN-compare filtering).

The memmap/PyG export becomes a single columnar npz artifact.  This module
is the PyTorch package's own copy of the JAX package's numpy-only
``graph/hetero.py``; an npz written by either package loads in the other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..data.features import UserFeatures
from ..data.ingest import InteractionTable


@dataclass
class HeteroGraph:
    user_x: np.ndarray            # (U, F) float32
    user_y: np.ndarray            # (U,) int64 in {0, 1, -1}
    item_x: np.ndarray            # (I, 2) float32 [mean_rating, count]
    edges: np.ndarray             # (2, E) int32 [user; item]
    edge_attr: np.ndarray         # (E, 5) float32
    feature_keys: List[str]
    user_ids: Optional[List[str]] = None

    EDGE_ATTR_KEYS = ("verified", "rating_align", "rating", "timestamp_norm",
                      "helpful_vote")

    @property
    def num_users(self) -> int:
        return int(self.user_x.shape[0])

    @property
    def num_items(self) -> int:
        return int(self.item_x.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[1])

    def save_npz(self, path) -> None:
        np.savez_compressed(
            path, user_x=self.user_x, user_y=self.user_y, item_x=self.item_x,
            edges=self.edges, edge_attr=self.edge_attr,
            feature_keys=np.asarray(self.feature_keys, dtype=object),
            user_ids=np.asarray(self.user_ids or [], dtype=object),
            allow_pickle=True)

    @classmethod
    def load_npz(cls, path) -> "HeteroGraph":
        z = np.load(path, allow_pickle=True)
        return cls(user_x=z["user_x"], user_y=z["user_y"], item_x=z["item_x"],
                   edges=z["edges"], edge_attr=z["edge_attr"],
                   feature_keys=list(z["feature_keys"]),
                   user_ids=list(z["user_ids"]) or None)


#: Reference parity: the cred graph always consumes Ru + the 6 v0 features,
#: even when the v1 pipeline computed RNR/ETG on top
#: (reference version_1/main_v2_.py:94-102,612-622).
CRED_GRAPH_FEATURE_KEYS = (
    "Ru", "rating_entropy", "extremity_ratio", "average_rating_deviation",
    "review_burst_count", "lexical_diversity", "review_length_discrepancy")


def build_heterograph(table: InteractionTable,
                      features: UserFeatures,
                      graph_feature_set: str = "cred7") -> HeteroGraph:
    """``graph_feature_set``: "cred7" (reference parity — Ru + 6, dropping
    RNR/ETG when the v1 pipeline produced them) or "all" (every computed
    feature column)."""
    if graph_feature_set == "cred7":
        sel = [features.keys.index(k) for k in CRED_GRAPH_FEATURE_KEYS]
        user_values = features.values[:, sel]
        feature_keys = list(CRED_GRAPH_FEATURE_KEYS)
    elif graph_feature_set == "all":
        user_values = features.values
        feature_keys = list(features.keys)
    else:
        raise ValueError(f"unknown graph_feature_set {graph_feature_set!r}")

    U, I, E = table.num_users, table.num_items, table.num_records
    uidx = table.uidx.astype(np.int64)
    iidx = table.iidx.astype(np.int64)
    r = table.rating.astype(np.float64)

    # item stats over valid float ratings (main.py:466-469)
    item_cnt = np.bincount(iidx, minlength=I).astype(np.float64)
    item_sum = np.bincount(iidx, weights=r, minlength=I)
    item_mean = item_sum / np.maximum(item_cnt, 1.0)
    item_x = np.stack([item_mean, item_cnt], axis=1).astype(np.float32)

    user_y = features.labels.label.astype(np.int64)

    # timestamp normalization over records WITH a timestamp (main.py:520-526)
    ts = table.timestamp.astype(np.float64)
    has_ts = table.timestamp >= 0
    if has_ts.any():
        ts_min, ts_max = ts[has_ts].min(), ts[has_ts].max()
    else:
        ts_min = ts_max = 0.0
    denom = ts_max - ts_min
    tsn = np.full(E, np.nan)
    if denom > 0:
        tsn[has_ts] = (ts[has_ts] - ts_min) / denom

    align = 1.0 - np.abs(r - item_mean[iidx]) / 4.0
    hv = table.helpful_vote.astype(np.float64)

    edge_attr = np.stack([
        table.verified.astype(np.float64),
        align,
        r,
        tsn,
        hv,
    ], axis=1).astype(np.float32)

    return HeteroGraph(
        user_x=user_values.astype(np.float32),
        user_y=user_y,
        item_x=item_x,
        edges=np.stack([uidx, iidx]).astype(np.int32),
        edge_attr=edge_attr,
        feature_keys=feature_keys,
        user_ids=list(table.user_ids),
    )


def synthetic_heterograph_from_edges(edges: np.ndarray, num_users: int,
                                     num_items: int, seed: int = 0,
                                     fake_frac: float = 0.08,
                                     labeled_frac: float = 0.4
                                     ) -> HeteroGraph:
    """Fully vectorized heterograph over GIVEN edges — the Stage-A side of
    the north-star scale chain (VERDICT r4 item 3): feed it the planted
    10M-edge bipartite generator's interactions so Stage A trains on the
    same graph Stage B consumes.

    Each user carries a latent fake/genuine type; labels (``labeled_frac``
    of users, reference Ru-rule outcome {0,1}, rest -1) and the 7 user
    features + 5 edge attributes are drawn type-conditionally (fake: low
    Ru/lexical diversity, extreme ratings, bursty timestamps, unverified;
    genuine: the reverse) with overlap noise — so CredModel has real but
    imperfect signal, like the reference's weak-label setup
    (reference main.py:153-196).  rating_align and item_x are
    computed from the synthesized ratings exactly as
    :func:`build_heterograph` does (main.py:466-469,520-526)."""
    rng = np.random.default_rng(seed)
    u = edges[0].astype(np.int64)
    i = edges[1].astype(np.int64)
    E = u.shape[0]
    U, I = num_users, num_items

    is_fake = rng.random(U) < fake_frac
    labeled = rng.random(U) < labeled_frac
    user_y = np.where(labeled, np.where(is_fake, 0, 1), -1).astype(np.int64)

    # 7 type-conditional user features (CRED_GRAPH_FEATURE_KEYS order),
    # noisy enough that the classes overlap
    def mix(genuine_mu, fake_mu, sd):
        base = np.where(is_fake, fake_mu, genuine_mu)
        return (base + rng.normal(0, sd, U)).astype(np.float32)

    ru = np.clip(np.where(is_fake, rng.beta(2, 8, U), rng.beta(8, 2, U)),
                 0, 1)
    user_x = np.stack([
        ru.astype(np.float32),
        mix(1.4, 0.6, 0.35),            # rating_entropy
        np.clip(mix(0.3, 0.8, 0.15), 0, 1),   # extremity_ratio
        np.clip(mix(0.5, 1.4, 0.3), 0, None),  # average_rating_deviation
        np.clip(mix(0.2, 2.5, 0.8), 0, None),  # review_burst_count
        np.clip(mix(0.75, 0.35, 0.12), 0, 1),  # lexical_diversity
        np.clip(mix(18.0, 45.0, 10.0), 0, None),  # review_length_discrepancy
    ], axis=1)

    fake_e = is_fake[u]
    verified = (rng.random(E) < np.where(fake_e, 0.4, 0.8))
    # ratings: genuine lean 4-5 with spread; fake bimodal extreme
    r_gen = rng.choice([2.0, 3.0, 4.0, 5.0], E, p=[0.08, 0.17, 0.35, 0.40])
    r_fake = rng.choice([1.0, 5.0], E, p=[0.35, 0.65])
    rating = np.where(fake_e, r_fake, r_gen)
    # timestamps: genuine uniform; fake bursty (concentrated window per
    # user); ~5% missing -> NaN (outside both temporal views)
    burst_center = rng.random(U)
    tsn = np.where(fake_e,
                   np.clip(burst_center[u] + rng.normal(0, 0.03, E), 0, 1),
                   rng.random(E))
    tsn[rng.random(E) < 0.05] = np.nan
    helpful = np.where(fake_e,
                       rng.choice([0, 1], E, p=[0.9, 0.1]),
                       rng.choice([0, 1, 3, 8, 15], E,
                                  p=[0.45, 0.25, 0.15, 0.1, 0.05]))

    item_cnt = np.bincount(i, minlength=I).astype(np.float64)
    item_sum = np.bincount(i, weights=rating, minlength=I)
    item_mean = item_sum / np.maximum(item_cnt, 1.0)
    align = 1.0 - np.abs(rating - item_mean[i]) / 4.0

    edge_attr = np.stack([verified, align, rating, tsn, helpful],
                         axis=1).astype(np.float32)
    return HeteroGraph(
        user_x=user_x,
        user_y=user_y,
        item_x=np.stack([item_mean, item_cnt], axis=1).astype(np.float32),
        edges=np.stack([u, i]).astype(np.int32),
        edge_attr=edge_attr,
        feature_keys=list(CRED_GRAPH_FEATURE_KEYS),
        user_ids=[f"u{k}" for k in range(U)])


def synthetic_heterograph(num_users: int = 100, num_items: int = 60,
                          num_edges: int = 800, seed: int = 0,
                          labeled_frac: float = 0.5) -> HeteroGraph:
    """Small random heterograph for tests / dry runs: 7 user features, the
    5 reference edge attrs (some NaN timestamps, like the real pipeline),
    and a partially-labeled user_y in {-1, 0, 1}."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, num_users, num_edges).astype(np.int32)
    i = rng.integers(0, num_items, num_edges).astype(np.int32)
    rating = rng.integers(1, 6, num_edges).astype(np.float32)
    ts = rng.random(num_edges).astype(np.float32)
    ts[rng.random(num_edges) < 0.1] = np.nan
    attr = np.stack([
        (rng.random(num_edges) < 0.7).astype(np.float32),      # verified
        1.0 - np.abs(rating - 3.5) / 4.0,                      # rating_align
        rating,
        ts,                                                    # timestamp_norm
        rng.integers(0, 10, num_edges).astype(np.float32),     # helpful_vote
    ], axis=1).astype(np.float32)
    user_y = np.full(num_users, -1, np.int64)
    lab = rng.random(num_users) < labeled_frac
    user_y[lab] = rng.integers(0, 2, int(lab.sum()))
    return HeteroGraph(
        user_x=rng.normal(size=(num_users, 7)).astype(np.float32),
        user_y=user_y,
        item_x=np.stack([rng.uniform(1, 5, num_items),
                         rng.integers(1, 30, num_items)],
                        axis=1).astype(np.float32),
        edges=np.stack([u, i]),
        edge_attr=attr,
        feature_keys=list(CRED_GRAPH_FEATURE_KEYS),
        user_ids=[f"u{k}" for k in range(num_users)])

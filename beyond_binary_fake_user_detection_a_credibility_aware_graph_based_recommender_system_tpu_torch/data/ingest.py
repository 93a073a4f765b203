"""Raw-data ingestion: streaming JSONL -> columnar interaction arrays.

Mirrors the behavior of the reference ingest layer (parity targets):
  * tolerant streaming JSONL reader (bytes -> decode errors=replace ->
    json, skip bad lines)                  reference lightgcn.py:120-145
  * positive-interaction filter (rating >= threshold)
                                           reference lightgcn.py:75-83
  * deterministic md5 content-hash split   reference lightgcn.py:86-95
  * two-pass ID interning into int32 edge arrays
                                           reference lightgcn.py:151-253

Ingestion emits columnar numpy arrays (ids already interned,
ratings/timestamps as flat vectors) that downstream feature engineering
consumes with vectorized segment ops, and that transfer to the device once
as int32/float32 buffers.  This module is the PyTorch package's own copy of
the JAX package's reader.  ``IngestConfig.backend`` picks the parser as the
JAX package does: "auto" runs the native C++ reader (``data/native/``)
whenever g++ builds it and the Python reader below otherwise, "native"
raises when the library cannot be built, and "python" runs the Python
reader, whose semantics the native one reproduces byte for byte.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils.config import IngestConfig

TRAIN, VAL, TEST = 0, 1, 2
SPLIT_NAMES = ("train", "val", "test")


def iter_jsonl_records(path, decode_errors: str = "replace") -> Iterator[Tuple[int, dict]]:
    """Stream (1-based line number, record) pairs, skipping invalid JSON.

    Byte-level read + lossy decode so non-UTF8 bytes never kill the stream
    (reference lightgcn.py:120-145 semantics, including the capped warning).
    """
    bad_json = 0
    total = 0
    with open(path, "rb") as f:
        for raw in f:
            total += 1
            line = raw.decode("utf-8", errors=decode_errors).strip()
            if not line:
                continue
            try:
                yield total, json.loads(line)
            except json.JSONDecodeError:
                bad_json += 1
                if bad_json <= 5:
                    print(f"[WARN] Skipping invalid JSON at line {total}")
                continue
    if bad_json > 0:
        print(f"[WARN] Total invalid JSON lines skipped: {bad_json:,}")


def to_float(x) -> Optional[float]:
    try:
        return float(x)
    except Exception:
        return None


def is_positive_interaction(rec: dict, cfg: IngestConfig) -> bool:
    """rating >= threshold with both ids present (lightgcn.py:75-83)."""
    if rec.get(cfg.user_key) is None or rec.get(cfg.item_key) is None:
        return False
    rating = to_float(rec.get(cfg.rating_key))
    if rating is None:
        return False
    return rating >= cfg.pos_rating_threshold


def md5_split_bucket(uid: str, iid: str, train_p: float = 0.80, val_p: float = 0.10) -> int:
    """Deterministic content-hash split (lightgcn.py:86-95), kept exactly:
    x = int(md5(f"{uid}|{iid}")[:8], 16) / 0xFFFFFFFF in [0, ~1.0000000002).
    """
    h = hashlib.md5(f"{uid}|{iid}".encode("utf-8")).hexdigest()
    x = int(h[:8], 16) / 0xFFFFFFFF
    if x < train_p:
        return TRAIN
    elif x < train_p + val_p:
        return VAL
    return TEST


@dataclass
class InteractionTable:
    """Columnar interaction store: everything downstream consumes this.

    Holds *all* records with valid (user, item, rating) triples — not just
    positives — because Stage-A feature engineering needs the full review
    stream (main.py:247-373) while Stage-B uses only positives.
    """

    user_ids: List[str]               # idx -> raw user id
    item_ids: List[str]               # idx -> raw item id
    user2idx: Dict[str, int]
    item2idx: Dict[str, int]

    uidx: np.ndarray                  # (N,) int32
    iidx: np.ndarray                  # (N,) int32
    rating: np.ndarray                # (N,) float32
    timestamp: np.ndarray             # (N,) int64, -1 if missing
    helpful_vote: np.ndarray          # (N,) float32, nan if missing
    verified: np.ndarray              # (N,) float32 in {0,1}
    split: np.ndarray                 # (N,) int8 (md5 bucket of (uid,iid))
    positive: np.ndarray              # (N,) bool (rating >= threshold)

    # Lexical summaries for Stage-A features (token counts only; raw text is
    # never retained).
    tok_count: np.ndarray             # (N,) int32
    uniq_tok_count: np.ndarray        # (N,) int32

    extra: dict = field(default_factory=dict)

    @property
    def num_users(self) -> int:
        return len(self.user_ids)

    @property
    def num_items(self) -> int:
        return len(self.item_ids)

    @property
    def num_records(self) -> int:
        return int(self.uidx.shape[0])

    def positive_edges(self, split: Optional[int] = None) -> np.ndarray:
        """(2, E) int32 positive edges, optionally restricted to a split.

        NOTE: indices here are over the *full* interaction vocabulary.  Use
        :func:`compact_positive_graph` to renumber to the positive-only
        vocabulary that matches the reference Stage-B id space.
        """
        mask = self.positive
        if split is not None:
            mask = mask & (self.split == split)
        return np.stack([self.uidx[mask], self.iidx[mask]]).astype(np.int32)


_TOKEN_RE = None


def tokenize(text: str):
    global _TOKEN_RE
    if _TOKEN_RE is None:
        import re
        _TOKEN_RE = re.compile(r"[A-Za-z]+(?:'[A-Za-z]+)?")
    return _TOKEN_RE.findall(text.lower())


def ingest_jsonl(path, cfg: Optional[IngestConfig] = None,
                 with_text_stats: bool = True,
                 collect_token_hashes: bool = False) -> InteractionTable:
    """One streaming pass: parse, intern, hash-split, columnarize.

    The reference does two passes to avoid holding edges in RAM
    (lightgcn.py:167-233); with columnar growth buffers a single pass is
    both simpler and faster, and produces identical arrays (verified by the
    split-count parity test).
    """
    cfg = cfg or IngestConfig(jsonl_path=str(path))
    if cfg.backend in ("auto", "native"):
        from .native import ingest_native
        try:
            ingest_native.load_library()
        except ImportError:
            if cfg.backend == "native":
                raise
        else:
            return ingest_native.ingest_jsonl_native(
                path, cfg, with_text_stats, collect_token_hashes)

    user_ids: List[str] = []
    item_ids: List[str] = []
    user2idx: Dict[str, int] = {}
    item2idx: Dict[str, int] = {}

    uidx, iidx, rating, ts, helpful, verified, split, positive = (
        [], [], [], [], [], [], [], [])
    tok_count, uniq_tok = [], []
    tok_pairs: List[tuple] = []  # (uidx, token_hash) for v1 corpus-level LD

    # Label-rule counters over ALL records with a user id (the reference's
    # step1 counts reviews even when item/rating are missing, main.py:163-176)
    label_total: Dict[str, int] = {}
    label_helpful: Dict[str, int] = {}

    for _, rec in iter_jsonl_records(path, cfg.decode_errors):
        uid = rec.get(cfg.user_key)
        iid = rec.get(cfg.item_key)
        r = to_float(rec.get(cfg.rating_key))

        if uid:
            label_total[uid] = label_total.get(uid, 0) + 1
            hv_raw = rec.get("helpful_vote", 0)
            try:
                hv_int = int(hv_raw)
            except Exception:
                hv_int = 0
            if hv_int > 5:
                label_helpful[uid] = label_helpful.get(uid, 0) + 1

        if uid is None or iid is None or r is None:
            continue

        u = user2idx.get(uid)
        if u is None:
            u = len(user_ids)
            user2idx[uid] = u
            user_ids.append(uid)
        it = item2idx.get(iid)
        if it is None:
            it = len(item_ids)
            item2idx[iid] = it
            item_ids.append(iid)

        uidx.append(u)
        iidx.append(it)
        rating.append(r)

        t = rec.get("timestamp")
        try:
            t = int(t)
        except Exception:
            t = -1
        ts.append(t)

        hv = to_float(rec.get("helpful_vote"))
        helpful.append(np.nan if hv is None else hv)
        verified.append(1.0 if bool(rec.get("verified_purchase", False)) else 0.0)

        split.append(md5_split_bucket(uid, iid, cfg.train_p, cfg.val_p))
        positive.append(r >= cfg.pos_rating_threshold)

        if with_text_stats:
            text = (rec.get("title") or "") + " " + (rec.get("text") or "")
            toks = tokenize(text)
            n, uniq_set = len(toks), set(toks)
            nu = len(uniq_set)
            if collect_token_hashes:
                for tk in uniq_set:
                    tok_pairs.append((u, hash(tk) & 0x7FFFFFFFFFFFFFFF))
        else:
            n, nu = 0, 0
        tok_count.append(n)
        uniq_tok.append(nu)

    extra: dict = {"label_total": label_total, "label_helpful": label_helpful}
    if collect_token_hashes:
        num_users = len(user_ids)
        if tok_pairs:
            pairs = np.unique(np.asarray(tok_pairs, dtype=np.int64), axis=0)
            extra["user_unique_tokens"] = np.bincount(
                pairs[:, 0], minlength=num_users).astype(np.int64)
        else:
            extra["user_unique_tokens"] = np.zeros(num_users, np.int64)

    return InteractionTable(
        user_ids=user_ids,
        item_ids=item_ids,
        user2idx=user2idx,
        item2idx=item2idx,
        uidx=np.asarray(uidx, dtype=np.int32),
        iidx=np.asarray(iidx, dtype=np.int32),
        rating=np.asarray(rating, dtype=np.float32),
        timestamp=np.asarray(ts, dtype=np.int64),
        helpful_vote=np.asarray(helpful, dtype=np.float32),
        verified=np.asarray(verified, dtype=np.float32),
        split=np.asarray(split, dtype=np.int8),
        positive=np.asarray(positive, dtype=bool),
        tok_count=np.asarray(tok_count, dtype=np.int32),
        uniq_tok_count=np.asarray(uniq_tok, dtype=np.int32),
        extra=extra,
    )

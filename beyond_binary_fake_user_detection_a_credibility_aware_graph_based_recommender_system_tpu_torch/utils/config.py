"""Configuration system.

The reference has no config system at all: each script carries a frozen
``@dataclass CFG`` instantiated at import time that users edit in place
(``reference lightgcn.py:20-56``, ``main.py:42-100``).  Here every
reference script becomes a :class:`RecConfig` preset (see
``configs/presets.py``) that can be overridden from dicts, JSON files, or
``key=value`` CLI arguments.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple


def _coerce(value: str, typ) -> Any:
    """Coerce a CLI string to a dataclass field type.  With ``from
    __future__ import annotations`` the field type is its *string* form, so
    match on names."""
    name = typ if isinstance(typ, str) else getattr(typ, "__name__", str(typ))
    if "bool" in name:
        return value.lower() in ("1", "true", "yes", "on")
    if "int" in name and "Tuple" not in name and "tuple" not in name:
        return int(value)
    if "float" in name:
        return float(value)
    if "Tuple" in name or "tuple" in name:
        return tuple(int(v) for v in value.strip("()").split(",") if v)
    if "Optional[str]" in name or name == "str":
        return value
    return value


@dataclass
class ConfigBase:
    """Dataclass config with dict / JSON / CLI override support."""

    def replace(self, **kwargs) -> "ConfigBase":
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)

    @classmethod
    def from_json(cls, path):
        """Load a config from a JSON file (tuples restored from lists)."""
        with open(path) as f:
            d = json.load(f)
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for k, v in list(d.items()):
            if isinstance(v, list) and k in fields and                     "Tuple" in str(fields[k].type):
                d[k] = tuple(v)
        return cls.from_dict(d)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"Unknown config keys for {cls.__name__}: {sorted(unknown)}")
        return cls(**d)

    def with_overrides(self, overrides: Sequence[str]) -> "ConfigBase":
        """Apply ``key=value`` string overrides (CLI style)."""
        fields = {f.name: f for f in dataclasses.fields(self)}
        updates: Dict[str, Any] = {}
        for ov in overrides:
            if "=" not in ov:
                raise ValueError(f"Override must be key=value, got {ov!r}")
            k, v = ov.split("=", 1)
            if k not in fields:
                raise ValueError(f"Unknown config key {k!r}; valid: {sorted(fields)}")
            updates[k] = _coerce(v, fields[k].type)
        return dataclasses.replace(self, **updates)


# ---------------------------------------------------------------------------
# Stage-B recommender configs
# ---------------------------------------------------------------------------

#: Propagation semantics. The reference family has three distinct orders
#: (SURVEY.md C20/C21/C22):
#:   "symmetric"      — joint (U+I)^2 adjacency D^-1/2 A D^-1/2, lightgcn.py:352-372
#:   "bipartite_sync" — Jacobi: i_{k+1}=M@u_k, u_{k+1}=M'@i_k, lightgcn_cu.py:420-448
#:   "gauss_seidel"   — i_{k+1}=M@u_k then u_{k+1}=M'@i_{k+1},
#:                      version_1/lightgcn_cu_message.py:391-433
PROPAGATION_MODES = ("symmetric", "bipartite_sync", "gauss_seidel")

#: Per-edge weight recipes (all become a weight vector fused into the same
#: SpMM kernel; SURVEY.md C16-C19):
#:   "symmetric"   — 1/sqrt(deg_r deg_c) on the joint graph
#:   "cred_eq322"  — item<-user: cred_u/sqrt(max(du*di,1e-12));
#:                   user<-item: 1/sqrt(max(du*di,1e-12))  (lightgcn_cu.py:368-399)
#:   "cu_message"  — base 1/sqrt(max(du,1)*max(di,1)); cred on item<-user only
#:                   (version_1/lightgcn_cu_message.py:347-385)
#:   "degree_aware"— cu_message * alpha_i, alpha_i = 1/log1p(max(di,1)) on both
#:                   directions (version_1/..._Degree-Aware Message.py:349-403)
WEIGHT_MODES = ("symmetric", "cred_eq322", "cu_message", "degree_aware")

NEGATIVE_SAMPLERS = ("uniform", "popmix")

#: SpMM backends: "auto" (CSR kernel), "torch" (plain versions), "chunked"
#: (chunk plans; the JAX package's "pallas")
SPMM_BACKENDS = ("auto", "torch", "chunked")


def kernel_backend(spmm_backend: str) -> str:
    """The backend of every kernel but the SpMM (the row gathers' backward,
    Adam, the mesh's local sums) under ``spmm_backend``: "chunked" only
    changes the SpMM's layout, so those run as under "auto"."""
    if spmm_backend not in SPMM_BACKENDS:
        raise ValueError(f"unknown spmm backend {spmm_backend!r}")
    return "auto" if spmm_backend == "chunked" else spmm_backend


@dataclass
class RecConfig(ConfigBase):
    """Stage-B (LightGCN-family) training configuration.

    Defaults mirror the shared hyperparameters of all six reference scripts
    (emb_dim=64, layers=3, lr=1e-3, reg=1e-4, batch 4096, 400 epochs, Adam,
    sampled eval with 99 negatives, model selection on val Recall@20).
    """

    name: str = "vanilla"

    # Model
    emb_dim: int = 64
    num_layers: int = 3
    propagation: str = "symmetric"
    weight_mode: str = "symmetric"
    # Embedding parameter layout: "joint" = one (U+I, D) table
    # (lightgcn.py:315), "split" = separate user/item tables
    # (lightgcn_cu.py:415-418).  Affects the ego L2 term and init stream only.
    table_layout: str = "joint"

    # Optimization
    lr: float = 1e-3
    reg: float = 1e-4                 # lambda_reg on ego-embedding L2
    lambda_fair: float = 0.0          # Eq 3.27 fairness term (lightgcn_cu.py:61)
    epochs: int = 400
    batch_size: int = 4096
    seed: int = 42

    # Negative sampling
    negative_sampler: str = "uniform"
    neg_mix_pop: float = 0.7          # Method E (Version-2/lighgcn_cu_pop.py:66)
    neg_pop_gamma: float = 0.75       # pop^gamma on (deg+1)
    neg_rounds: int = 8               # bounded batched-rejection rounds on device

    # Evaluation
    Ks: Tuple[int, ...] = (10, 20)
    eval_every: int = 1
    eval_mode: str = "sampled"        # "sampled" | "full"
    # full-catalog ranking op: "exact" and "approx" both rank with the
    # exact ops/topk_select here.  The JAX package maps "approx" to the TPU's
    # lax.approx_max_k; the port keeps the value so that presets and saved
    # configs load unchanged (a deliberate divergence, ROADMAP.md Queue 3).
    eval_topk: str = "exact"
    # full-catalog score matmul + ranking dtype: "bf16" halves score-matrix
    # bandwidth
    eval_score_dtype: str = "fp32"
    # users per full-catalog eval batch.  Metrics are batch-invariant (the
    # last chunk is padded + masked); evaluate_full clamps the batch on
    # small graphs.
    eval_batch: int = 512
    sampled_negatives: int = 99
    extended_metrics: bool = False    # coverage/novelty/cred-utility/group recall
    cred_group_pct: float = 0.20

    # Credibility input (Stage A -> Stage B contract)
    cred_csv_path: Optional[str] = None

    # Propagation schedule: "per_batch" recomputes the full K-layer
    # propagation every batch (reference-faithful, lightgcn.py:584);
    # "per_epoch" caches it across an epoch (fast mode).
    propagation_schedule: str = "per_batch"

    # Kernel backend: "auto" launches the hand-written CUDA kernels (the
    # CSR SpMM and, in training, the fused Adam update) for CUDA tensors and
    # runs their plain PyTorch versions for CPU tensors; "torch" forces the
    # plain versions (the reference run that the kernels are held against);
    # "chunked" runs the SpMM on dst-sliced chunk plans in the padded chain
    # (the staged chunk kernel; the JAX package's "pallas"), every other
    # kernel as "auto" does (kernel_backend).  "bf16" precision quantizes
    # the SpMM messages and weights to bfloat16 with fp32 per-destination
    # accumulation, as the JAX package's Pallas kernel does; fp32 is the
    # reference-parity default.
    spmm_backend: str = "auto"        # "auto" | "torch" | "chunked"
    spmm_precision: str = "fp32"      # "fp32" (parity) | "bf16" (fast mode)
    # mesh-sharded propagation: "halo" = all-to-all of needed rows,
    # "allgather" = replicate the source table (parallel/sharded_spmm.py)
    sharded_spmm_mode: str = "auto"
    # sampler membership test: "hash" = exact bucketized hash table, one
    # slab gather per candidate (ops/membership.py); "bsearch" = CSR
    # binary search (table-free).  Bit-identical sampler outputs.
    membership: str = "hash"

    # Checkpointing
    out_dir: Optional[str] = None
    save_best: bool = True

    def validate(self) -> "RecConfig":
        assert self.propagation in PROPAGATION_MODES, self.propagation
        assert self.weight_mode in WEIGHT_MODES, self.weight_mode
        assert self.negative_sampler in NEGATIVE_SAMPLERS, self.negative_sampler
        assert self.eval_mode in ("sampled", "full"), self.eval_mode
        assert self.eval_topk in ("exact", "approx"), self.eval_topk
        assert self.eval_score_dtype in ("fp32", "bf16"), self.eval_score_dtype
        assert self.table_layout in ("joint", "split"), self.table_layout
        assert self.propagation_schedule in ("per_batch", "per_epoch")
        assert self.membership in ("hash", "bsearch"), self.membership
        assert self.spmm_backend in SPMM_BACKENDS, self.spmm_backend
        assert self.spmm_precision in ("fp32", "bf16"), self.spmm_precision
        if self.propagation == "symmetric":
            assert self.weight_mode == "symmetric", (
                "symmetric propagation uses the joint adjacency weights")
        return self


@dataclass
class IngestConfig(ConfigBase):
    """Raw-data ingestion configuration (reference lightgcn.py:20-56)."""

    jsonl_path: str = ""
    user_key: str = "user_id"
    item_key: str = "parent_asin"
    rating_key: str = "rating"
    pos_rating_threshold: float = 4.0
    train_p: float = 0.80
    val_p: float = 0.10
    test_p: float = 0.10
    decode_errors: str = "replace"
    backend: str = "auto"             # "auto" | "python" | "native"


@dataclass
class CredConfig(ConfigBase):
    """Stage-A credibility-model training configuration (main.py:42-100,609-660)."""

    # Labeling rule (main.py:63-65)
    helpful_vote_threshold: int = 5
    ru_genuine_th: float = 0.7
    ru_fake_th: float = 0.3

    # Feature engineering
    feature_set: str = "v0"           # "v0" = 6 features, "v1" = 8 features
    # graph columns: "cred7" = Ru + 6 even under v1 (reference parity,
    # version_1/main_v2_.py:94-102,612-622); "all" = every computed feature
    graph_feature_set: str = "cred7"
    tau_ms: int = 24 * 60 * 60 * 1000  # burst bucket, main.py:68
    etg_max_gap_days: int = 365        # v1 ETG cap

    # Model (main.py:93-97)
    hidden_dim: int = 64
    epochs: int = 100
    batch_size: int = 2048
    lr: float = 1e-3

    # EWA / SLAS / losses (main.py:626-658)
    beta: float = 1.0
    gamma: float = 1.0
    slas_kappa: float = 3.0
    slas_upweight_labeled: float = 1.0
    # SLAS candidate-pool width per node: None = graph max degree (exact
    # reference candidate sets).  REQUIRED at the 10M north star, where a
    # max-degree (I, P) neighbor table is memory-infeasible (zipf head
    # item ~1e5 neighbors); a cap keeps the first N CSR neighbors as the
    # Gumbel-top-k pool (ops/slas.py:SlasSampler.build).
    slas_pad_deg: Optional[int] = None
    k_user_neigh: int = 15
    k_item_neigh: int = 15
    lambda_smooth: float = 0.1
    lambda_cont: float = 0.1
    tau_temp: float = 0.2
    temp_split: float = 0.5

    # Trainer mode: "slas" (default) reproduces the reference's SLAS
    # subgraph sampling as fixed-shape on-device Gumbel-top-k — it is the
    # reference-faithful mode (rank corr 0.965 vs the SLAS oracle with
    # near-identical score percentiles, docs/QUALITY_PARITY.md);
    # "full_graph" runs the two-layer EWA aggregation over the whole graph
    # per step (faster, graph fits on a chip) but compresses the score
    # distribution (p10 0.45 vs oracle 0.25) — a measured deviation, so it
    # is opt-in rather than the default ("reproduce, don't fix").
    trainer_mode: str = "slas"
    contrastive_batch: int = 2048
    seed: int = 42

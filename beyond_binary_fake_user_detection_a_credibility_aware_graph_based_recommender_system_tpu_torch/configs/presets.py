"""Config presets: one per reference script (BASELINE.json `configs`).

| preset          | reference script                                      |
|-----------------|-------------------------------------------------------|
| vanilla         | lightgcn.py (400 ep) / lightgcn-1.py (200 ep)         |
| cred_eq322      | lightgcn_cu.py (Eq 3.22-3.28, sync bipartite, fair)   |
| cu_message      | version_1/lightgcn_cu_message.py (Gauss-Seidel)       |
| degree_aware    | version_1/lightgcn_cu_pop_Degree-Aware Message.py     |
| pop_neg         | version_1/lightgcn_cu_pop_method-e.py (Method E)      |
| pop_extended    | Version-2/lighgcn_cu_pop.py (Method E + extended eval)|
| scaled_10m      | north-star 10M+-edge multi-host config (BASELINE.json)|
"""

from __future__ import annotations

from ..utils.config import RecConfig

PRESETS = {}


def _register(cfg: RecConfig) -> RecConfig:
    PRESETS[cfg.name] = cfg
    return cfg


vanilla = _register(RecConfig(
    name="vanilla",
    propagation="symmetric", weight_mode="symmetric", table_layout="joint",
    epochs=400,
))

vanilla_200 = _register(RecConfig(
    name="vanilla_200",
    propagation="symmetric", weight_mode="symmetric", table_layout="joint",
    epochs=200,
))

cred_eq322 = _register(RecConfig(
    name="cred_eq322",
    propagation="bipartite_sync", weight_mode="cred_eq322",
    table_layout="split", lambda_fair=0.0,  # lightgcn_cu.py:61 default
    epochs=400,
))

cred_eq322_fair = _register(RecConfig(
    name="cred_eq322_fair",
    propagation="bipartite_sync", weight_mode="cred_eq322",
    table_layout="split", lambda_fair=1e-2,  # "set e.g. 1e-2 to enable"
    epochs=400,
))

cu_message = _register(RecConfig(
    name="cu_message",
    propagation="gauss_seidel", weight_mode="cu_message",
    table_layout="split", epochs=400,
))

degree_aware = _register(RecConfig(
    name="degree_aware",
    propagation="gauss_seidel", weight_mode="degree_aware",
    table_layout="split", epochs=400,
))

pop_neg = _register(RecConfig(
    name="pop_neg",
    propagation="gauss_seidel", weight_mode="cu_message",
    table_layout="split", negative_sampler="popmix",
    neg_mix_pop=0.7, neg_pop_gamma=0.75, epochs=400,
))

pop_extended = _register(RecConfig(
    name="pop_extended",
    propagation="gauss_seidel", weight_mode="cu_message",
    table_layout="split", negative_sampler="popmix",
    neg_mix_pop=0.7, neg_pop_gamma=0.75, epochs=400,
    extended_metrics=True, cred_group_pct=0.20,
))

scaled_10m = _register(RecConfig(
    name="scaled_10m",
    propagation="gauss_seidel", weight_mode="cu_message",
    table_layout="split", negative_sampler="popmix",
    emb_dim=128, num_layers=4, batch_size=8192, epochs=50,
    eval_mode="full", propagation_schedule="per_epoch",
    spmm_backend="auto",
    # Message precision: fp32, decided by a same-day A/B at THIS
    # operating point (round 5, runs/scaling_terms{_bf16,_fp32}.json):
    # full training epoch 2.099 s fp32 vs 2.166 s bf16, standalone
    # K=4 propagate 0.402 s fp32 vs 0.470 s bf16 (bf16 17% SLOWER at
    # D=128 — the windowed one-hot MXU pass dominates here, not the
    # gather bytes bf16 halves; at the reference scale D=64 per_batch
    # bf16 is a measured 1.33x WIN and stays the recommended fast mode,
    # docs/PRECISION.md).  fp32 buys exact parity arithmetic AND the
    # faster epoch, so it ships.  The scaling projection reads this field
    # (scripts/scaling_projection.py:preset_constants) so its collective
    # bytes can never silently diverge from the preset again
    # (VERDICT r4 item 1).
    spmm_precision="fp32",
    # approx_max_k + bf16 score eval: metrics identical to the exact fp32
    # protocol to all printed digits at this scale, 2.96x faster end to
    # end (756.7 -> 255.3 s/12-epoch protocol, runs/SUMMARY.md round 3).
    # NOTE this preset's eval is therefore APPROXIMATE BY DEFAULT —
    # parity/oracle runs must override eval_topk=exact
    # eval_score_dtype=fp32 (docs/QUALITY_PARITY.md).  Under --mesh both
    # flags are honored too: the sharded top-k runs approx local top-k /
    # bf16 shard matmuls with an exact final merge
    # (parallel/sharded_topk.py).
    eval_topk="approx",
    eval_score_dtype="bf16",
    # eval_batch stays at the 512 default.  Raising it to 4096 measures
    # 3x faster (13.5 -> 4.4 s/eval) but the speed is a mirage: XLA's
    # approx_top_k candidate buffer no longer fits the 16 MB scoped VMEM
    # at (4096, 1M), and instead of failing the bf16 path silently
    # shrinks the reduction — top-20 Jaccard vs the 512-batch result
    # collapses to 0.25 and planted-graph R@20 drops 0.080 -> 0.057
    # (fp32 at the same shape refuses to compile with a scoped-vmem
    # error, which is how the mechanism was confirmed).  evaluate_full
    # warns if approx is combined with batch > 1024; see
    # RecConfig.eval_batch and runs/SUMMARY.md round 5.
))


def get_preset(name: str, **overrides) -> RecConfig:
    if name not in PRESETS:
        raise KeyError(f"Unknown preset {name!r}; available: {sorted(PRESETS)}")
    cfg = PRESETS[name]
    return cfg.replace(**overrides) if overrides else cfg

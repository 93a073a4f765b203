"""Stage-B trainer: construction and evaluation of saved parameters.

The serving slice of the JAX package's ``RecTrainer``: the constructor
(credibility vector, the model's edge operators, the evaluation context) and
``evaluate``.  The optimizer, the samplers of training and ``fit`` come
with the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data.cred_io import load_credibility_vector
from ..eval.ranking import EvalContext, evaluate_full, evaluate_sampled
from ..graph.build import BipartiteGraph
from ..models.lightgcn import LightGCN
from ..utils.config import RecConfig
from ..utils.device import resolve_device


def format_metrics_block(title: str, res: Dict[int, Dict[str, float]]) -> str:
    """Reference-format metric block for parity diffing against the captured
    ``.out`` logs (lightgcn.py:608-611; extended-metric fields in the same
    K= line per Version-2/lighgcn_cu_pop.py:888-933)."""
    lines = [f"{title} metrics:"]
    for K in sorted(res):
        r = res[K]
        ext = ""
        if "item_coverage" in r:
            ext = (f"COV={r['item_coverage']:.4f} "
                   f"LogPop={r['avg_log_popularity']:.4f} "
                   f"SI={r['avg_self_information']:.4f} ")
            # cred-group fields exist only when extended eval ran with a
            # cred vector (evaluate_full(cred=None) omits them)
            if "cred_utility" in r:
                ext += (f"CredU={r['cred_utility']:.4f} "
                        f"HighR={r['high_cred_recall']:.4f} "
                        f"LowR={r['low_cred_recall']:.4f} ")
        lines.append(
            f"  K={K}: P={r['precision']:.4f} R={r['recall']:.4f} "
            f"NDCG={r['ndcg']:.4f} {ext}({r['mode']})")
    return "\n".join(lines)


class RecTrainer:
    def __init__(self, cfg: RecConfig, graph: BipartiteGraph,
                 cred: Optional[np.ndarray] = None, device="cuda"):
        cfg.validate()
        self.cfg = cfg
        self.graph = graph
        self.device = resolve_device(device)

        if cred is None and cfg.cred_csv_path:
            cred = load_credibility_vector(cfg.cred_csv_path, graph.num_users,
                                           graph.user2idx)
        self.cred = cred if cred is not None else np.ones(
            graph.num_users, np.float32)

        self.model = LightGCN(cfg, graph, self.cred, device=self.device)
        self.ctx = EvalContext.build(graph, self.device,
                                     membership=cfg.membership)

        self.train_users = np.nonzero(graph.user_csr("train").degrees() > 0)[0]
        if self.train_users.size == 0:
            raise RuntimeError("No train users with interactions.")

    @torch.no_grad()
    def evaluate(self, params: Dict[str, torch.Tensor], split: str,
                 gen: Optional[torch.Generator] = None,
                 extended: Optional[bool] = None):
        """Metrics of ``params`` (tensors on any device) on ``split``.
        Sampled mode draws from ``gen``, by default the dedicated eval
        stream seeded ``cfg.seed + 999`` (reference lightgcn.py:406)."""
        cfg = self.cfg
        extended = cfg.extended_metrics if extended is None else extended
        params = {k: v.to(self.device) for k, v in params.items()}
        user_emb, item_emb = self.model.propagate(params)
        if cfg.eval_mode == "full":
            return evaluate_full(user_emb, item_emb, self.ctx, split,
                                 Ks=cfg.Ks, batch=cfg.eval_batch,
                                 extended=extended, cred=self.cred,
                                 cred_group_pct=cfg.cred_group_pct,
                                 topk=cfg.eval_topk,
                                 score_dtype=cfg.eval_score_dtype)
        if gen is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(cfg.seed + 999)
        return evaluate_sampled(gen, user_emb, item_emb, self.ctx, split,
                                Ks=cfg.Ks, n_negatives=cfg.sampled_negatives,
                                extended=extended, cred=self.cred,
                                cred_group_pct=cfg.cred_group_pct)

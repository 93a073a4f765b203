"""Stage-B trainer: BPR training over any LightGCN variant, and evaluation.

The port of the JAX package's ``RecTrainer`` on one device:

  * one epoch draws a permutation of the train users, pads it to
    ``nb * batch_size`` with user 0 and a validity mask (the last batch is
    padded and masked, never dropped, reproducing the reference's
    variable-length final batch), and samples every batch's positive and
    negative up front;
  * each step runs the batch-row loss (propagation through the SpMM kernel,
    BPR + ego L2 (+ fairness)), its backward (the same kernel on each
    operator's transpose, and on the gather plans of the step's users and
    items for every batch-row gather, ``ops/gather.py``) and one fused Adam
    kernel launch per parameter table, updating parameters and moments in
    place; ``run_epoch`` builds every step's plans once, from the drawn
    batches;
  * "per_batch" recomputes the K-layer propagation in every step
    (reference-faithful, lightgcn.py:584); "per_epoch" caches the
    propagated rest once per epoch and keeps the ego term live;
  * model selection on val Recall@max(Ks) with best-params keep
    (lightgcn.py:605-616), a final test on the best params.

The loss stays on the device; the host reads it once per epoch.  A step is
deterministic on the card (see :func:`deterministic_algorithms`), so a fit
is bit-reproducible per seed, as the JAX package's is.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.deterministic

from ..data.cred_io import load_credibility_vector
from ..eval.ranking import EvalContext, evaluate_full, evaluate_sampled
from ..graph.build import BipartiteGraph
from ..models import losses
from ..models.lightgcn import LightGCN, Params, ego_tables, init_params
from ..ops.adam import AdamState, adam_init, adam_step
from ..ops.gather import GatherPlan, gather_plans, gather_rows
from ..ops.sampling import (PopMixSampler, sample_negatives_popmix,
                            sample_negatives_uniform, sample_positives)
from ..utils.config import RecConfig
from ..utils.device import resolve_device
from .checkpoint import TrainCheckpointer, save_params_npz

Batches = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# one step's gather plans: its users into the user rows, its positives and
# negatives (one vector, positives first) into the item rows
StepPlans = Tuple[GatherPlan, GatherPlan]


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


@contextlib.contextmanager
def deterministic_algorithms():
    """Run the enclosed training step with deterministic kernels only.

    The SpMM and Adam kernels use no atomics, and the training steps' row
    gathers take the SpMM kernel as their backward (``ops/gather.py``).
    Row gathers left stock (those of Stage A's SLAS mode) have
    ``index_put_`` with accumulation as their backward, which on CUDA sorts
    the indices and sums each row's duplicates in order; this mode makes
    PyTorch keep to such implementations and raise on any op that has
    none.  Memory from
    ``torch.empty`` is not pre-filled: every kernel writes all it allocates.
    The previous settings come back on exit.

    The switch is ATen's own: ``torch.use_deterministic_algorithms`` also
    imports ``torch._inductor`` to set the compiler's flag, which costs
    seconds on its first call, and the port compiles nothing."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.utils.deterministic.fill_uninitialized_memory)
    torch._C._set_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch._C._set_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.utils.deterministic.fill_uninitialized_memory = prev[2]


def _clone(params: Params) -> Params:
    return {k: v.detach().clone() for k, v in params.items()}


@dataclass
class TrainLogEntry:
    epoch: int
    loss: float
    val: Optional[Dict[int, Dict[str, float]]] = None
    seconds: float = 0.0


@dataclass
class FitResult:
    best_params: Params
    best_val_recall: float
    test_metrics: Dict[int, Dict[str, float]]
    history: list = field(default_factory=list)


class RecTrainer:
    def __init__(self, cfg: RecConfig, graph: BipartiteGraph,
                 cred: Optional[np.ndarray] = None, device="cuda",
                 verbose: bool = True, operator_factory=None, mesh=None):
        """``mesh``: a (data, model) ``DeviceMesh`` (``parallel/mesh.py``)
        on ``device``.  The model then propagates through edge-sharded
        operators (``parallel/sharded_spmm.py``, padded chain, mode
        ``cfg.sharded_spmm_mode``) and full-catalogue evaluation ranks
        through the distributed top-k; ``fit`` under a mesh is ROADMAP.md
        Queue 1 item 11b.  ``operator_factory(edge_map)`` builds the
        model's operators in place of either default."""
        cfg.validate()
        self.cfg = cfg
        self.graph = graph
        self.device = resolve_device(device)
        self.verbose = verbose
        self.mesh = mesh
        if mesh is not None and operator_factory is None:
            import functools
            from ..parallel.sharded_spmm import ShardedSpmmOperator
            operator_factory = functools.partial(
                ShardedSpmmOperator, mesh=mesh, mode=cfg.sharded_spmm_mode,
                backend=cfg.spmm_backend, precision=cfg.spmm_precision)

        if cred is None and cfg.cred_csv_path:
            cred = load_credibility_vector(cfg.cred_csv_path, graph.num_users,
                                           graph.user2idx)
        self.cred = cred if cred is not None else np.ones(
            graph.num_users, np.float32)

        self.model = LightGCN(cfg, graph, self.cred, device=self.device,
                              operator_factory=operator_factory)
        self.ctx = EvalContext.build(graph, self.device,
                                     membership=cfg.membership)

        deg_i = graph.train_item_degrees()
        self.pop_norm = torch.as_tensor(
            deg_i / max(float(deg_i.max()), 1.0), dtype=torch.float32,
            device=self.device)

        self.train_users = np.nonzero(graph.user_csr("train").degrees() > 0)[0]
        if self.train_users.size == 0:
            raise RuntimeError("No train users with interactions.")
        self.train_users_dev = torch.as_tensor(self.train_users,
                                               dtype=torch.int64,
                                               device=self.device)

        self.popmix = None
        if cfg.negative_sampler == "popmix":
            self.popmix = PopMixSampler.build(
                deg_i, self.device, mix_pop=cfg.neg_mix_pop,
                gamma=cfg.neg_pop_gamma)

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None
                   ) -> Tuple[Params, AdamState, torch.Generator]:
        """Xavier parameters and zero Adam moments from a generator seeded
        ``seed`` (default ``cfg.seed``); the generator then draws the
        epochs."""
        seed = self.cfg.seed if seed is None else seed
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params = init_params(gen, self.cfg, self.graph.num_users,
                             self.graph.num_items)
        return params, adam_init(params), gen

    def _sample_epoch(self, gen: torch.Generator, users_flat: torch.Tensor):
        """One vectorized positive and negative draw for every batch of the
        epoch (each user's samples are iid either way)."""
        csr = self.ctx.train_csr
        pos = sample_positives(gen, csr, users_flat)
        if self.popmix is not None:
            neg = sample_negatives_popmix(gen, csr, users_flat, self.popmix,
                                          rounds=self.cfg.neg_rounds)
        else:
            neg = sample_negatives_uniform(gen, csr, users_flat,
                                           self.graph.num_items,
                                           rounds=self.cfg.neg_rounds)
        return pos, neg

    def draw_epoch(self, gen: torch.Generator) -> Batches:
        """``(users, pos, neg, mask)``, each ``(nb, batch_size)``: a
        permutation of the train users padded with user 0, its samples, and
        the validity mask of the padded tail."""
        B = self.cfg.batch_size
        n = self.train_users.size
        nb = -(-n // B)
        perm = self.train_users_dev[torch.randperm(n, generator=gen,
                                                   device=self.device)]
        pad = torch.zeros(nb * B - n, dtype=torch.int64, device=self.device)
        users_flat = torch.cat([perm, pad])
        pos, neg = self._sample_epoch(gen, users_flat)
        mask = torch.arange(nb * B, device=self.device) < n
        return tuple(x.reshape(nb, B) for x in (users_flat, pos, neg, mask))

    # ------------------------------------------------------------------
    def step_plans(self, users: torch.Tensor, pos: torch.Tensor,
                   neg: torch.Tensor) -> List[StepPlans]:
        """The gather plans of every step of ``(nb, B)`` batches, built at
        once on their device (``ops/gather.gather_plans``)."""
        return list(zip(
            gather_plans(users, self.graph.num_users),
            gather_plans(torch.cat([pos, neg], dim=1), self.graph.num_items)))

    def _loss_fn(self, params: Params, users, pos, neg, mask,
                 cached_rest: Optional[Tuple[torch.Tensor, torch.Tensor]]
                 = None, plans: Optional[StepPlans] = None) -> torch.Tensor:
        """The step's loss; with ``plans`` (:meth:`step_plans`) every
        batch-row gather has the segment-sum backward, without them the
        plain ``x[rows]``."""
        B = users.shape[0]
        items = torch.cat([pos, neg])
        p_u, p_i = plans or (None, None)
        bk = self.cfg.spmm_backend
        if cached_rest is None:
            # batch-row combine: gather each layer's batch rows and average
            # B-row vectors instead of the full tables (bit-identical scores)
            u_rows, i_rows = self.model.propagate_rows(params, users, items,
                                                       plans)
        else:
            # "per_epoch": the propagated rest is cached (constant within
            # the epoch) but the layer-0 ego term comes from the CURRENT
            # params, so BPR gradients flow (a cached whole table would
            # leave only L2)
            rest_u, rest_i = cached_rest
            ego_u, ego_i = ego_tables(params, self.graph.num_users)
            scale = 1.0 / (self.cfg.num_layers + 1)
            u_rows = gather_rows(rest_u + scale * ego_u, users, p_u, bk)
            i_rows = gather_rows(rest_i + scale * ego_i, items, p_i, bk)
        # Eq 3.26 (LightGCN.score) on the gathered rows
        pos_s = (u_rows * i_rows[:B]).sum(-1)
        neg_s = (u_rows * i_rows[B:]).sum(-1)
        loss = losses.bpr_loss(pos_s, neg_s, mask)
        ego_u, ego_i = ego_tables(params, self.graph.num_users)
        ego_items = gather_rows(ego_i, items, p_i, bk)
        reg = losses.ego_l2(gather_rows(ego_u, users, p_u, bk),
                            ego_items[:B], ego_items[B:], mask)
        loss = loss + self.cfg.reg * reg
        if self.cfg.lambda_fair != 0.0:
            fair = losses.fairness_loss(self.pop_norm[pos], pos_s, mask)
            loss = loss + self.cfg.lambda_fair * fair
        return loss

    def _epoch_cache(self, params: Params
                    ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The "per_epoch" schedule's cached propagation minus its ego term
        (None under "per_batch")."""
        if self.cfg.propagation_schedule != "per_epoch":
            return None
        with torch.no_grad():
            user_emb, item_emb = self.model.propagate(params)
            ego_u, ego_i = ego_tables(params, self.graph.num_users)
            scale = 1.0 / (self.cfg.num_layers + 1)
            return user_emb - scale * ego_u, item_emb - scale * ego_i

    def train_step(self, params: Params, opt_state: AdamState, users, pos,
                   neg, mask, cached_rest=None,
                   plans: Optional[StepPlans] = None) -> torch.Tensor:
        """One BPR step: loss, gradients, and the in-place Adam update of
        ``params`` and ``opt_state``.  Returns the step's loss (a 0-d
        tensor on the device).  ``plans`` are the step's gather plans
        (:meth:`step_plans`); without them the step builds its own, which
        waits for the batch to reach the host."""
        if plans is None:
            plans = self.step_plans(users[None], pos[None], neg[None])[0]
        with deterministic_algorithms():
            leaves = {k: p.detach().requires_grad_() for k, p in
                      params.items()}
            loss = self._loss_fn(leaves, users, pos, neg, mask, cached_rest,
                                 plans)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            adam_step(params, dict(zip(leaves, grads)), opt_state,
                      self.cfg.lr, backend=self.cfg.spmm_backend)
        return loss.detach()

    def run_epoch(self, params: Params, opt_state: AdamState,
                  batches: Batches) -> torch.Tensor:
        """Every step of one epoch over pre-drawn ``(users, pos, neg,
        mask)`` batches, whose gather plans are built first, all at once;
        returns the per-step losses on the device."""
        users_all, pos_all, neg_all, mask_all = batches
        plans = self.step_plans(users_all, pos_all, neg_all)
        cached = self._epoch_cache(params)
        return torch.stack([
            self.train_step(params, opt_state, users_all[s], pos_all[s],
                            neg_all[s], mask_all[s], cached, plans[s])
            for s in range(users_all.shape[0])])

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, params: Params, split: str,
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
                                 mesh=self.mesh, topk=cfg.eval_topk,
                                 score_dtype=cfg.eval_score_dtype)
        if gen is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(cfg.seed + 999)
        return evaluate_sampled(gen, user_emb, item_emb, self.ctx, split,
                                Ks=cfg.Ks, n_negatives=cfg.sampled_negatives,
                                extended=extended, cred=self.cred,
                                cred_group_pct=cfg.cred_group_pct)

    # ------------------------------------------------------------------
    def fit(self, epochs: Optional[int] = None, seed: Optional[int] = None,
            checkpointer: Optional[TrainCheckpointer] = None,
            resume: bool = False) -> FitResult:
        if self.mesh is not None:
            raise NotImplementedError(
                "fit under a mesh (row-sharded tables and Adam moments, "
                "sharded batches) is ROADMAP.md Queue 1 item 11b; a mesh "
                "serves only (evaluate)")
        cfg = self.cfg
        dev = self.device
        epochs = cfg.epochs if epochs is None else epochs
        params, opt_state, gen = self.init_state(seed)
        start_epoch = 1
        best_val = -1.0
        best_params = _clone(params)

        if checkpointer is not None and resume:
            state = checkpointer.restore()
            if state is not None:
                params = {k: v.to(dev) for k, v in state["params"].items()}
                opt = state["opt_state"]
                opt_state = AdamState(
                    m={k: v.to(dev) for k, v in opt["m"].items()},
                    v={k: v.to(dev) for k, v in opt["v"].items()},
                    count=int(opt["count"]))
                gen.set_state(state["gen_state"])
                start_epoch = int(state["epoch"]) + 1
                best_val = float(state["best_val"])
                best_params = {k: v.to(dev)
                               for k, v in state["best_params"].items()}
                self._log(f"[CKPT] resumed at epoch {start_epoch}")

        # the structured JSONL stream and the human lines share the product
        # path: `train-rec --out D` leaves D/metrics.jsonl
        metric_log = None
        if cfg.out_dir:
            from ..eval.report import MetricLogger
            metric_log = MetricLogger(f"{cfg.out_dir}/metrics.jsonl",
                                      echo=False)

        selK = max(cfg.Ks)
        history: List[TrainLogEntry] = []
        for epoch in range(start_epoch, epochs + 1):
            t0 = time.perf_counter()
            step_losses = self.run_epoch(params, opt_state,
                                         self.draw_epoch(gen))
            loss = float(step_losses.mean().item())
            dt = time.perf_counter() - t0
            self._log(f"Epoch {epoch:02d} | loss={loss:.6f}")

            entry = TrainLogEntry(epoch=epoch, loss=loss, seconds=dt)
            if epoch % cfg.eval_every == 0:
                val_res = self.evaluate(params, "val")
                entry.val = val_res
                self._log(format_metrics_block("VAL", val_res))
                val_score = val_res[selK]["recall"]
                if val_score > best_val:
                    best_val = val_score
                    best_params = _clone(params)
                    self._log(f"  saved best (val Recall@{selK}="
                              f"{best_val:.4f})")
                    if cfg.out_dir and cfg.save_best:
                        save_params_npz(f"{cfg.out_dir}/best_model.npz",
                                        best_params)
            if metric_log is not None:
                rec = {"event": "epoch", "epoch": epoch, "loss": loss,
                       "seconds": dt}
                if entry.val is not None:
                    rec["val"] = {str(K): v for K, v in entry.val.items()}
                    rec["best_val"] = best_val
                metric_log.log(rec)
            history.append(entry)

            if checkpointer is not None:
                checkpointer.save(epoch, {
                    "params": params,
                    "opt_state": {"m": opt_state.m, "v": opt_state.v,
                                  "count": opt_state.count},
                    "gen_state": gen.get_state(), "epoch": epoch,
                    "best_val": best_val, "best_params": best_params})

        if checkpointer is not None:
            checkpointer.wait()
        test_res = self.evaluate(best_params, "test")
        self._log("\nTEST " + format_metrics_block("TEST", test_res)[5:])
        if metric_log is not None:
            metric_log.log({"event": "test", "best_val": best_val,
                            "test": {str(K): v for K, v in test_res.items()}})
            metric_log.close()
        return FitResult(best_params=best_params, best_val_recall=best_val,
                         test_metrics=test_res, history=history)

    def _log(self, msg: str):
        if self.verbose:
            print(msg)

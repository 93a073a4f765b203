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

Under a (data, model) mesh the whole path runs sharded
(``parallel/sharding.py``), as the JAX package's does: every rank holds its
``ceil(N/P)`` rows of each table and of both Adam moments, every rank draws
the same whole epoch and trains on its data replica's columns of each batch
(so a mesh fit sees exactly the samples a one-device fit draws), the loss
combines whole tables, gradients are summed over the data axis, and rank 0
alone logs and writes files.
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
from ..ops.topk_select_cuda import MAX_K as TOPK_MAX_K
from ..utils.config import RecConfig, kernel_backend
from ..utils.device import resolve_device
from ..utils.profiling import span
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
        ``cfg.sharded_spmm_mode``), training runs the sharded step
        (``parallel/sharding.py``; ``cfg.batch_size`` must divide by the
        data axis) on this rank's blocks of the parameters, and
        full-catalogue evaluation ranks through the distributed top-k.
        ``operator_factory(edge_map)`` builds the model's operators in place
        of either default.  A full evaluation on one device takes
        ``max(cfg.Ks)`` up to ``ops/topk_select_cuda.MAX_K`` (256), on any
        device, so that a configuration that runs here runs on the card."""
        cfg.validate()
        if cfg.eval_mode == "full" and mesh is None \
                and max(cfg.Ks) > TOPK_MAX_K:
            raise ValueError(f"Ks = {cfg.Ks}: a full evaluation on one "
                             f"device ranks with ops/topk_select, which "
                             f"takes k up to {TOPK_MAX_K}")
        self.cfg = cfg
        self.graph = graph
        self.device = resolve_device(device)
        self.verbose = verbose
        self.mesh = mesh
        # the backend of the gathers' backward, Adam and the mesh's sums
        self._kernels = kernel_backend(cfg.spmm_backend)
        self._rank0 = True
        if mesh is not None:
            import functools
            import torch.distributed as dist
            from ..parallel.mesh import data_axis, model_axis
            from ..parallel.sharded_spmm import ShardedSpmmOperator
            self._model_axis = model_axis(mesh)
            self._data_axis = data_axis(mesh)
            if cfg.batch_size % self._data_axis.size:
                raise ValueError(
                    f"batch_size {cfg.batch_size} does not split over the "
                    f"{self._data_axis.size} data replicas of the mesh")
            self._rank0 = not dist.is_initialized() or dist.get_rank() == 0
            if operator_factory is None:
                operator_factory = functools.partial(
                    ShardedSpmmOperator, mesh=mesh,
                    mode=cfg.sharded_spmm_mode, backend=self._kernels,
                    precision=cfg.spmm_precision)

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

        if mesh is not None:
            from ..parallel.sharding import make_sharded_train_step, table_rows
            self._rows = table_rows(self.model)
            self._sharded_step = make_sharded_train_step(
                self.model, mesh, cfg.lr, loss_fn=self._loss_fn,
                backend=self._kernels)[0]

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None
                   ) -> Tuple[Params, AdamState, torch.Generator]:
        """Xavier parameters and zero Adam moments from a generator seeded
        ``seed`` (default ``cfg.seed``); the generator then draws the
        epochs.  Under a mesh every rank draws the same whole tables and
        keeps its blocks (:meth:`_pad_params`); the moments are zeros of the
        blocks' shapes."""
        seed = self.cfg.seed if seed is None else seed
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params = init_params(gen, self.cfg, self.graph.num_users,
                             self.graph.num_items)
        if self.mesh is not None:
            params = self._pad_params(params)
        return params, adam_init(params), gen

    def _pad_params(self, params: Params) -> Params:
        """This rank's blocks of exact-row tables: each padded with zero rows
        to ``ceil(N/P) * P`` and cut to its ``ceil(N/P)`` rows
        (``parallel/sharding.shard_params``; the JAX package's
        ``_pad_params`` and row sharding).  Padded tables (a checkpoint's)
        need no more rows and are cut the same."""
        from ..parallel.sharding import shard_params
        return shard_params({k: v.to(self.device) for k, v in params.items()},
                            self._model_axis)

    def _trim(self, blocks: Params, keep_pad: bool = False) -> Params:
        """The exact-row tables (or the padded ones) of this rank's blocks,
        on every rank: the model group's all-gather, no gradient; the
        parameters themselves without a mesh."""
        if self.mesh is None:
            return blocks
        from ..parallel.sharding import gather_params
        with torch.no_grad():
            return gather_params(blocks, self._model_axis,
                                 None if keep_pad else self._rows)

    def _sample_epoch(self, gen: torch.Generator, users_flat: torch.Tensor):
        """One vectorized positive and negative draw for every batch of the
        epoch (each user's samples are iid either way)."""
        csr = self.ctx.train_csr
        with span("rec.train.sample_positives"):
            pos = sample_positives(gen, csr, users_flat)
        with span("rec.train.sample_negatives"):
            if self.popmix is not None:
                neg = sample_negatives_popmix(gen, csr, users_flat,
                                              self.popmix,
                                              rounds=self.cfg.neg_rounds)
            else:
                neg = sample_negatives_uniform(gen, csr, users_flat,
                                               self.graph.num_items,
                                               rounds=self.cfg.neg_rounds)
        return pos, neg

    def draw_epoch(self, gen: torch.Generator) -> Batches:
        """``(users, pos, neg, mask)``, each ``(nb, batch_size)``: a
        permutation of the train users padded with user 0, its samples, and
        the validity mask of the padded tail.  Under a mesh too it is the
        whole epoch (the same on every rank); :meth:`run_epoch` keeps the
        replica's columns."""
        B = self.cfg.batch_size
        n = self.train_users.size
        nb = -(-n // B)
        with span("rec.train.draw"):
            perm = self.train_users_dev[torch.randperm(n, generator=gen,
                                                       device=self.device)]
            pad = torch.zeros(nb * B - n, dtype=torch.int64,
                              device=self.device)
            users_flat = torch.cat([perm, pad])
            pos, neg = self._sample_epoch(gen, users_flat)
            mask = torch.arange(nb * B, device=self.device) < n
            return tuple(x.reshape(nb, B)
                         for x in (users_flat, pos, neg, mask))

    # ------------------------------------------------------------------
    def step_plans(self, users: torch.Tensor, pos: torch.Tensor,
                   neg: torch.Tensor) -> List[StepPlans]:
        """The gather plans of every step of ``(nb, B)`` batches, built at
        once on their device (``ops/gather.gather_plans``), into the tables
        the batch rows are gathered from (``LightGCN.gather_table_rows``:
        the padded tables of a chunked chain)."""
        n_users, n_items = self.model.gather_table_rows()
        return list(zip(
            gather_plans(users, n_users),
            gather_plans(torch.cat([pos, neg], dim=1), n_items)))

    def _loss_fn(self, params: Params, users, pos, neg, mask,
                 cached_rest: Optional[Tuple[torch.Tensor, torch.Tensor]]
                 = None, plans: Optional[StepPlans] = None,
                 count: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The step's loss on exact-row tables; with ``plans``
        (:meth:`step_plans`) every batch-row gather has the segment-sum
        backward, without them the plain ``x[rows]``.  ``count`` is the
        whole batch's mask count when ``mask`` is one data replica's
        columns of it (default: ``mask``'s)."""
        B = users.shape[0]
        items = torch.cat([pos, neg])
        p_u, p_i = plans or (None, None)
        bk = self._kernels
        if cached_rest is None and self.mesh is None:
            # batch-row combine: gather each layer's batch rows and average
            # B-row vectors instead of the full tables (bit-identical scores)
            u_rows, i_rows = self.model.propagate_rows(params, users, items,
                                                       plans)
        else:
            if cached_rest is None:
                # the mesh keeps table combine, as the JAX package's does
                # (rows of the sharded chain would cost collectives a layer)
                user_emb, item_emb = self.model.propagate(params)
            else:
                # "per_epoch": the propagated rest is cached (constant
                # within the epoch) but the layer-0 ego term comes from the
                # CURRENT params, so BPR gradients flow (a cached whole
                # table would leave only L2)
                rest_u, rest_i = cached_rest
                ego_u, ego_i = ego_tables(params, self.graph.num_users)
                scale = 1.0 / (self.cfg.num_layers + 1)
                user_emb = rest_u + scale * ego_u
                item_emb = rest_i + scale * ego_i
            u_rows = gather_rows(user_emb, users, p_u, bk)
            i_rows = gather_rows(item_emb, items, p_i, bk)
        # Eq 3.26 (LightGCN.score) on the gathered rows
        pos_s = (u_rows * i_rows[:B]).sum(-1)
        neg_s = (u_rows * i_rows[B:]).sum(-1)
        loss = losses.bpr_loss(pos_s, neg_s, mask, count)
        ego_u, ego_i = ego_tables(params, self.graph.num_users)
        ego_items = gather_rows(ego_i, items, p_i, bk)
        reg = losses.ego_l2(gather_rows(ego_u, users, p_u, bk),
                            ego_items[:B], ego_items[B:], mask, count)
        loss = loss + self.cfg.reg * reg
        if self.cfg.lambda_fair != 0.0:
            fair = losses.fairness_loss(self.pop_norm[pos], pos_s, mask,
                                        count)
            loss = loss + self.cfg.lambda_fair * fair
        return loss

    def _epoch_cache(self, params: Params
                    ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The "per_epoch" schedule's cached propagation minus its ego term
        (None under "per_batch"), of exact-row tables (under a mesh: of the
        gathered blocks ``params``)."""
        if self.cfg.propagation_schedule != "per_epoch":
            return None
        with span("rec.train.epoch_cache"), torch.no_grad():
            params = self._trim(params)
            user_emb, item_emb = self.model.propagate(params)
            ego_u, ego_i = ego_tables(params, self.graph.num_users)
            scale = 1.0 / (self.cfg.num_layers + 1)
            return user_emb - scale * ego_u, item_emb - scale * ego_i

    def train_step(self, params: Params, opt_state: AdamState, users, pos,
                   neg, mask, cached_rest=None,
                   plans: Optional[StepPlans] = None,
                   count: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One BPR step: loss, gradients, and the in-place Adam update of
        ``params`` and ``opt_state``.  Returns the step's loss (a 0-d
        tensor on the device).  ``plans`` are the step's gather plans
        (:meth:`step_plans`); without them the step builds its own, which
        waits for the batch to reach the host.  Under a mesh ``params`` and
        ``opt_state`` are this rank's blocks, the batch is this replica's
        columns, ``count`` the whole batch's mask count, and the loss is the
        whole batch's (``parallel/sharding.py``)."""
        if plans is None:
            plans = self.step_plans(users[None], pos[None], neg[None])[0]
        if self.mesh is not None:
            with deterministic_algorithms():
                return self._sharded_step(params, opt_state, users, pos, neg,
                                          mask, cached_rest, plans, count)
        with span("rec.train.step"), deterministic_algorithms():
            leaves = {k: p.detach().requires_grad_() for k, p in
                      params.items()}
            with span("rec.train.forward"):
                loss = self._loss_fn(leaves, users, pos, neg, mask,
                                     cached_rest, plans, count)
            with span("rec.train.backward"):
                grads = torch.autograd.grad(loss, list(leaves.values()))
            with span("rec.train.adam"):
                adam_step(params, dict(zip(leaves, grads)), opt_state,
                          self.cfg.lr, backend=self._kernels)
            return loss.detach()

    def run_epoch(self, params: Params, opt_state: AdamState,
                  batches: Batches) -> torch.Tensor:
        """Every step of one epoch over pre-drawn ``(users, pos, neg,
        mask)`` batches, whose gather plans are built first, all at once;
        returns the per-step losses on the device.  Under a mesh the
        batches are the whole epoch's: this replica trains on its columns
        of each (the JAX package's ``PartitionSpec(None, "data")``)."""
        nb = batches[0].shape[0]
        counts = [None] * nb
        if self.mesh is not None:
            counts = batches[3].sum(1)
            n = self.cfg.batch_size // self._data_axis.size
            cols = slice(self._data_axis.coord * n,
                         (self._data_axis.coord + 1) * n)
            batches = tuple(x[:, cols].contiguous() for x in batches)
        users_all, pos_all, neg_all, mask_all = batches
        with span("rec.train.plans"):
            plans = self.step_plans(users_all, pos_all, neg_all)
        cached = self._epoch_cache(params)
        return torch.stack([
            self.train_step(params, opt_state, users_all[s], pos_all[s],
                            neg_all[s], mask_all[s], cached, plans[s],
                            counts[s])
            for s in range(nb)])

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, params: Params, split: str,
                 gen: Optional[torch.Generator] = None,
                 extended: Optional[bool] = None):
        """Metrics of exact-row ``params`` (tensors on any device; under a
        mesh the gathered tables, :meth:`_trim`) on ``split``.  Sampled mode
        draws from ``gen``, by default the dedicated eval stream seeded
        ``cfg.seed + 999`` (reference lightgcn.py:406)."""
        cfg = self.cfg
        extended = cfg.extended_metrics if extended is None else extended
        params = {k: v.to(self.device) for k, v in params.items()}
        with span("rec.eval.propagate"):
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
        """Train ``epochs`` epochs with validation every ``cfg.eval_every``,
        then test the best parameters; the result's ``best_params`` are
        exact-row tables (under a mesh too, on every rank)."""
        cfg = self.cfg
        epochs = cfg.epochs if epochs is None else epochs
        params, opt_state, gen = self.init_state(seed)
        start_epoch = 1
        best_val = -1.0
        best_params = _clone(params)

        if checkpointer is not None and resume:
            state = checkpointer.restore()
            if state is not None:
                opt = state["opt_state"]
                params = self._load(state["params"])
                opt_state = AdamState(m=self._load(opt["m"]),
                                      v=self._load(opt["v"]),
                                      count=int(opt["count"]))
                gen.set_state(state["gen_state"])
                start_epoch = int(state["epoch"]) + 1
                best_val = float(state["best_val"])
                best_params = self._load(state["best_params"])
                self._log(f"[CKPT] resumed at epoch {start_epoch}")

        # the structured JSONL stream and the human lines share the product
        # path: `train-rec --out D` leaves D/metrics.jsonl (rank 0's)
        metric_log = None
        if cfg.out_dir and self._rank0:
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
                tables = self._trim(params)
                val_res = self.evaluate(tables, "val")
                entry.val = val_res
                self._log(format_metrics_block("VAL", val_res))
                val_score = val_res[selK]["recall"]
                if val_score > best_val:
                    best_val = val_score
                    best_params = _clone(params)
                    self._log(f"  saved best (val Recall@{selK}="
                              f"{best_val:.4f})")
                    if cfg.out_dir and cfg.save_best and self._rank0:
                        save_params_npz(f"{cfg.out_dir}/best_model.npz",
                                        tables)
            if metric_log is not None:
                rec = {"event": "epoch", "epoch": epoch, "loss": loss,
                       "seconds": dt}
                if entry.val is not None:
                    rec["val"] = {str(K): v for K, v in entry.val.items()}
                    rec["best_val"] = best_val
                metric_log.log(rec)
            history.append(entry)

            if checkpointer is not None:
                # under a mesh: the padded tables and moments, gathered
                # (rank 0 writes, train/checkpoint.py)
                checkpointer.save(epoch, {
                    "params": self._trim(params, keep_pad=True),
                    "opt_state": {"m": self._trim(opt_state.m, keep_pad=True),
                                  "v": self._trim(opt_state.v, keep_pad=True),
                                  "count": opt_state.count},
                    "gen_state": gen.get_state(), "epoch": epoch,
                    "best_val": best_val,
                    "best_params": self._trim(best_params, keep_pad=True)})

        if checkpointer is not None:
            checkpointer.wait()
        best_params = self._trim(best_params)
        test_res = self.evaluate(best_params, "test")
        self._log("\nTEST " + format_metrics_block("TEST", test_res)[5:])
        if metric_log is not None:
            metric_log.log({"event": "test", "best_val": best_val,
                            "test": {str(K): v for K, v in test_res.items()}})
            metric_log.close()
        return FitResult(best_params=best_params, best_val_recall=best_val,
                         test_metrics=test_res, history=history)

    def _load(self, tables: Params) -> Params:
        """Checkpointed tables on this device (under a mesh: this rank's
        blocks of the padded tables)."""
        if self.mesh is not None:
            return self._pad_params(tables)
        return {k: v.to(self.device) for k, v in tables.items()}

    def _log(self, msg: str):
        if self.verbose and self._rank0:
            print(msg)

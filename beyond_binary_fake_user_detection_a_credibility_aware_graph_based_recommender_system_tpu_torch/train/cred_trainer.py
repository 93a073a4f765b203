"""Stage-A trainer: credibility model training + score export.

The port of the JAX package's ``train/cred_trainer.py`` on one device
(reference ``train_and_export_credibility``, main.py:609-1025).  Loss
(Eq 3.18-3.21, main.py:894-963)::

  L = BCE(labeled seed users, early view)
    + 0.1 * smoothness(early-view edges, normalized EWA weights)
    + 0.1 * InfoNCE(h_u2_early[seed], h_u2_late[seed], tau=0.2)

Training population: 80% shuffled split of the labeled users
(main.py:886-893; ``np.random.default_rng(seed)``, the JAX package's
arrays), batches of 2048, Adam 1e-3, 100 epochs.

Two modes, as in the JAX package:
  * "slas" (default): each step samples the seeds' 2-hop neighborhoods
    (``models/cred_slas.py``; gathers, einsums and a Gumbel top-k), and the
    smoothness term runs over the sampled (seed -> item slot) edges;
  * "full_graph": each step runs the two-stage aggregation over the whole
    graph in both temporal views through the SpMM kernel (2 applications a
    view forward, 2 backward), and the smoothness term runs over every
    early-view edge.  Every row gather of the step takes the SpMM kernel as
    its backward (``ops/gather.py``, one application each): the smoothness
    term's two edge gathers with the plans the early view built once, the
    three seed-row gathers with the plan of the step's seeds, which
    ``run_epoch`` builds for every step of the epoch at once.

An epoch permutes the train users with the trainer's ``torch.Generator``
(or takes an injected order), pads the last batch with user 0 and masks it.
A step is the loss, its gradients and one fused Adam kernel launch per
parameter leaf (ten), under ``train/trainer.deterministic_algorithms``, so
a fit is bit-reproducible per seed.  The SLAS draws come from the same
generator; the JAX package's threefry stream cannot be reproduced, so tests
inject its uniforms (``uniforms=``).

Under a (data, model) mesh the views' operators are the edge-sharded ones
(``parallel/sharded_spmm.py``), as in the JAX package: the full-graph
forward, ``holdout_metrics`` and ``infer`` run through them, while the
parameters stay replicated and every rank takes the same batch (the
operators' replicated-cotangent contract), so no gradient is reduced.  The
SLAS path is unchanged; only rank 0 logs.

Export parity (main.py:965-1025): inference with no temporal view,
min-max normalization (constant -> zeros), ``credibility_scores_minmax.npy``
+ ``user_id,user_idx,credibility`` CSV + ``cred_model.npz``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.cred_io import save_credibility_csv
from ..graph.hetero import HeteroGraph
from ..models import losses
from ..models.cred_model import CredModel, Params, init_cred_params
from ..models.cred_slas import build_slas_graph_data, slas_forward
from ..ops.adam import AdamState, adam_init, adam_step
from ..ops.gather import GatherPlan, gather_plans, gather_rows
from ..utils.config import CredConfig, kernel_backend
from ..utils.device import resolve_device
from .checkpoint import TrainCheckpointer, save_params_npz
from .trainer import deterministic_algorithms

# one step's SLAS uniforms: early item draw, early user draw, late item
# draw, late user draw
StepUniforms = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclass
class CredFitResult:
    params: Params
    cred_raw: np.ndarray          # (U,) raw sigmoid scores
    cred_minmax: np.ndarray       # (U,) min-max normalized
    history: list = field(default_factory=list)


def holdout_bce_auc(y: np.ndarray, scores: np.ndarray) -> Dict[str, float]:
    """BCE and Mann-Whitney AUC (midranks for ties) of ``scores`` against
    the 0/1 labels ``y``, in float64 on the host."""
    y = np.asarray(y).astype(np.float64)
    s = np.clip(np.asarray(scores).astype(np.float64), 1e-7, 1 - 1e-7)
    bce = float(-np.mean(y * np.log(s) + (1 - y) * np.log(1 - s)))
    n_pos, n_neg = int(y.sum()), int((1 - y).sum())
    if n_pos == 0 or n_neg == 0:
        return {"bce": bce, "auc": float("nan")}
    _, inv, cnt = np.unique(s, return_inverse=True, return_counts=True)
    csum = np.concatenate([[0], np.cumsum(cnt)])
    ranks = (csum[inv] + csum[inv + 1] + 1) / 2.0
    auc = (ranks[y > 0.5].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    return {"bce": bce, "auc": float(auc)}


class CredTrainer:
    def __init__(self, hg: HeteroGraph, cfg: Optional[CredConfig] = None,
                 device="cuda", backend: str = "auto", verbose: bool = True,
                 mesh=None):
        """``backend``: "auto" launches the SpMM and Adam kernels for CUDA
        tensors (plain versions on the CPU); "torch" runs the plain
        versions on any device; "chunked" runs the full-graph views' SpMM on
        chunk plans (``ops/spmm.py``, the JAX package's "pallas"), the rest
        as "auto".  ``mesh``: a (data, model) ``DeviceMesh`` on ``device``,
        whose edge-sharded operators the model then runs on (their local
        sums through the CSR kernel under "chunked" too, as the JAX
        package's sharded operator ignores the backend)."""
        self.cfg = cfg or CredConfig()
        self.hg = hg
        self.device = resolve_device(device)
        # the gathers' backward and Adam
        self.backend = kernel_backend(backend)
        self.verbose = verbose
        self.mesh = mesh
        factory = None
        if mesh is not None:
            import functools
            import torch.distributed as dist
            from ..parallel.sharded_spmm import ShardedSpmmOperator
            factory = functools.partial(ShardedSpmmOperator, mesh=mesh,
                                        backend=self.backend)
            self.verbose = verbose and (not dist.is_initialized()
                                        or dist.get_rank() == 0)
        # slas mode never touches the full-graph temporal-view operators
        # off a mesh; on one they are built in both modes, the sharded
        # full-graph inference staying available there
        # (``JAX: train/cred_trainer.py:71-78``)
        self.model = None
        self.slas_data = None
        if self.cfg.trainer_mode == "slas":
            self.slas_data = build_slas_graph_data(hg, self.cfg, self.device)
        if self.cfg.trainer_mode != "slas" or mesh is not None:
            self.model = CredModel(hg, self.cfg, self.device, backend=backend,
                                   operator_factory=factory)

        labeled = np.nonzero(hg.user_y >= 0)[0]
        if labeled.size == 0:
            raise RuntimeError(
                "No labeled users found (y>=0). Check Ru labeling output.")
        rng = np.random.default_rng(self.cfg.seed)
        rng.shuffle(labeled)
        split = int(0.8 * labeled.size)
        self.train_users = np.sort(labeled[:split])
        # the reference computes this 20% split and never evaluates it
        # (main.py:886-893); here the holdout is monitored per epoch
        self.holdout_users = np.sort(labeled[split:])
        self._log(f"[CRED] labeled users={labeled.size:,} | "
                  f"train={self.train_users.size:,} | "
                  f"holdout={self.holdout_users.size:,}")
        self.train_users_dev = torch.as_tensor(self.train_users,
                                               device=self.device)
        self.user_y = torch.as_tensor(hg.user_y, device=self.device)

    def _log(self, msg):
        if self.verbose:
            print(msg)

    @property
    def batch_size(self) -> int:
        return min(self.cfg.batch_size, self.train_users.size)

    @property
    def steps_per_epoch(self) -> int:
        return -(-self.train_users.size // self.batch_size)

    def init_state(self, seed: Optional[int] = None
                   ) -> Tuple[Params, AdamState, torch.Generator]:
        """``nn.Linear``-init parameters and zero Adam moments from a
        generator seeded ``seed`` (default ``cfg.seed``); the generator then
        draws the epochs' orders and the SLAS neighborhoods."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.cfg.seed if seed is None else seed)
        params = init_cred_params(gen, self.hg.user_x.shape[1],
                                  self.hg.item_x.shape[1],
                                  self.cfg.hidden_dim)
        return params, adam_init(params), gen

    # ------------------------------------------------------------------
    def seed_plans(self, users: torch.Tensor) -> Optional[List[GatherPlan]]:
        """The gather plans of every step's seeds (``(nb, B)`` users, as
        :meth:`epoch_batches` gives them) in full-graph mode; None in SLAS
        mode, whose sampled rows are gathered on the device."""
        if self.cfg.trainer_mode == "slas":
            return None
        return gather_plans(users, self.hg.num_users)

    def _loss(self, params: Params, seeds: torch.Tensor, mask: torch.Tensor,
              gen: Optional[torch.Generator] = None,
              uniforms: Optional[StepUniforms] = None,
              seed_plan: Optional[GatherPlan] = None) -> torch.Tensor:
        """The step's loss; in full-graph mode ``seed_plan`` (of ``seeds``)
        gives the seed-row gathers the segment-sum backward, without it they
        are the plain ``x[seeds]``."""
        cfg = self.cfg
        if cfg.trainer_mode == "slas":
            return self._loss_slas(params, seeds, mask, gen, uniforms)
        pred1, h_u2_1, h_i1_1 = self.model.forward(params, "early")
        v1 = self.model.views["early"]
        _, h_u2_2, _ = self.model.forward(params, "late")

        def rows(t):
            return gather_rows(t, seeds, seed_plan, self.backend)

        y = self.user_y[seeds]
        keep = (y >= 0) & mask
        loss_sup = losses.masked_bce(rows(pred1[:, None])[:, 0], y.float(),
                                     keep)
        loss_smooth = losses.smoothness_loss(
            h_u2_1, h_i1_1, v1.src, v1.dst, v1.w_u2i_norm, min_w=0.0,
            plans=v1.smooth_plans, backend=self.backend)
        loss_cont = losses.info_nce(rows(h_u2_1), rows(h_u2_2),
                                    tau=cfg.tau_temp, mask=mask)
        return (loss_sup + cfg.lambda_smooth * loss_smooth
                + cfg.lambda_cont * loss_cont)

    def _loss_slas(self, params: Params, seeds: torch.Tensor,
                   mask: torch.Tensor, gen: Optional[torch.Generator],
                   uniforms: Optional[StepUniforms]) -> torch.Tensor:
        """Sampled-neighborhood loss: the same three terms over the SLAS
        fixed-shape subgraph (reference main.py:913-958 semantics with the
        sampling on the device; see models/cred_slas.py)."""
        cfg = self.cfg
        u_early = u_late = None
        if uniforms is not None:
            u_early, u_late = uniforms[:2], uniforms[2:]
        pred1, h_u2_1, h_i1_1, (w_norm, item_mask) = slas_forward(
            params, self.slas_data, seeds, gen, "early",
            cfg.k_item_neigh, cfg.k_user_neigh, u_early)
        _, h_u2_2, _, _ = slas_forward(
            params, self.slas_data, seeds, gen, "late",
            cfg.k_item_neigh, cfg.k_user_neigh, u_late)

        y = self.user_y[seeds]
        keep = (y >= 0) & mask
        loss_sup = losses.masked_bce(pred1, y.float(), keep)

        # smoothness over the (seed -> item slot) edges with normalized EWA
        # weights (main.py:894-907 restricted to the sampled subgraph)
        k_items = item_mask.shape[1]
        h_u_rep = torch.repeat_interleave(h_u2_1, k_items, dim=0)
        sq = ((h_u_rep - h_i1_1) ** 2).sum(-1)
        w = (w_norm * item_mask.reshape(-1)
             * torch.repeat_interleave(mask, k_items))
        denom = (w > 0).to(sq.dtype).sum().clamp(min=1.0)
        loss_smooth = (w * sq).sum() / denom

        loss_cont = losses.info_nce(h_u2_1, h_u2_2, tau=cfg.tau_temp,
                                    mask=mask)
        return (loss_sup + cfg.lambda_smooth * loss_smooth
                + cfg.lambda_cont * loss_cont)

    # ------------------------------------------------------------------
    def epoch_batches(self, gen: Optional[torch.Generator],
                      order: Optional[Sequence[int]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(users, mask)``, each ``(nb, B)``: ``order`` (default: a
        permutation of the train users drawn from ``gen``) padded with user
        0, and the validity mask of the padded tail."""
        B, nb = self.batch_size, self.steps_per_epoch
        n = self.train_users.size
        if order is None:
            order = self.train_users_dev[torch.randperm(
                n, generator=gen, device=self.device)]
        order = torch.as_tensor(order, dtype=torch.int64, device=self.device)
        if order.numel() != n:
            raise ValueError(f"order has {order.numel()} users, the train "
                             f"split {n}")
        pad = torch.zeros(nb * B - n, dtype=torch.int64, device=self.device)
        users = torch.cat([order, pad]).reshape(nb, B)
        mask = (torch.arange(nb * B, device=self.device) < n).reshape(nb, B)
        return users, mask

    def train_step(self, params: Params, opt_state: AdamState,
                   seeds: torch.Tensor, mask: torch.Tensor,
                   gen: Optional[torch.Generator] = None,
                   uniforms: Optional[StepUniforms] = None,
                   seed_plan: Optional[GatherPlan] = None) -> torch.Tensor:
        """One step: loss, gradients, and the in-place Adam update of
        ``params`` and ``opt_state``.  Returns the loss (0-d, on the
        device).  In full-graph mode without ``seed_plan`` the step builds
        its seeds' plan, which waits for the seeds to reach the host."""
        if seed_plan is None and self.cfg.trainer_mode != "slas":
            seed_plan = self.seed_plans(seeds[None])[0]
        with deterministic_algorithms():
            leaves = {k: p.detach().requires_grad_() for k, p in
                      params.items()}
            loss = self._loss(leaves, seeds, mask, gen, uniforms, seed_plan)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            adam_step(params, dict(zip(leaves, grads)), opt_state,
                      self.cfg.lr, backend=self.backend)
        return loss.detach()

    def run_epoch(self, params: Params, opt_state: AdamState,
                  gen: Optional[torch.Generator],
                  order: Optional[Sequence[int]] = None,
                  uniforms: Optional[Sequence[StepUniforms]] = None
                  ) -> torch.Tensor:
        """Every step of one epoch (the seeds' gather plans built first,
        all at once); returns the per-step losses on the device.  ``order``
        and ``uniforms`` (one :data:`StepUniforms` a step, SLAS mode)
        replace the draws from ``gen``."""
        users, mask = self.epoch_batches(gen, order)
        plans = self.seed_plans(users)
        return torch.stack([
            self.train_step(params, opt_state, users[s], mask[s], gen,
                            None if uniforms is None else uniforms[s],
                            None if plans is None else plans[s])
            for s in range(users.shape[0])])

    # ------------------------------------------------------------------
    def holdout_metrics(self, params: Params) -> Dict[str, float]:
        """BCE + AUC on the 20% labeled holdout (early view, like the
        supervised term)."""
        if self.holdout_users.size == 0:
            return {"bce": float("nan"), "auc": float("nan")}
        if self.cfg.trainer_mode == "slas":
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.cfg.seed + 77)
            scores = self._slas_scores_batched(
                params, self.holdout_users, gen, view="early").cpu().numpy()
        else:
            with torch.no_grad():
                pred, _, _ = self.model.forward(params, "early")
            scores = pred.cpu().numpy()[self.holdout_users]
        return holdout_bce_auc(self.hg.user_y[self.holdout_users], scores)

    def fit(self, epochs: Optional[int] = None,
            checkpointer: Optional[TrainCheckpointer] = None,
            resume: bool = False) -> CredFitResult:
        """``checkpointer`` keeps the full state (params, Adam moments and
        count, generator state, epoch); ``resume=True`` continues from its
        latest, equal to an uninterrupted run."""
        cfg = self.cfg
        dev = self.device
        epochs = cfg.epochs if epochs is None else epochs
        params, opt_state, gen = self.init_state()
        start_epoch = 1

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
                self._log(f"[CRED] resumed at epoch {start_epoch}")

        history = []
        for ep in range(start_epoch, epochs + 1):
            t0 = time.perf_counter()
            loss = float(self.run_epoch(params, opt_state, gen).mean().item())
            hm = self.holdout_metrics(params)
            history.append({"epoch": ep, "loss": loss,
                            "holdout_bce": hm["bce"],
                            "holdout_auc": hm["auc"],
                            "seconds": time.perf_counter() - t0})
            self._log(f"[CRED] Epoch {ep:02d} | loss={loss:.4f} | "
                      f"holdout BCE={hm['bce']:.4f} AUC={hm['auc']:.4f}")
            if checkpointer is not None:
                checkpointer.save(ep, {
                    "params": params,
                    "opt_state": {"m": opt_state.m, "v": opt_state.v,
                                  "count": opt_state.count},
                    "gen_state": gen.get_state(), "epoch": ep})
        if checkpointer is not None:
            checkpointer.wait()

        cred_raw = self.infer(params).cpu().numpy()
        cmin, cmax = float(cred_raw.min()), float(cred_raw.max())
        if (cmax - cmin) < 1e-12:
            cred_minmax = np.zeros_like(cred_raw, np.float32)
        else:
            cred_minmax = ((cred_raw - cmin) / (cmax - cmin)).astype(np.float32)
        self._log(f"[CRED] Raw cred: min={cmin:.6g}, max={cmax:.6g}")
        p10, p50, p90, p99 = np.percentile(cred_minmax, [10, 50, 90, 99])
        self._log(f"[CRED] Percentiles: p10={p10:.4f}, p50={p50:.4f}, "
                  f"p90={p90:.4f}, p99={p99:.4f}")
        return CredFitResult(params=params, cred_raw=cred_raw,
                             cred_minmax=cred_minmax, history=history)

    @torch.no_grad()
    def _slas_scores_batched(self, params: Params, users: np.ndarray,
                             gen: torch.Generator, view: Optional[str] = None
                             ) -> torch.Tensor:
        """Scores for ``users`` via fixed-size sampled-neighborhood batches
        (the last padded with user 0), on the device."""
        cfg = self.cfg
        B = min(cfg.batch_size, max(users.size, 1))
        out = []
        for s in range(0, users.size, B):
            seeds = torch.zeros(B, dtype=torch.int64, device=self.device)
            chunk = torch.as_tensor(users[s:s + B], device=self.device)
            seeds[:chunk.numel()] = chunk
            cred = slas_forward(params, self.slas_data, seeds, gen, view,
                                cfg.k_item_neigh, cfg.k_user_neigh)[0]
            out.append(cred[:chunk.numel()])
        if not out:
            return torch.zeros(0, device=self.device)
        return torch.cat(out)

    @torch.no_grad()
    def infer(self, params: Params) -> torch.Tensor:
        """(U,) scores with no temporal view (main.py:965-984): the full
        graph, or batch-wise sampled neighborhoods in slas mode (the
        reference also infers on subgraphs)."""
        if self.cfg.trainer_mode != "slas":
            return self.model.forward(params, None)[0]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.cfg.seed + 1234)
        return self._slas_scores_batched(
            params, np.arange(self.hg.num_users, dtype=np.int64), gen,
            view=None)

    # ------------------------------------------------------------------
    def export(self, result: CredFitResult, out_dir) -> Dict[str, str]:
        """npy + CSV + params, the Stage-A/B contract (main.py:986-1025)."""
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        npy = out / "credibility_scores_minmax.npy"
        csv = out / "credibility_scores_minmax_with_user_id.csv"
        ckpt = out / "cred_model.npz"
        np.save(npy, result.cred_minmax)
        save_credibility_csv(csv, result.cred_minmax, self.hg.user_ids)
        save_params_npz(ckpt, result.params)
        self._log(f"[CRED] Saved: {npy}\n[CRED] Saved: {csv}\n"
                  f"[CRED] Saved: {ckpt}")
        return {"npy": str(npy), "csv": str(csv), "ckpt": str(ckpt)}

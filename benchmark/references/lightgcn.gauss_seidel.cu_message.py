"""LightGCN with Gauss-Seidel propagation and credibility-in-message
weights, every user's credibility 1 (the trainer is given no credibility
scores): ``layers`` layers of ``i <- A_iu u`` then ``u <- A_ui i``, with
``w = cred[u] / sqrt(max(d_u, 1) max(d_i, 1))`` item<-user and without
``cred[u]`` user<-item; the embeddings are the mean of layers 0..K."""

from typing import Tuple

import numpy as np
import torch

from benchmark.reference import SpmmOp


class Model:
    def __init__(self, users: int, items: int, train: np.ndarray,
                 layers: int, device, dtype=torch.float64):
        self.U, self.I, self.K = int(users), int(items), int(layers)
        self.dtype = dtype
        u = torch.as_tensor(np.asarray(train[0], np.int64), device=device)
        i = torch.as_tensor(np.asarray(train[1], np.int64), device=device)
        du = torch.bincount(u, minlength=self.U).double().clamp(min=1.0)
        di = torch.bincount(i, minlength=self.I).double().clamp(min=1.0)
        base = du.rsqrt()[u] * di.rsqrt()[i]
        cred = torch.ones(self.U, dtype=torch.float64, device=device)
        self.u, self.i = u, i
        self.w_ui = base.to(dtype)
        self.w_iu = (cred[u] * base).to(dtype)

    def propagate(self, eu: torch.Tensor, ei: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        u, i = eu, ei
        acc_u, acc_i = eu, ei
        for _ in range(self.K):
            i = SpmmOp.apply(u, self.u, self.i, self.w_iu, self.I)
            u = SpmmOp.apply(i, self.i, self.u, self.w_ui, self.U)
            acc_u, acc_i = acc_u + u, acc_i + i
        return acc_u / (self.K + 1), acc_i / (self.K + 1)


def build(run, dtype=torch.float64) -> Model:
    """The model of ``run``'s graph and configuration, in ``dtype``."""
    cfg = run.cfg
    if (cfg.propagation, cfg.weight_mode) != ("gauss_seidel", "cu_message"):
        raise ValueError(f"this reference propagates Gauss-Seidel cu_message, "
                         f"not {cfg.propagation} {cfg.weight_mode}")
    return Model(run.users, run.items, run.train, cfg.num_layers, run.device,
                 dtype)

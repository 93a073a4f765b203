"""Evaluation: ``RecTrainer.evaluate(tables, split)`` back to back on
tables made from the seed: a propagation, then the full catalogue ranked in
batches of the configuration's ``eval_batch``.

The control is the reference on fp8 tables; the fault "half" is the
reference over the first half of the users, as if the rest were left
out."""

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import reference
from benchmark.drivers import make_tables, port
from benchmark.window import Window


class Driver:
    CONTROL = "fp8"
    CONTROL_OVERRIDES = None
    FAULTS = ("half",)

    def __init__(self, run):
        self.run = run
        with run.spans("setup.trainer_s"):
            self.tr = port("train.trainer").RecTrainer(
                run.cfg, run.graph, device=run.device, verbose=False)
        self.split = run.traffic["split"]
        self.users = self.tr.ctx.users_of(self.split)
        self.results: List[dict] = []
        self.judged_users = self.users
        self.failed = 0

    def start(self, seed: int) -> None:
        run = self.run
        self.__dict__.pop("_ref", None)
        self.results = []
        self.p0 = make_tables(seed, run.users, run.items, run.cfg.emb_dim,
                              run.device)

    def produce(self, seed: int) -> None:
        self.start(seed)
        self.results = [self._evaluate()]

    def _evaluate(self, n_users: Optional[int] = None) -> dict:
        ctx = self.tr.ctx
        if n_users is None:
            return self.tr.evaluate(self.p0, self.split)
        ctx.eval_users[self.split] = self.users[:n_users]
        try:
            return self.tr.evaluate(self.p0, self.split)
        finally:
            ctx.eval_users[self.split] = self.users

    def warm(self) -> None:
        self._evaluate(int(self.run.traffic["warm_batches"])
                       * self.run.cfg.eval_batch)

    def unit(self) -> float:
        res = self._evaluate()
        self.results.append(res)
        return float(self.users.size)

    def window(self, seconds: float) -> Window:
        return Window(seconds).run(self.unit)

    def trace(self) -> None:
        """Times one evaluation of the first ``trace_batches`` batches (its
        propagation with it), then traces another."""
        run = self.run
        nb = int(run.traffic["trace_batches"])
        n = min(nb * run.cfg.eval_batch, self.users.size)
        t0 = time.perf_counter()
        self.results.append(self._evaluate(n))
        run.timed["eval_s"] = time.perf_counter() - t0
        deg = np.diff(self.run.graph.user_csr("train").indptr)
        run.timed["exclusions_per_batch"] = float(
            deg[self.users[:n]].sum()) / nb
        run.traced(lambda: self.results.append(self._evaluate(n)),
                   lambda c: {"rows_kernel": c["spmm"]})
        run.counts.update(batches=nb, evaluations=1)
        self.judged_users = self.users[:n]

    def release(self) -> None:
        self.tr = None

    @property
    def answer(self) -> List[dict]:
        return self.results

    def _reference(self, precision: str, users: np.ndarray) -> dict:
        run = self.run
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.no_grad():
            tu, ti = run.reference_model().propagate(
                self.p0["user_emb"].double(), self.p0["item_emb"].double())
            if run.cfg.eval_score_dtype == "bf16":
                tu, ti = (reference.round_to(t, "bf16").float()
                          for t in (tu, ti))
            tu, ti = (reference.round_to(t, precision).float()
                      for t in (tu, ti))
            train = reference.csr_on(*reference.user_csr(run.train,
                                                         run.users),
                                     run.device)
            test = reference.csr_on(*reference.user_csr(run.test, run.users),
                                    run.device)
            return reference.full_eval(tu, ti, users, train, test,
                                       run.cfg.Ks, run.cfg.eval_batch)

    def reference_answer(self, fault: str) -> List[dict]:
        """"fp8": the reference on fp8 tables; "half": the reference over
        the first half of the users."""
        if fault == "half":
            users = self.judged_users[: self.judged_users.size // 2]
            res = self._reference("exact", users)
        else:
            res = self._reference(fault, self.judged_users)
        return [res] * max(len(self.results), 1)

    def judge(self, answer: List[dict]) -> Dict[str, float]:
        if not hasattr(self, "_ref"):
            self._ref = self._reference("exact", self.judged_users)
        gap = 0.0 if answer else float("inf")
        for res in answer:
            got = {K: {m: res[K][m] for m in ("precision", "recall", "ndcg")}
                   for K in res}
            if any(res[K].get("users_eval", self.judged_users.size)
                   != self.judged_users.size for K in res):
                gap = float("inf")
            gap = max(gap, reference.metric_gap(got, self._ref))
        return {"metric_gap": gap}

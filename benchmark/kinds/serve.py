"""Serving: requests arrive evenly spaced at the mix's ``rate_per_s`` (an
open loop below the rate the port sustains) and one server takes them in
order: a request's users (their count from ``min_users`` to ``max_users``,
each drawn in proportion to its train degree, without repeats) are ranked
over the whole catalogue by ``topk_for_users`` without their train items,
and the top ``k`` ids and scores come back to the host.  The tables are
propagated once at set-up.

The control is the reference's fp32 tables scored in TF32; the fault
"alter" is the port's answers with one id moved to the next item."""

from typing import Dict

import numpy as np
import torch

from benchmark import reference
from benchmark.drivers import make_tables, port
from benchmark.window import OpenWindow, arrivals


class Driver:
    CONTROL = "tf32"
    CONTROL_OVERRIDES = None
    FAULTS = ("alter",)

    def __init__(self, run):
        self.run = run
        with run.spans("setup.trainer_s"):
            self.tr = port("train.trainer").RecTrainer(
                run.cfg, run.graph, device=run.device, verbose=False)
        r = port("eval.retrieval")
        self._topk, self._excl = r.topk_for_users, r.exclusion_rows_for_users
        self.k = int(run.traffic["k"])
        self.next = 0
        self.responses: Dict[int, tuple] = {}
        self.failed = 0

    def start(self, seed: int) -> None:
        run, t = self.run, self.run.traffic
        self.__dict__.pop("_tables", None)
        self.responses, self.next = {}, 0
        self.p0 = make_tables(seed, run.users, run.items, run.cfg.emb_dim,
                              run.device)
        with torch.no_grad():
            self.tu, self.ti = self.tr.model.propagate(self.p0)
        rng = np.random.default_rng(int(seed))
        P, lo, hi = int(t["pool"]), int(t["min_users"]), int(t["max_users"])
        hi = min(hi, int((np.bincount(run.train[0], minlength=run.users)
                          > 0).sum()))
        lo = min(lo, hi)
        sizes = lo + (np.arange(P) * (hi - lo + 1)) // P
        rng.shuffle(sizes)
        deg = torch.bincount(torch.as_tensor(run.train[0], dtype=torch.int64,
                                             device=run.device),
                             minlength=run.users).double()
        logw = deg.log()
        g = torch.Generator(device=run.device)
        g.manual_seed(int(seed))
        self.pool = []
        for s in range(0, P, 256):
            r = torch.rand(min(256, P - s), run.users, generator=g,
                           device=run.device, dtype=torch.float64)
            keys = logw - torch.log(-torch.log(r.clamp(min=1e-300)))
            top = torch.topk(keys, hi, dim=1).indices.cpu().numpy()
            self.pool += [top[j, :sizes[s + j]] for j in range(top.shape[0])]
        first = int(t["sample_from"])
        pick = rng.choice(first, size=int(t["sample_requests"]) - 1,
                          replace=False)
        self.sample = set(pick.tolist()) | {int(np.argmax(sizes[:first]))}
        self.sizes = sizes

    def request(self, j: int):
        """One request of the pool, its ids and scores on the host."""
        run = self.run
        users = self.pool[j]
        excl = torch.as_tensor(self._excl(run.graph, users, "train"),
                               device=run.device)
        scores, ids = self._topk(self.tu, self.ti,
                                 torch.as_tensor(users, device=run.device),
                                 self.k, exclude_batch_rows=excl)
        return ids.cpu(), scores.cpu()

    def warm(self) -> None:
        order = np.argsort(self.sizes)
        for j in order[:: max(len(order) // int(
                self.run.traffic["warm_requests"]), 1)]:
            self.request(int(j))

    def unit(self) -> float:
        j = self.next % len(self.pool)
        self.next += 1
        ids, scores = self.request(j)
        if j in self.sample and j not in self.responses:
            self.responses[j] = (ids, scores)
        return float(len(self.pool[j]))

    def produce(self, seed: int) -> None:
        """The requests of the pool's first ``sample_from``, served."""
        self.start(seed)
        for _ in range(int(self.run.traffic["sample_from"])):
            self.unit()

    def window(self, seconds: float) -> OpenWindow:
        rate = float(self.run.traffic["rate_per_s"])
        return OpenWindow(arrivals(rate, seconds)).run(self.unit)

    def trace(self) -> None:
        run = self.run
        rate = float(run.traffic["rate_per_s"])
        offsets = arrivals(rate, int(run.traffic["trace_requests"]) / rate)

        def request():
            with torch.profiler.record_function("bench.request"):
                return self.unit()

        def waiting():
            return torch.profiler.record_function("bench.no_request_due")

        run.traced(lambda: OpenWindow(offsets, waiting).run(request),
                   lambda c: {})
        run.counts.update(requests=offsets.size)

    def release(self) -> None:
        self.tr = None
        self.tu = self.ti = None

    def _ref_tables(self, precision: str):
        run = self.run
        dtype = torch.float64 if precision == "exact" else torch.float32
        with torch.no_grad():
            tu, ti = run.reference_model(dtype).propagate(
                self.p0["user_emb"].to(dtype), self.p0["item_emb"].to(dtype))
        return reference.round_to(tu, precision), \
            reference.round_to(ti, precision)

    def reference_answer(self, fault: str) -> Dict[int, tuple]:
        """"tf32": the reference's fp32 tables scored in TF32; "alter":
        the port's answers with one id moved to the next item."""
        if fault == "alter":
            out = dict(self.responses)
            j = min(out)
            ids, sc = out[j]
            ids = ids.clone()
            ids[0, 0] = (ids[0, 0] + 1) % self.run.items
            out[j] = (ids, sc)
            return out
        tu, ti = self._ref_tables(fault)
        train = reference.csr_on(*reference.user_csr(self.run.train,
                                                     self.run.users),
                                 self.run.device)
        out = {}
        with torch.no_grad():
            for j in self.responses:
                u = torch.as_tensor(self.pool[j], device=self.run.device)
                s = reference.masked_scores(tu, ti, u, train)
                sc, ids = torch.topk(s, self.k, dim=1)
                out[j] = (ids.cpu(), sc.cpu())
        return out

    def judge(self, answer: Dict[int, tuple]) -> Dict[str, float]:
        run = self.run
        if not answer:
            return {"rank_gap": float("inf"), "score_gap": float("inf")}
        if not hasattr(self, "_tables"):
            self._tables = self._ref_tables("exact")
        tu, ti = self._tables
        train = reference.csr_on(*reference.user_csr(run.train, run.users),
                                 run.device)
        rank_gap = score_gap = 0.0
        with torch.no_grad():
            for j, (ids, scores) in answer.items():
                u = torch.as_tensor(self.pool[j], device=run.device)
                if ids.shape != (u.numel(), self.k):
                    return {"rank_gap": float("inf"),
                            "score_gap": float("inf")}
                ref = reference.masked_scores(tu, ti, u, train)
                r, s = reference.served_gaps(ref, ids, scores)
                rank_gap, score_gap = max(rank_gap, r), max(score_gap, s)
        return {"rank_gap": rank_gap, "score_gap": score_gap}

    @property
    def answer(self):
        return self.responses

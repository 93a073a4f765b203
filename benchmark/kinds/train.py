"""Training: ``fit``'s epochs back to back, ``draw_epoch`` then
``run_epoch``, with no evaluation.  The first ``first_steps`` steps run
through the same calls at set-up (one step, then the rest, so the first
gradient is read from Adam's state) and are judged after the window.

The control is the port with bf16 messages, its own lower-precision path;
the fault "half" is the reference with the second half of each batch left
out.  A state left unchanged reads 1 by the update's measure."""

import math
import time
from typing import Dict

import torch

from benchmark import reference
from benchmark.drivers import make_tables, port
from benchmark.tracing import RUN_EPOCH
from benchmark.window import Window


class Driver:
    CONTROL = None
    CONTROL_OVERRIDES = {"spmm_precision": "bf16"}
    FAULTS = ("half",)

    def __init__(self, run):
        self.run = run
        with run.spans("setup.trainer_s"):
            self.tr = port("train.trainer").RecTrainer(
                run.cfg, run.graph, device=run.device, verbose=False)
        self.samples = int(self.tr.train_users.size)
        self.failed = 0

    def start(self, seed: int) -> None:
        run, tr, cfg = self.run, self.tr, self.run.cfg
        self.__dict__.pop("_ref", None)
        params, opt, gen = tr.init_state(seed)
        p0 = make_tables(seed, run.users, run.items, cfg.emb_dim, run.device)
        for k in params:
            params[k].copy_(p0[k])
        batches = tr.draw_epoch(gen)
        n = int(run.traffic["first_steps"])
        tr.run_epoch(params, opt, tuple(x[:1] for x in batches))
        m1 = {k: v.clone() for k, v in opt.m.items()}
        tr.run_epoch(params, opt, tuple(x[1:n] for x in batches))
        self.answer = {
            "grad": {k: v / (1.0 - reference.B1) for k, v in m1.items()},
            "tables": {k: v.clone() for k, v in params.items()}}
        self.p0 = p0
        self.batches = [tuple(x[s].clone() for x in batches)
                        for s in range(n)]
        self.state = (params, opt, gen)
        self._rest = tuple(x[n:] for x in batches)

    produce = start

    def warm(self) -> None:
        params, opt, _ = self.state
        float(self.tr.run_epoch(params, opt, self._rest).sum())
        self._rest = None
        self.unit()

    def unit(self) -> float:
        params, opt, gen = self.state
        losses = self.tr.run_epoch(params, opt, self.tr.draw_epoch(gen))
        if not math.isfinite(float(losses.sum())):
            self.failed += 1
        return self.samples

    def window(self, seconds: float) -> Window:
        return Window(seconds).run(self.unit)

    def trace(self) -> None:
        """Times ``trace_timed_epochs`` epochs (their draws fenced apart),
        then traces one: its draws, a fence, then ``run_epoch`` inside a
        ``bench.run_epoch`` range, so the step's device work is told from
        the draws'."""
        run, tr = self.run, self.tr
        params, opt, gen = self.state
        steps = -(-self.samples // run.cfg.batch_size)
        epochs = int(run.traffic["trace_timed_epochs"])
        t0 = time.perf_counter()
        for _ in range(epochs):
            with run.spans("train.draw_epoch", run.device):
                b = tr.draw_epoch(gen)
            float(tr.run_epoch(params, opt, b).sum())
        run.timed["step_s"] = (time.perf_counter() - t0) / (epochs * steps)

        def one():
            b = tr.draw_epoch(gen)
            run.sync()
            with torch.profiler.record_function(RUN_EPOCH):
                float(tr.run_epoch(params, opt, b).sum())

        run.traced(one, lambda c: {"rows_kernel": c["spmm"]
                                   + c["gather_backward"],
                                   "fused_adam_multi_kernel": c["fused_adam"]})
        run.counts.update(epochs=1, steps=steps)

    def release(self) -> None:
        self.tr = self.state = None

    def reference_answer(self, fault: str) -> dict:
        """What the reference gives in the port's place: "half" leaves the
        second half of each batch out."""
        if fault != "half":
            raise ValueError(f"no fault {fault!r}")
        run = self.run
        B = run.cfg.batch_size
        batches = [(u, p, n, torch.cat([m[:B // 2],
                                        torch.zeros_like(m[B // 2:])]))
                   for u, p, n, m in self.batches]
        return reference.train_steps(
            run.reference_model(torch.float32), self.p0, batches, run.cfg.lr,
            run.cfg.reg, run.cfg.propagation_schedule, cache_at=(0, 1))

    def judge(self, answer: dict) -> Dict[str, float]:
        run = self.run
        self._check_draws()
        if not hasattr(self, "_ref"):
            self._ref = reference.train_steps(
                run.reference_model(), self.p0, self.batches, run.cfg.lr,
                run.cfg.reg, run.cfg.propagation_schedule,
                cache_at=(0, 1))
        ref = self._ref
        p0 = {k: v.double() for k, v in self.p0.items()}
        moved = {k: answer["tables"][k].double() - p0[k] for k in p0}
        ref_moved = {k: ref["tables"][k] - p0[k] for k in p0}
        return {"grad_gap": reference.norm_gap(answer["grad"], ref["grad"],
                                               ref["grad"]),
                "update_gap": reference.norm_gap(moved, ref_moved,
                                                 ref["grad"])}

    def _check_draws(self) -> None:
        """The draws the reference takes from the port: each positive is a
        train item of its user, every id is in range, and the kept users
        of a step all differ."""
        run = self.run
        ptr, idx = reference.csr_on(*reference.user_csr(run.train,
                                                        run.users),
                                    run.device)
        for u, p, n, m in self.batches:
            u, p, n = u[m], p[m], n[m]
            if u.unique().numel() != u.numel() \
                    or int(n.min()) < 0 or int(n.max()) >= run.items:
                raise RuntimeError("the epoch's draws are malformed")
            b, items = reference.rows_of((ptr, idx), u)
            keys = torch.sort(b * run.items + items).values
            q = torch.arange(u.numel(), device=u.device) * run.items + p
            at = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
            if not bool((keys[at] == q).all()):
                raise RuntimeError("a drawn positive is no train item of "
                                   "its user")

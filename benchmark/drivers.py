"""What the drivers of every kind of traffic share: the run's state, the
port's modules, the tables made from the seed and the port's launch
counters.

A driver is the class ``Driver`` of ``kinds/<kind>.py``, for the ``kind``
that a traffic file names.  It builds the port's object once (set-up),
drives it from the seed (``start``), warms up the shapes its traffic uses
(``warm``), runs the measured window (``window``: all of it on the host
when it returns), traces a short window (``trace``), frees the port's
state (``release``) and judges what the port produced (``answer``) against
the plain reference (``judge``: a number for each of the traffic file's
``limits``).  For the readings the limits are set from, it also gives the
port's answers for a seed as a run makes them (``produce``), a control
(``CONTROL``, a lower precision of the reference, or ``CONTROL_OVERRIDES``,
the port's own lower-precision path) and its planted faults (``FAULTS``,
by ``reference_answer``)."""

from __future__ import annotations

import importlib
import math
import sys
from typing import Dict, Optional

import torch

from . import graphs, registry, roofline
from .imports import PORT_PACKAGE
from .tracing import Spans, trace_window

TRACE_TRIES = 3


def port(module: str):
    return importlib.import_module(f"{PORT_PACKAGE}.{module}")


def make_tables(seed: int, users: int, items: int, dim: int, device
                ) -> Dict[str, torch.Tensor]:
    """Xavier-uniform fp32 user and item tables drawn on ``device`` from a
    generator seeded ``seed``, one call a table."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    out = {}
    for name, n in (("user_emb", users), ("item_emb", items)):
        lim = math.sqrt(6.0 / (n + dim))
        out[name] = (torch.rand(n, dim, generator=g, device=device)
                     * (2.0 * lim) - lim)
    return out


def counters() -> Dict[str, int]:
    """The port's launch counters: segment-sum applications of the
    operators and of the gathers' backward, and fused Adam launches."""
    sc, ac = port("ops.spmm_cuda"), port("ops.adam_cuda")
    return {"spmm": sc.KERNEL.launches,
            "gather_backward": sc.GATHER_KERNEL.launches,
            "fused_adam": ac.KERNEL.launches}


class Run:
    """One run of a cell: its graph, the port's configuration, the
    benchmark's spans, and what the traced window held."""

    def __init__(self, cell, seed: int, device: torch.device,
                 spans: Optional[Spans] = None, overrides: dict = None):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.spans = spans or Spans()
        self.traffic = cell.traffic
        self.kind = self.traffic["kind"]
        self.trace = self.last_trace = None
        self.counts: Dict[str, float] = {}
        self.timed: Dict[str, float] = {}
        with self.spans("setup.graph_s"):
            U, I, tr, va, te = graphs.load_edges(cell.config["graph"])
        self.users, self.items, self.train = int(U), int(I), tr
        self.test = te
        self.graph = port("graph.build").BipartiteGraph(int(U), int(I), tr,
                                                        va, te)
        self.stats = roofline.graph_stats(U, I, tr)
        kw = {**cell.config.get("overrides", {}),
              **self.traffic.get("overrides", {}), **(overrides or {})}
        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
        self.cfg = port("configs.presets").get_preset(cell.config["preset"],
                                                       **kw)

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def reference_model(self, dtype=torch.float64):
        """The configuration's ``reference`` (``references/<name>.py``)
        built on this run's graph, in ``dtype``."""
        mod = registry.load("references", self.cell.config["reference"],
                            self.cell.here)
        return mod.build(self, dtype)

    def sync(self):
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def traced(self, fn, expected) -> None:
        """Trace ``fn`` until a window is complete (at most
        :data:`TRACE_TRIES`); ``expected(delta)`` gives the kernel records
        the counters' change asks for.  ``trace`` is the complete window, or
        None; ``last_trace`` the last window traced."""
        self.timed["trace_tries"] = 0
        for _ in range(TRACE_TRIES):
            self.timed["trace_tries"] += 1
            tr = self.last_trace = trace_window(fn, self.device, counters)
            if tr.complete(expected(tr.counters)):
                self.trace = tr
                return
            print(f"[bench] trace window incomplete (launch calls "
                  f"{tr.launches}, kernel records {len(tr.kernels())}, "
                  f"counters {tr.counters}, records by kernel "
                  f"{tr.kernel_counts(8)}); tracing again", flush=True,
                  file=sys.stderr)

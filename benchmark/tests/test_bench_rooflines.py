"""The roofline arithmetic: least times counted from shapes."""

from importlib import import_module

import numpy as np
import pytest
import torch

from benchmark import roofline
from benchmark.drivers import Run
from benchmark.imports import PORT_PACKAGE
from benchmark import registry


def test_adam_at_the_north_star():
    # both tables, 500,000 x 128 and 1,000,000 x 128: 28 bytes an element
    elements = (500_000 + 1_000_000) * 128
    assert 28 * elements == 5_376_000_000
    assert roofline.adam_bound_ms(elements) == pytest.approx(1.6048, abs=5e-5)


def test_the_csr_bound_is_the_ports_probe_arithmetic():
    timing = import_module(f"{PORT_PACKAGE}.probes._timing")
    spmm = import_module(f"{PORT_PACKAGE}.ops.spmm")
    rng = np.random.default_rng(0)
    src = rng.integers(0, 300, 2000)
    dst = rng.integers(0, 500, 2000)
    d = spmm.CsrDirection.from_edges(src, dst, np.ones(2000, np.float32),
                                     300, 500, torch.device("cpu"))
    for D, itemsize in ((64, 4), (128, 2)):
        assert roofline.csr_bound_ms(np.unique(src).size, 2000, 500, D,
                                     itemsize) == pytest.approx(
            timing.csr_bound_ms(d, D, itemsize))


def test_an_evaluation_batch_is_bound_by_the_bf16_gemm():
    ms = roofline.eval_batch_bound_ms(512, 1_000_000, 128, 20, 8_000)
    assert ms == pytest.approx(1e3 * 2 * 512 * 128 * 1e6 / 989e12)
    table_ms = 1e3 * 1e6 * 128 * 2 / 3.35e12
    assert table_ms < ms


@pytest.mark.parametrize("traffic", ["train", "train_per_batch"])
def test_an_epochs_applications_are_the_ports(tiny, monkeypatch, traffic):
    """The applications the arithmetic counts are those the port's trainer
    makes in an epoch (counted here on the plain path)."""
    root, here = tiny
    spmm = import_module(f"{PORT_PACKAGE}.ops.spmm")
    gather = import_module(f"{PORT_PACKAGE}.ops.gather")
    made = {"spmm": 0, "gather_backward": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            made[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(spmm, "segment_spmm",
                        counting("spmm", spmm.segment_spmm))
    monkeypatch.setattr(gather, "segment_spmm",
                        counting("gather_backward", gather.segment_spmm))
    cell = registry.find_cell(f"scaled_10m.{traffic}", root, here)
    run = Run(cell, 4, torch.device("cpu"))
    drv = registry.driver("train", here)(run)
    drv.start(4)
    for k in made:
        made[k] = 0
    drv.unit()
    cfg = run.cfg
    steps = -(-drv.samples // cfg.batch_size)
    want = roofline.train_epoch_spmm_ms(run.stats, cfg.emb_dim,
                                        cfg.num_layers, cfg.batch_size,
                                        steps, cfg.propagation_schedule)
    assert made == {"spmm": want["spmm"],
                    "gather_backward": want["gather_backward"]}
    assert want["ms"] > 0

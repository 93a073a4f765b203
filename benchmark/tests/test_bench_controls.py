"""The comparison that decides ``correct``: sound answers pass, the
control and every fault a cell can have fail, at a toy size on the CPU.

The same readings at the cells' own sizes come from ``python -m
benchmark.calibrate`` on the card, where the limits were set from them."""

from importlib import import_module

import pytest
import torch

from benchmark import registry
from benchmark.calibrate import readings
from benchmark.imports import PORT_PACKAGE
from benchmark.run import run_cell

CELLS = ["scaled_10m.train", "scaled_10m.train_per_batch", "scaled_10m.eval",
         "cu_message_ref.serve"]


def _fails(reading: dict, limits: dict) -> bool:
    return any(not v <= limits[k] for k, v in reading.items())


@pytest.mark.parametrize("workload", CELLS)
def test_sound_answers_pass_and_the_control_and_faults_fail(tiny, workload):
    root, here = tiny
    cell = registry.find_cell(workload, root, here)
    limits = cell.traffic["limits"]
    out = readings(cell, [5, 6, 7], 3, torch.device("cpu"))
    for seed, r in out["sound"].items():
        assert not _fails(r, limits), (seed, r)
    faults = registry.driver(cell.traffic["kind"], here).FAULTS
    for arm in ("control",) + faults:
        assert out[arm] and all(_fails(r, limits)
                                for r in out[arm].values()), (arm, out[arm])


def _port(module):
    return import_module(f"{PORT_PACKAGE}.{module}")


def _unchanged(mp):
    mp.setattr(_port("train.trainer"), "adam_step", lambda *a, **k: None)


def _half_batch(mp):
    trainer = _port("train.trainer").RecTrainer
    loss = trainer._loss_fn

    def half(self, params, users, pos, neg, mask, *a, **k):
        keep = torch.arange(mask.numel()) < mask.numel() // 2
        return loss(self, params, users, pos, neg, mask & keep, *a, **k)
    mp.setattr(trainer, "_loss_fn", half)


def _eval_altered(mp):
    ranking = _port("eval.ranking")
    metrics = ranking._full_metrics_from_topk

    def altered(topk_items, *a, **k):
        return metrics((topk_items + 1) % 900, *a, **k)
    mp.setattr(ranking, "_full_metrics_from_topk", altered)


def _eval_half(mp):
    acc = _port("eval.ranking")._Accumulator
    add = acc.add

    def half(self, per_user, n_valid, *a, **k):
        return add(self, per_user, n_valid // 2, *a, **k)
    mp.setattr(acc, "add", half)


def _serve_altered(mp):
    r = _port("eval.retrieval")
    topk = r.topk_for_users

    def altered(*a, **k):
        scores, ids = topk(*a, **k)
        ids = ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % 900
        return scores, ids
    mp.setattr(r, "topk_for_users", altered)


def _serve_half(mp):
    r = _port("eval.retrieval")
    topk = r.topk_for_users

    def half(*a, **k):
        scores, ids = topk(*a, **k)
        n = ids.shape[0] // 2
        return scores[:n], ids[:n]
    mp.setattr(r, "topk_for_users", half)


@pytest.mark.parametrize("workload,fault", [
    ("scaled_10m.train", _unchanged), ("scaled_10m.train", _half_batch),
    ("scaled_10m.train_per_batch", _unchanged),
    ("scaled_10m.train_per_batch", _half_batch),
    ("scaled_10m.eval", _eval_altered), ("scaled_10m.eval", _eval_half),
    ("cu_message_ref.serve", _serve_altered),
    ("cu_message_ref.serve", _serve_half)])
def test_a_run_with_its_timed_path_broken_is_not_correct(tiny, monkeypatch,
                                                         workload, fault):
    root, here = tiny
    fault(monkeypatch)
    cell = registry.find_cell(workload, root, here)
    out = run_cell(cell, 2**31 + 3, 0.2, False, torch.device("cpu"))
    assert out["correct"] is False

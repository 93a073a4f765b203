"""Probe: what the samplers' parts cost on the card.

Answers three of the JAX package's probes in one run, each timing a call
with ``probes/_timing.device_loop_time`` (CUDA events over a loop, best of
three; the host clock on the CPU) and a ``torch.Generator`` that advances
from one call to the next:

  alias       ``scripts/probe_alias.py``: the popularity-mixture draw
              ``PopMixSampler.draw`` (a Walker/Vose alias table) against a
              float32 inverse-CDF ``torch.searchsorted`` draw of the same
              mixture (JAX's ``:51-61``), ``--batch`` x ``--rounds`` draws a
              call, over catalogues of ``--catalogues`` items (JAX's two,
              261,728 and 10,000,000, and the north star's 1,000,000) with
              degrees ``pareto(1.1) * 3`` from seed 0: us a draw batch, ns a
              draw, and the items the float32 CDF cannot draw (a step of
              0) with their share of the popularity mass;
  sampling    the sampling half of ``scripts/probe_adam_sampling.py``
              (``:76-118``) on the reference graph (58,867 users, 261,728
              items, 7.9 a user, seed 0; the trainer's CSR with its hash
              membership, as JAX's probe builds it), B = 4,096 users from
              seed 0: ``sample_positives``, ``sample_negatives_uniform`` (8
              rounds), ``row_contains`` at (B, 8) and a (B, 9) ``randint``;
              its Adam half is chip_smoke's phases 2b and 8;
  membership  the membership half of ``scripts/probe_rng_membership.py``
              (``:68-176``): ``row_contains`` by binary search over the
              sorted CSR rows at (B, 2 / 8 / 32) against the hash table
              (``ops/membership.HashMembership``) at (B, 8), the table's
              size and load, and JAX's two checks: the two agree on random
              candidates, and every sampled member is found.  Its RBG
              against threefry half has no counterpart: the port draws from
              one Philox ``torch.Generator``.

No hand kernel runs here.

    python -m <package>.probes.sampling_costs [--iters 20] [--batch 4096]
        [--rounds 9] [--catalogues 261728,1000000,10000000]
        [--out FILE] [--device cuda|cpu]

Writes ``--out`` (default ``runs/torch_h100/sampling_costs.json``) with
``card`` (``nvidia-smi`` name and power limit) and ``clock``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..utils.device import card_name, resolve_device
from ._timing import clock_name, device_loop_time

CATALOGUES = (261_728, 1_000_000, 10_000_000)
REF_GRAPH = dict(num_users=58_867, num_items=261_728, edges_per_user=7.9,
                 seed=0, power=1.0)
USERS_B = 4096
NEG_ROUNDS = 8
MEMBERSHIP_CANDS = (2, 8, 32)
HASH_CANDS = 8
RNG_NOTE = ("RBG against threefry: no torch counterpart; the port draws "
            "every sample from one Philox torch.Generator")
ADAM_NOTE = ("Adam half of scripts/probe_adam_sampling.py: answered by "
             "chip_smoke.py phases 2b and 8 (csrc/fused_adam.cu against its "
             "plain version and torch.optim.Adam(fused=True))")


def catalogue_degrees(num_items: int) -> np.ndarray:
    """The JAX probe's Zipf-like catalogue: ``pareto(1.1) * 3`` degrees
    from seed 0."""
    rng = np.random.default_rng(0)
    return (rng.pareto(1.1, num_items) * 3).astype(np.int64)


def popularity(deg: np.ndarray, gamma: float) -> np.ndarray:
    """p(i) ∝ (deg_i + 1)^gamma, in float64."""
    pop = np.power(deg.astype(np.float64) + 1.0, gamma)
    return pop / pop.sum()


def popularity_cdf(deg: np.ndarray, gamma: float, device) -> torch.Tensor:
    """The float32 inverse-CDF table of :func:`popularity` (summed in
    float64, stored in float32 as JAX's probe does)."""
    return torch.as_tensor(np.cumsum(popularity(deg, gamma)),
                           dtype=torch.float32, device=device)


def cdf32_losses(deg: np.ndarray, gamma: float) -> dict:
    """The items whose step in the float32 CDF table is 0, which its
    ``searchsorted`` draw never returns, and their share of the popularity
    mass (the alias table draws every item)."""
    p = popularity(deg, gamma)
    cdf = popularity_cdf(deg, gamma, "cpu").numpy()
    lost = np.diff(cdf, prepend=np.float32(0.0)) == 0
    return {"items_never_drawn": int(lost.sum()),
            "mass_never_drawn": float(p[lost].sum())}


def cdf_draw(gen: torch.Generator, cdf32: torch.Tensor, mix_pop: float,
             shape, device) -> torch.Tensor:
    """The mixture draw of JAX's probe (``:51-61``): with probability
    ``mix_pop`` a ``searchsorted`` of a uniform in the float32 CDF, else a
    uniform item."""
    I = cdf32.shape[0]
    use_pop = torch.rand(shape, generator=gen, device=device) < mix_pop
    u = torch.rand(shape, generator=gen, device=device)
    pop_draw = torch.searchsorted(cdf32, u).clamp_(0, I - 1)
    uni = torch.randint(0, I, shape, generator=gen, device=device)
    return torch.where(use_pop, pop_draw, uni)


def _gen(dev, seed: int = 0) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def alias_rows(dev, catalogues, batch: int, rounds: int,
               iters: int) -> list:
    """The alias draw against the inverse-CDF draw at each catalogue size;
    each row with the draws' range checked."""
    from ..ops.sampling import PopMixSampler
    shape = (batch, rounds)
    rows = []
    for I in catalogues:
        deg = catalogue_degrees(I)
        sampler = PopMixSampler.build(deg, dev)
        cdf32 = popularity_cdf(deg, 0.75, dev)
        gen = _gen(dev)
        draws = {"alias": lambda: sampler.draw(gen, shape, dev),
                 "cdf32": lambda: cdf_draw(gen, cdf32, sampler.mix_pop,
                                           shape, dev)}
        for name, fn in draws.items():
            d = fn()
            in_range = bool(((d >= 0) & (d < I)).all())
            ms = device_loop_time(fn, dev, iters=iters)
            n = batch * rounds
            rows.append({"catalogue": I, "draw": name,
                         "us_per_draw_batch": 1e3 * ms,
                         "ns_per_draw": 1e6 * ms / n, "draws_per_call": n,
                         "in_range": in_range})
            if name == "cdf32":
                rows[-1].update(cdf32_losses(deg, 0.75))
            print(f"[alias] I={I:>10,} {name}: {1e3 * ms:8.1f} us/draw-batch "
                  f"({1e6 * ms / n:6.2f} ns/draw)", flush=True)
    return rows


def reference_graph():
    from ..graph.build import synthetic_bipartite_graph
    return synthetic_bipartite_graph(**REF_GRAPH)


def sampling_rows(graph, dev, iters: int) -> dict:
    """The sampling half of JAX's ``probe_adam_sampling.py``: ms a call."""
    from ..ops.sampling import (DeviceCSR, row_contains,
                                sample_negatives_uniform, sample_positives)
    I = graph.num_items
    csr = DeviceCSR.from_host(graph.user_csr("train"), I, dev)
    rng = np.random.default_rng(0)
    B = min(USERS_B, graph.num_users)
    users = torch.as_tensor(rng.integers(0, graph.num_users, B), device=dev)
    cand = torch.as_tensor(rng.integers(0, I, (B, 8)), device=dev)
    gen = _gen(dev)
    calls = {
        "sample_positives": lambda: sample_positives(gen, csr, users),
        f"sample_negatives_uniform ({NEG_ROUNDS} rounds)":
            lambda: sample_negatives_uniform(gen, csr, users, I,
                                             rounds=NEG_ROUNDS),
        "row_contains (B, 8)": lambda: row_contains(csr, users, cand),
        "randint (B, 9)": lambda: torch.randint(0, I, (B, 9), generator=gen,
                                                device=dev)}
    ms = {}
    for name, fn in calls.items():
        ms[name] = device_loop_time(fn, dev, iters=iters)
        print(f"[sampling] {name:34s}: {ms[name]:7.3f} ms", flush=True)
    return {"B": B, "membership": "hash", "search_iters": csr.search_iters,
            "ms": ms, "adam": ADAM_NOTE}


def membership_rows(graph, dev, iters: int) -> dict:
    """The membership half of JAX's ``probe_rng_membership.py``: binary
    search at (B, 2/8/32) against the hash table at (B, 8), the table's
    size and load, and JAX's two checks."""
    from ..ops.membership import SLOTS
    from ..ops.sampling import DeviceCSR, row_contains, sample_positives
    I = graph.num_items
    host_csr = graph.user_csr("train")
    bsearch = DeviceCSR.from_host(host_csr, I, dev, membership="bsearch")
    hashed = DeviceCSR.from_host(host_csr, I, dev, membership="hash")
    hm = hashed.hashmem
    rng = np.random.default_rng(0)
    B = min(USERS_B, graph.num_users)
    users = torch.as_tensor(rng.integers(0, graph.num_users, B), device=dev)
    ms = {}
    for n in MEMBERSHIP_CANDS:
        cand = torch.as_tensor(rng.integers(0, I, (B, n)), device=dev)
        ms[f"row_contains (B, {n})"] = device_loop_time(
            lambda: row_contains(bsearch, users, cand), dev, iters=iters)
    cand = torch.as_tensor(rng.integers(0, I, (B, HASH_CANDS)), device=dev)
    ms[f"hash_contains (B, {HASH_CANDS})"] = device_loop_time(
        lambda: hm.contains(users[:, None], cand), dev, iters=iters)
    for name, v in ms.items():
        print(f"[membership] {name:24s}: {v:7.3f} ms", flush=True)
    # JAX's checks: hash and binary search agree on random candidates ...
    cand = torch.as_tensor(rng.integers(0, I, (B, 8)), device=dev)
    a = row_contains(bsearch, users, cand)
    b = hm.contains(users[:, None], cand)
    # ... and every sampled member is found
    pos = sample_positives(_gen(dev, 1), bsearch, users)
    deg = torch.as_tensor(host_csr.degrees(), device=dev)[users]
    found = hm.contains(users, pos)
    E = int(host_csr.nnz)
    size = hm.nbuckets * SLOTS
    fill = int((hm.buckets[:, :SLOTS] >= 0).sum(dim=1).max())
    rec = {"B": B, "ms": ms, "search_iters": bsearch.search_iters,
           "hash_table": {"pairs": E, "buckets": hm.nbuckets,
                          "slots_per_bucket": SLOTS, "size": size,
                          "load": E / size, "fullest_bucket": fill},
           "agree": bool((a == b).all()),
           "positives_present": int(a.sum()),
           "members_found": bool(found[deg > 0].all()),
           "members_checked": int((deg > 0).sum()), "rng": RNG_NOTE}
    print(f"[membership] hash table: {hm.nbuckets:,} buckets x {SLOTS} = "
          f"{size:,} slots, load {E / size:.2f}; agreement {rec['agree']} "
          f"(positives present: {rec['positives_present']}); members found "
          f"{rec['members_found']}", flush=True)
    return rec


def run(dev, graph=None, catalogues=CATALOGUES, batch: int = 4096,
        rounds: int = 9, iters: int = 20) -> dict:
    graph = graph if graph is not None else reference_graph()
    return {"clock": clock_name(dev), "iters": iters,
            "alias": alias_rows(dev, catalogues, batch, rounds, iters),
            "sampling": sampling_rows(graph, dev, iters),
            "membership": membership_rows(graph, dev, iters),
            "graph": graph.summary(), "card": card_name(dev)}


def main(argv=None, graph=None) -> dict:
    """``graph``: the graph of the sampling and membership halves when the
    caller has built it (default the reference graph)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("--catalogues",
                    default=",".join(str(c) for c in CATALOGUES))
    ap.add_argument("--out", default="runs/torch_h100/sampling_costs.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))          # no fallback to the CPU
    cats = tuple(int(c) for c in args.catalogues.split(","))
    rec = run(dev, graph, cats, args.batch, args.rounds, args.iters)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=2))
    return rec


if __name__ == "__main__":
    main()

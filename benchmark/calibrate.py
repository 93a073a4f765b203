"""The readings that a cell's limits are set from, all seeds in one process.

    python -m benchmark.calibrate --workload <cell> --seeds 11,12,...
        [--controls 3] [--out FILE]

For every seed the port's own answers are judged as a run judges them
(the sound readings).  On the first ``--controls`` seeds so are the
control's answers and each planted fault's, as the cell's kind defines
them (``kinds/<kind>.py``: ``CONTROL`` or ``CONTROL_OVERRIDES``, and
``FAULTS``).

The answers are the same that a run judges, at the cell's own sizes: the
first steps of the trainer's epoch call, a whole evaluation, the requests
of the pool's first pass."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import registry
from .drivers import Run


def readings(cell, seeds, controls: int, device) -> dict:
    Driver = registry.driver(cell.traffic["kind"], cell.here)
    drv = Driver(Run(cell, seeds[0], device))
    ctl = None
    if Driver.CONTROL_OVERRIDES:
        ctl = Driver(Run(cell, seeds[0], device,
                         overrides=Driver.CONTROL_OVERRIDES))
    out = {"sound": {}, "control": {}, **{f: {} for f in Driver.FAULTS}}
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        drv.produce(seed)
        out["sound"][seed] = drv.judge(drv.answer)
        if n < controls:
            for f in Driver.FAULTS:
                out[f][seed] = drv.judge(drv.reference_answer(f))
            if ctl is not None:
                ctl.produce(seed)
                out["control"][seed] = ctl.judge(ctl.answer)
            else:
                out["control"][seed] = drv.judge(
                    drv.reference_answer(Driver.CONTROL))
        print(f"[calibrate] {cell.name} seed {seed} "
              f"({time.perf_counter() - t0:.1f} s): "
              + json.dumps({k: v.get(seed) for k, v in out.items()}),
              file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[calibrate] no CUDA card", file=sys.stderr)
        return 2
    cell = registry.find_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = readings(cell, seeds, args.controls, torch.device("cuda", 0))
    out["device"] = torch.cuda.get_device_name(0)
    text = json.dumps(out, default=str)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

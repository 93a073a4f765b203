"""The readers' throughput on a ~10M-line review JSONL, the port's side: the
counterpart of the JAX package's ``scripts/ingest_bench.py``.

Writes the synthetic Amazon-class stream of ``two_stage_demo`` (unless
``--path`` exists), reads all of it with the native C++ reader
(``data/native/``) and a prefix with the Python reader, and projects the
Python reader's time to the whole file.  It is host work: no device runs.
The record names the host's CPU model beside the card's name and power
limit, since both readers run on the host of that card.

    python -m <package>.scripts.ingest_bench [--lines 10000000] [--path F] \\
        [--keep] [--out runs/torch_h100/ingest_bench.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import tempfile
import time
from pathlib import Path


def host_cpu() -> str:
    """The host's CPU model (``/proc/cpuinfo``'s model name or, where that
    reads "unknown", its vendor, family and model numbers), its machine type
    and its logical CPU count."""
    fields = {}
    try:
        for ln in Path("/proc/cpuinfo").read_text().splitlines():
            if not ln.strip():
                break                   # the first processor's block
            k, _, v = ln.partition(":")
            fields[k.strip()] = v.strip()
    except OSError:
        pass
    model = fields.get("model name", "unknown")
    if model == "unknown" and "vendor_id" in fields:
        model = (f"{fields['vendor_id']} family {fields.get('cpu family')} "
                 f"model {fields.get('model')}")
    return f"{model} ({platform.machine()}), {os.cpu_count()} logical CPUs"


def bench(path: Path, lines: int, python_lines: int) -> dict:
    """Both readers on ``path`` (``lines`` lines); the JAX record's keys."""
    from ..data.ingest import ingest_jsonl
    from ..utils.config import IngestConfig
    out = {"lines": lines, "bytes": path.stat().st_size}
    t0 = time.perf_counter()
    table = ingest_jsonl(path, IngestConfig(jsonl_path=str(path),
                                            backend="native"))
    t_native = time.perf_counter() - t0
    out["native_s"] = t_native
    out["native_mlines_per_s"] = lines / t_native / 1e6
    out["rows_kept"] = int(table.uidx.shape[0])
    print(f"native: {t_native:.1f}s "
          f"({out['native_mlines_per_s']:.2f} M lines/s)", file=sys.stderr)

    # the Python reader on a prefix (linear in lines)
    prefix = Path(str(path) + ".prefix")
    with open(path, "rb") as f, open(prefix, "wb") as g:
        for k, ln in enumerate(f):
            if k >= python_lines:
                break
            g.write(ln)
    try:
        t0 = time.perf_counter()
        ingest_jsonl(prefix, IngestConfig(jsonl_path=str(prefix),
                                          backend="python"))
        t_py = time.perf_counter() - t0
    finally:
        prefix.unlink(missing_ok=True)
    out["python_prefix_lines"] = python_lines
    out["python_prefix_s"] = t_py
    out["python_projected_s"] = t_py * lines / python_lines
    out["native_speedup"] = out["python_projected_s"] / t_native
    print(f"python: {t_py:.1f}s on {python_lines:,} lines -> projected "
          f"{out['python_projected_s']:.0f}s at {lines:,} "
          f"({out['native_speedup']:.1f}x native win)", file=sys.stderr)
    return out


def main(argv=None) -> dict:
    from ..utils.device import card_name, resolve_device
    from .two_stage_demo import make_synthetic_reviews
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lines", type=int, default=10_000_000)
    ap.add_argument("--users", type=int, default=500_000)
    ap.add_argument("--items", type=int, default=1_000_000)
    ap.add_argument("--path", default=None,
                    help="the JSONL (written when missing and then "
                         "removed unless --keep; default: a temporary file, "
                         "or ingest_bench_reviews.jsonl with --keep)")
    ap.add_argument("--python-lines", type=int, default=1_000_000,
                    help="python-backend sample size (measured on a prefix, "
                         "reported per line)")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--out", default="runs/torch_h100/ingest_bench.json")
    ap.add_argument("--device", default="cuda",
                    help="the card whose host this is (default cuda; cpu "
                         "records no card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    tmp = None
    if args.path is None and not args.keep:
        tmp = tempfile.TemporaryDirectory()
        path = Path(tmp.name) / "ingest_bench_reviews.jsonl"
    else:
        path = Path(args.path or "ingest_bench_reviews.jsonl")
    written = not path.exists()
    try:
        t0 = time.perf_counter()
        if written:
            make_synthetic_reviews(path, args.lines, args.users, args.items)
        t_write = time.perf_counter() - t0
        print(f"jsonl: {args.lines:,} lines, {path.stat().st_size / 1e9:.2f} "
              f"GB", file=sys.stderr)
        out = bench(path, args.lines, min(args.python_lines, args.lines))
        if written:
            out["write_s"] = t_write
    finally:
        # only a file this run wrote is removed
        if tmp is not None:
            tmp.cleanup()
        elif written and not args.keep:
            path.unlink(missing_ok=True)
    out["host_cpu"] = host_cpu()
    out["card"] = card_name(dev)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=2))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

"""Probe: where the staged chunk kernel's time goes (P1, P2, P3), on the card.

The kernel (``csrc/chunk_spmm.cu`` ``chunk_staged_kernel``) runs its CTAs
through synchronous phases a chunk.  This probe builds copies of the source
into ``build/chunk_profile/`` with probes written into that kernel and, for
the probe graph of ``probes/window_kernel.py`` in both directions (layouts:
``base``, the full-block R=512 T=256 plan with int32 local ids, P3;
``i16``, the same plan read through int16 ids, P2; ``win64``, the W=64
window plan, P1), prints:

* each phase's SM cycles a chunk, seen by thread 0 of each CTA (``clock64``
  between the CTA's barriers, summed over chunks): the run scan, the zero
  gaps, issuing the next item's copies (and waiting for the next chunk's
  plan), waiting for this item's rows, the sums, the span count, the span
  sums and the next plan's request;
* the CTAs' timeline (``%globaltimer``): the span of the launch, a CTA's mean
  and longest time, how many ran at once, on how many SMs, and the CTAs an
  SM holds;
* the device time (``queued_device_ms``) of the probed copy and of ablations
  that each drop one part of the work (their output is not the kernel's,
  though a dropped write may find the right values left in a reused
  buffer): the zero gaps, the row gather, the sums, the stores of whole
  rows.  What a part costs is the time it takes off when dropped.

    python -m <package>.probes.chunk_profile [--variants kernel,no_zero,...]
"""

from __future__ import annotations

import argparse
import ctypes
from pathlib import Path

import numpy as np
import torch

from ..ops.chunk_spmm import chunk_spmm_blocks
from ..ops.chunk_spmm_cuda import SOURCE, ChunkSpmmKernel
from ..ops.cuda_build import BUILD_DIR
from ..utils.device import resolve_device
from ._timing import queued_device_ms
from .window_kernel import directions, plan_for

OUT_DIR = BUILD_DIR.parent / "chunk_profile"
MAX_CTAS = 4096
PHASES = ("scan", "zero", "issue", "wait", "sum", "count", "spans")

# (text of csrc/chunk_spmm.cu, probe, put "before" or "after" the text)
_PROBES = [
    ("  const uint32_t bar[2] = {smem_addr(&s_bar[0]), smem_addr(&s_bar[1])};\n",
     "  if (tid == 0 && blockIdx.x < kMaxCtas) {\n"
     "    g_cta[3 * blockIdx.x] = gtime();\n"
     "    g_cta[3 * blockIdx.x + 2] = smid();\n  }\n", "after"),
    ("    const Stage<TL> stg = stage_at<TL>(s_plan, k & 1, T);\n",
     "    long long t0 = clock64();\n", "before"),
    ("    const int nr = s_nr;\n", "    PHASE(0);\n", "before"),
    ("    for (int j = 0; j < ntile; ++j, ++item) {\n", "    PHASE(1);\n", "before"),
    ("      cp_async_commit();\n      cp_async_wait_prior();\n", "      PHASE(2);\n",
     "before"),
    ("      cp_async_wait_prior();\n      __syncthreads();\n", "      PHASE(3);\n", "after"),
    ("      __syncthreads();  // this buffer is refilled two items on\n",
     "      PHASE(4);\n", "after"),
    ("      const int done = s_done;\n", "      PHASE(5);\n", "before"),
    ("    __syncthreads();  // the run starts and the scan's words are reused\n",
     "    PHASE(6);\n    if (tid == 0) atomicAdd(&g_phase[15], 1ull);\n", "after"),
    ("  asm volatile(\"cp.async.bulk.wait_group 0;\"",
     "  if (tid == 0 && blockIdx.x < kMaxCtas) g_cta[3 * blockIdx.x + 1] = gtime();\n",
     "before"),
]
_HEADER = f"""
constexpr unsigned kMaxCtas = {MAX_CTAS};
__device__ unsigned long long g_phase[16];
__device__ unsigned long long g_cta[3 * kMaxCtas];
__device__ __forceinline__ unsigned long long gtime() {{
  unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t;
}}
__device__ __forceinline__ unsigned smid() {{
  unsigned r; asm volatile("mov.u32 %0, %%smid;" : "=r"(r)); return r;
}}
#define PHASE(i) do {{ if (threadIdx.x == 0) {{ const long long t1 = clock64(); \\
  atomicAdd(&g_phase[i], (unsigned long long)(t1 - t0)); t0 = t1; }} }} while (0)
"""
_EXPORTS = """
extern "C" int phase_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
extern "C" int probe_reset() {
  static unsigned long long z[3 * kMaxCtas];
  const cudaError_t e = cudaMemcpyToSymbol(g_phase, z, sizeof(g_phase));
  return (int)(e != cudaSuccess ? e : cudaMemcpyToSymbol(g_cta, z, sizeof(g_cta)));
}
extern "C" int cta_read(void* out) { return (int)cudaMemcpyFromSymbol(out, g_cta, sizeof(g_cta)); }
"""
# each ablation drops one part of the work: (text, replacement)
ABLATIONS = {
    "kernel": [],
    "no_zero": [("        if (r1 > r0) {", "        if (r1 > r0 && D < 0) {")],
    "no_gather": [("    if (XVEC) cp_async16(", "    if (XVEC && D < 0) cp_async16(")],
    "no_sum": [("        for (int e = beg; e < end; ++e) {",
                "        for (int e = beg; e < end && D < 0; ++e) {")],
    "no_store": [("        store_cols(out + c0 + 4 * q, acc, cw - 4 * q, ovec, !carry);",
                  "        if (carry) store_cols(out + c0 + 4 * q, acc, cw - 4 * q, ovec, true);")],
}


def probed_source(name: str) -> Path:
    """The kernel source with the phase probes and one ablation."""
    text = SOURCE.read_text()
    text = text.replace("namespace {\n", "namespace {\n" + _HEADER, 1)
    for anchor, probe, where in _PROBES:
        if text.count(anchor) != 1:
            raise RuntimeError(f"probe point not found once in {SOURCE.name}: "
                               f"{anchor!r}")
        text = text.replace(anchor, probe + anchor if where == "before"
                            else anchor + probe)
    for old, new in ABLATIONS[name]:
        if old not in text:
            raise RuntimeError(f"ablation point not found: {old!r}")
        text = text.replace(old, new, 1)
    text = text.replace("}  // namespace\n", "}  // namespace\n" + _EXPORTS, 1)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / f"chunk_spmm_{name}.cu"
    path.write_text(text)
    return path


# layout: (window W of its plan, local-id dtype)
LAYOUTS = {"base": (0, torch.int32), "i16": (0, torch.int16),
           "win64": (64, torch.int32)}


def _kernels(path: Path):
    """Each layout's entry of a probed copy, and its library."""
    ks = {"base": ChunkSpmmKernel("chunk_spmm_block", False, torch.int32),
          "i16": ChunkSpmmKernel("chunk_spmm_i16", False, torch.int16),
          "win64": ChunkSpmmKernel("chunk_spmm_window", True, torch.int32)}
    for k in ks.values():
        k.source = path
    lib = ctypes.CDLL(str(ks["base"].build()))
    lib.phase_read.argtypes = lib.cta_read.argtypes = [ctypes.c_void_p]
    return ks, lib


def _timeline(lib) -> dict:
    buf = (ctypes.c_ulonglong * (3 * MAX_CTAS))()
    lib.cta_read(buf)
    a = np.array(buf, dtype=np.int64).reshape(MAX_CTAS, 3)
    a = a[a[:, 0] != 0]          # the CTAs of the probed launch
    ctas = len(a)
    start, end = (a[:, 0] - a[:, 0].min()) / 1e3, (a[:, 1] - a[:, 0].min()) / 1e3
    events = sorted([(t, 1) for t in start] + [(t, -1) for t in end])
    live = most = 0
    for _, d in events:
        live += d
        most = max(most, live)
    sms = len(set(a[:, 2].tolist()))
    return {"span_us": float(end.max()), "cta_mean_us": float((end - start).mean()),
            "cta_max_us": float((end - start).max()), "ctas": ctas,
            "most_at_once": most, "sms": sms, "ctas_per_sm": most / max(sms, 1)}


def run(device="cuda", variants=tuple(ABLATIONS), users=58_867, items=261_728,
        edges_per_user=7.9, dim=64, iters=20) -> dict:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("chunk_profile probes the CUDA kernel: it needs the card")
    dirs = directions(users, items, edges_per_user, dim, device)
    plans = {}
    for dn, d in dirs.items():
        by_window = {W: plan_for(d, device, window=W)
                     for W in {W for W, _ in LAYOUTS.values()}}
        for lay, (W, _) in LAYOUTS.items():
            plans[(dn, lay)] = by_window[W]
    want = {(dn, lay): chunk_spmm_blocks(p, dirs[dn]["x"], LAYOUTS[lay][1])
            for (dn, lay), p in plans.items()}
    rows = []
    print(f"chunk_profile on {device}: D={dim}, phases in SM cycles a chunk "
          f"(thread 0 of each CTA)")
    for name in variants:
        ks, lib = _kernels(probed_source(name))
        for (dn, lay), plan in plans.items():
            k, x = ks[lay], dirs[dn]["x"]
            ok = torch.equal(k(plan, x), want[(dn, lay)])
            ms = queued_device_ms(lambda: k(plan, x), device, iters)
            lib.probe_reset()
            k(plan, x)
            torch.cuda.synchronize(device)
            ph = (ctypes.c_ulonglong * 16)()
            lib.phase_read(ph)
            chunks = max(int(ph[15]), 1)
            row = {"variant": name, "direction": dn, "layout": lay,
                   "device_ms": ms, "bit_equal": ok, "chunks": int(ph[15]),
                   "phase_cycles": {p: ph[i] / chunks for i, p in enumerate(PHASES)},
                   **_timeline(lib)}
            rows.append(row)
            print(f"{name:9s} {dn} {lay:5s}: {ms:.4f} ms "
                  f"{'bit-equal' if ok else 'differs'}; "
                  + " ".join(f"{p} {v:.0f}" for p, v in row["phase_cycles"].items())
                  + f"; span {row['span_us']:.1f} us, CTA mean "
                  f"{row['cta_mean_us']:.1f} max {row['cta_max_us']:.1f}, "
                  f"{row['most_at_once']} at once on {row['sms']} SMs")
    return {"device": torch.cuda.get_device_name(device), "rows": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--variants", default=",".join(ABLATIONS))
    a = ap.parse_args(argv)
    return run(a.device, tuple(a.variants.split(",")))


if __name__ == "__main__":
    main()

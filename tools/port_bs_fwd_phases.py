#!/usr/bin/env python3
"""Where the bf16-score attention forward's time goes, on a CUDA card.

    python3 tools/port_bs_fwd_phases.py [B,H,L,DH ...]

Builds a copy of paddle_tpu_torch outside the checkout whose
csrc/attention_fwd_bs.cu records, for every CTA, the card's global timer
(%globaltimer, ns) at its phase boundaries and its SM, then times the
kernel (chip_smoke.time_ms) and runs it once more with the records on, at
each shape (default: BERT-base at seq 128 and 2048, [32,12,128,64] and
[8,12,2048,64], bf16, no bias, not causal).  Prints one JSON line a shape:
the kernel's median ms, its path (cluster, tiles a CTA), the median CTA
lifetime, the median of each phase over the CTAs (start: barrier init and
the block or cluster sync; q: Q landed; score, sum, out: the three passes;
max_exchange, sum_exchange: the cluster's combines; out_written: the
cluster's P V exchange and the stores), the median spread of a phase's end
within a cluster, and how many CTAs each SM held at the kernel's midpoint.
The records cost a few stores a CTA; the copy is a build of its own, so
compare its times only with each other.  Imports nothing of JAX or
paddle_tpu.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from port_attention_mutants import run_in_copy  # noqa: E402

BS_FWD = "paddle_tpu_torch/csrc/attention_fwd_bs.cu"
PHASES = ["start", "q", "score", "max_exchange", "sum", "sum_exchange", "out", "out_written"]
SLOTS = 12  # per CTA: marks 0-8, the SM at 9

RECORDER = r'''__device__ unsigned long long g_bs_phases[1 << 22];
__device__ __forceinline__ void bs_mark(int i, unsigned long long v) {
  if (threadIdx.x == 0) {
    const size_t cta = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    if (cta * 12 + i < (1u << 22)) g_bs_phases[cta * 12 + i] = v;
  }
}
__device__ __forceinline__ unsigned long long bs_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned bs_smid() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;\n" : "=r"(s));
  return s;
}

'''
READER = r'''
extern "C" int ptt_bs_phases_read(void* host, int n) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_bs_phases, sizeof(unsigned long long) * n));
}
'''


def mark(i):
    return f"  bs_mark({i}, bs_now());\n"


# (anchor, text) pairs: text goes after the anchor (or before it, "^" first)
EDITS = [
    ("template <int DH>\n__global__ void __launch_bounds__(kThreadsBS, 2)",
     "^" + RECORDER),
    ("  const int n = t_hi - t_lo, nb = min(n, T::kBufTiles);  // tiles; buffered tiles\n",
     mark(0) + "  bs_mark(9, bs_smid());\n"),
    ("  else\n    __syncthreads();\n", mark(1)),
    ("  h::mbar_wait(q_full, 0);\n", mark(2)),
    ("  if (C > 1) combine(mx, max_parts, max_bar, true);\n", "^" + mark(3)),
    ("  if (C > 1) combine(mx, max_parts, max_bar, true);\n", mark(4)),
    ("  if (C > 1) combine(l, sum_parts, sum_bar, false);\n", "^" + mark(5)),
    ("  if (C > 1) combine(l, sum_parts, sum_bar, false);\n", mark(6)),
    ("  // out: this CTA's P V (C == 1), or the cluster's partial P V summed in\n",
     "^" + mark(7)),
    ("  if (rank == 0 && c2 == 0) {\n", "^" + mark(8)),
]


def edits(src):
    """The instrumented source, as (old, new) replacements for run_in_copy."""
    out = []
    for anchor, text in EDITS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"{BS_FWD}: {anchor.strip()!r} occurs {src.count(anchor)} times")
        new = text[1:] + anchor if text.startswith("^") else anchor + text
        src = src.replace(anchor, new)
    return [(open(os.path.join(ROOT, BS_FWD)).read(), src + READER)]


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = r'''
import ctypes, json, subprocess
import numpy as np, torch, chip_smoke
from paddle_tpu_torch import _build
from paddle_tpu_torch.ops import cuda_attention as ca
SHAPES, PHASES, SLOTS = %r, %r, %d
lib = _build.library()
read = lib.ptt_bs_phases_read
read.argtypes = [ctypes.c_void_p, ctypes.c_int]
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
gen = torch.Generator(device="cuda").manual_seed(1)
for B, H, L, dh in SHAPES:
    q, k, v = (torch.randn(B, H, L, dh, generator=gen, device="cuda").bfloat16() for _ in range(3))
    fn = lambda: ca.attention_fwd(q, k, v, None, False, dh ** -0.5, score_bf16=True)
    ms = chip_smoke.time_ms(fn)
    fn()
    torch.cuda.synchronize()
    plan = ca.bf16_score_fwd_plan(L, dh)
    C = plan["cluster"]
    n = C * (-(-L // 64)) * B * H
    buf = (ctypes.c_ulonglong * (n * SLOTS))()
    if read(buf, n * SLOTS):
        raise RuntimeError("reading the records failed")
    a = np.frombuffer(buf, dtype=np.uint64).reshape(n, SLOTS).astype(np.int64)
    t, sm = a[:, :9], a[:, 9]
    med = lambda x: float(np.median(x) / 1e3)
    rec = {"shape": [B, H, L, dh], "card": card, "ms": ms, "path": plan,
           "kernel_span_us": float((t[:, 8].max() - t[:, 0].min()) / 1e3),
           "cta_life_us": med(t[:, 8] - t[:, 0]),
           "phase_us": {p: med(t[:, i + 1] - t[:, i]) for i, p in enumerate(PHASES)}}
    if C > 1:
        tc = t.reshape(-1, C, 9)
        rec["cluster_spread_us"] = {p: med(tc[:, :, i].max(1) - tc[:, :, i].min(1))
                                    for i, p in ((3, "score"), (5, "sum"), (7, "out"))}
    mid = t[:, 0].min() + (t[:, 8].max() - t[:, 0].min()) // 2
    alive = (t[:, 0] <= mid) & (t[:, 8] >= mid)
    rec["ctas_an_sm_at_midpoint"] = np.bincount(
        np.bincount(sm[alive], minlength=torch.cuda.get_device_properties(0).multi_processor_count)
    ).tolist()
    print(json.dumps(rec), flush=True)
'''


def main():
    shapes = [tuple(int(x) for x in a.split(",")) for a in sys.argv[1:]] or [
        (32, 12, 128, 64), (8, 12, 2048, 64)]
    src = open(os.path.join(ROOT, BS_FWD)).read()
    run = run_in_copy(edits(src), CODE % (shapes, PHASES, SLOTS), source=BS_FWD)
    sys.stdout.write(run.stdout)
    if run.returncode != 0:
        sys.stderr.write(run.stderr[-4000:])
    return run.returncode


if __name__ == "__main__":
    sys.exit(main())

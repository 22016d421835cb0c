#!/usr/bin/env python3
"""Time shapes of the bfloat16 attention forward kernel against each other on
a CUDA card.

    python3 tools/port_attention_variants.py

Each variant is a copy of paddle_tpu_torch built in a temporary directory
outside the checkout with the forward's tile constants of
paddle_tpu_torch/csrc/flash_attention.cu changed (query rows a warp owns as
16-row tiles, keys a warp takes in one pass; both at dh <= 64).  In its own
process each variant prints what the card makes of the forward at dh 64
(CTAs an SM, registers, shared bytes, spilled bytes), holds the forward to
cuda_attention.FWD_BF16_RULE and times it (chip_smoke.time_ms) at
[8, 12, 2048, 64] and [32, 12, 128, 64] bf16, no bias, not causal.  The
committed shape runs first and last, to show the spread between calls.
Prints one JSON line per run.  Imports nothing of JAX or paddle_tpu.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from port_attention_mutants import run_in_copy  # noqa: E402

COMMITTED = ("constexpr int kFwdWarpTiles = 2;\n", "constexpr int kFwdChunk = 32;\n")
# name -> (16-row tiles a warp owns, keys a pass); the committed shape is (2, 32)
VARIANTS = {
    "committed": (2, 32),
    "16 rows a warp, 64 keys a pass": (1, 64),
    "16 rows a warp, 32 keys a pass": (1, 32),
    "32 rows a warp, 64 keys a pass": (2, 64),
}


def edits(tiles, chunk):
    """The lines of the committed shape, and the variant's in their place."""
    new = (f"constexpr int kFwdWarpTiles = {tiles};\n", f"constexpr int kFwdChunk = {chunk};\n")
    return [(old, repl) for old, repl in zip(COMMITTED, new) if old != repl]


TIME = """
import ctypes, json, torch, chip_smoke
from paddle_tpu_torch import _build
from paddle_tpu_torch.ops import cuda_attention as ca
occ = (ctypes.c_int * 4)()
_build.call("ptt_attention_occupancy", 0, 64, 1, 0, occ)
rec = {"ctas_per_sm": occ[0], "registers": occ[1], "smem_bytes": occ[2], "local_bytes": occ[3]}
gen = torch.Generator(device="cuda").manual_seed(0)
for B, L in ((8, 2048), (32, 128)):
    q, k, v = (torch.randn(B, 12, L, 64, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    out, _ = ca.attention_fwd(q, k, v, None, False, 0.125)
    want = ca.sdpa_plain(q, k, v, None, False, 0.125)
    allowed = ca.sdpa_fwd_bf16_allowed(q, k, v, None, False, 0.125, want)
    share = float(((out.float() - want.float()).abs() / allowed).max())
    assert share <= 1.0, share
    rec[f"[{B},12,{L},64]"] = {"ms": chip_smoke.time_ms(
        lambda: ca.attention_fwd(q, k, v, None, False, 0.125)), "worst_share_of_allowed": share}
print(json.dumps(rec))
"""


def main():
    ok = True
    for name in list(VARIANTS) + ["committed"]:
        run = run_in_copy(edits(*VARIANTS[name]), TIME)
        lines = [line for line in run.stdout.splitlines() if line.startswith("{")]
        rec = json.loads(lines[-1]) if run.returncode == 0 and lines else {
            "error": (run.stderr.strip().splitlines() or [""])[-1][:400]}
        ok &= run.returncode == 0
        print(json.dumps({"variant": name, **rec}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

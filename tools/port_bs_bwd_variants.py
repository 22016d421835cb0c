#!/usr/bin/env python3
"""Where the bf16-score attention backward's time goes, on a CUDA card.

    python3 tools/port_bs_bwd_variants.py [VARIANT ...]

Each variant is a copy of paddle_tpu_torch built in a temporary directory
outside the checkout with csrc/attention_bwd_bs.cu changed, timed in its own
process (chip_smoke.time_ms) beside the f32-score dQ and dK/dV kernels of
the same build, at [8, 12, 2048, 64] and [32, 12, 128, 64] bf16 (BERT-base
at seq 2048 and 128, no bias, not causal):
  - committed: the kernels as they are (held to BWD_BF16_RULE +
    SCORE_ROUNDING_RULE + TIE_RULE, the worst share printed);
  - edge_tests_everywhere: every tile takes the pair loop with the edge
    tests (what interior tiles took before they had a copy of their own);
  - no_per_score_work: the pair loops run no pair (the products run on
    stale fragments): the products, the stream and the barriers;
  - stream_only: neither products nor per-score work: the TMA stream, the
    statistics' copies and the barriers alone;
  - without_tie_block: dQ records no tie in its slots (the row max's
    cotangent's bookkeeping in the tiles that hold a row's maximum);
  - without_dm_sum: dQ sums no g into its rows' dm (the cotangent's sum a
    score pair);
  - tie_block_as_branch: the tie block runs only in the tiles where the
    warp has a tie, behind a warp-wide branch.
The variants other than committed compute wrong gradients and are not
checked.  Prints one JSON line a variant.  Imports nothing of JAX or
paddle_tpu.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from port_attention_mutants import run_in_copy  # noqa: E402

BS_BWD = "paddle_tpu_torch/csrc/attention_bwd_bs.cu"
# (old, new) edits of each variant; each old occurs once in BS_BWD
EDGE_EVERYWHERE = [
    ("    if (edge)\n      pairs(std::true_type{});\n    else\n      pairs(std::false_type{});\n"
     "    if (issue_next) {\n      const int nc",
     "    pairs(std::true_type{});\n    if (issue_next) {\n      const int nc"),
    ("    if (edge)\n      pairs(std::true_type{});\n    else\n      pairs(std::false_type{});\n"
     "    // the tile's ties",
     "    pairs(std::true_type{});\n    // the tile's ties"),
]
NO_PAIRS = [
    ("      for (int j = 0; j < NC / 8; ++j) {\n", "      for (int j = 0; j < 0; ++j) {\n"),
    ("      for (int k = 0; k < 16; ++k) {\n        uint32_t tie;\n        ds[k] = pair(",
     "      for (int k = 0; k < 0; ++k) {\n        uint32_t tie;\n        ds[k] = pair("),
]
NO_PRODUCTS = [
    ("    if constexpr (N == 64) h::wgmma_ss_n64(d, da, db, kk > 0);\n"
     "    else h::wgmma_ss_n32(d, da, db, kk > 0);\n", "    (void)da, (void)db;\n"),
    ("      if constexpr (T::kBox == 64) h::wgmma_rs_n64_tb(acc[b], f, d);\n"
     "      else if constexpr (T::kBox == 32) h::wgmma_rs_n32_tb(acc[b], f, d);\n"
     "      else h::wgmma_rs_n16_tb(acc[b], f, d);\n", "      (void)d, (void)f;\n"),
]
NO_TIE_BLOCK = [("    for (int hh = 0; hh < 2; ++hh) {\n      const uint32_t mine = tb",
                 "    for (int hh = 0; hh < 0; ++hh) {\n      const uint32_t mine = tb")]
# the tie block as a warp-wide branch taken in the tiles that hold a tie
TIE_BRANCH = [("#pragma unroll\n    for (int hh = 0; hh < 2; ++hh) {\n      const uint32_t mine = tb",
               "    if (__any_sync(0xffffffffu, tb != 0u))\n#pragma unroll\n"
               "    for (int hh = 0; hh < 2; ++hh) {\n      const uint32_t mine = tb")]
NO_DM_SUM = [("        part[k & 1] += y.x + y.y;\n", "")]
VARIANTS = {"committed": [], "edge_tests_everywhere": EDGE_EVERYWHERE,
            "no_per_score_work": NO_PAIRS, "stream_only": NO_PAIRS + NO_PRODUCTS,
            "without_tie_block": NO_TIE_BLOCK, "without_dm_sum": NO_DM_SUM,
            "tie_block_as_branch": TIE_BRANCH}

TIME = """
import json, torch, chip_smoke
from paddle_tpu_torch.ops import cuda_attention as ca
gen = torch.Generator(device="cuda").manual_seed(0)
rec = {}
for B, L in ((8, 2048), (32, 128)):
    q, k, v, do = (torch.randn(B, 12, L, 64, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    a0 = (q, k, v, None, False, 0.125)
    out, st = ca.attention_fwd(*a0, score_bf16=True)
    dq, di = ca.attention_bwd_dq(*a0, out, st, do, score_bf16=True)
    dk, dv = ca.attention_bwd_dkv(*a0, st, di, do, score_bf16=True)
    r = {}
    if CHECK:
        want = ca.sdpa_bwd_plain(*a0, out, do, score_bf16=True)
        extra = list(ca.score_rounding_allowed(*a0, out, do))
        for i, t in enumerate(ca.tie_allowed(*a0, out, do, t=di[1])):
            extra[i] = extra[i] + t
        base = ca.sdpa_bwd_bf16_allowed(*a0, out, do, want, score_bf16=True)
        r["worst_share_of_allowed"] = max(
            float(((g.float() - w.float()).abs() / (b + e)).max())
            for g, w, b, e in zip((dq, dk, dv), want, base, extra))
        assert r["worst_share_of_allowed"] <= 1.0, r
        del want, extra, base
    out32, lse32 = ca.attention_fwd(*a0)
    di32 = ca.attention_bwd_dq(*a0, out32, lse32, do)[1]
    r["dq_ms"] = chip_smoke.time_ms(lambda: ca.attention_bwd_dq(*a0, out, st, do, score_bf16=True))
    r["dkv_ms"] = chip_smoke.time_ms(lambda: ca.attention_bwd_dkv(*a0, st, di, do,
                                                                  score_bf16=True))
    r["f32_score_dq_ms"] = chip_smoke.time_ms(lambda: ca.attention_bwd_dq(*a0, out32, lse32, do))
    r["f32_score_dkv_ms"] = chip_smoke.time_ms(lambda: ca.attention_bwd_dkv(*a0, lse32, di32, do))
    rec[f"[{B},12,{L},64]"] = r
print(json.dumps(rec))
"""


def main():
    names = sys.argv[1:] or list(VARIANTS)
    ok = True
    for name in names:
        run = run_in_copy(VARIANTS[name], f"CHECK = {name == 'committed'}\n" + TIME,
                          source=BS_BWD)
        lines = [line for line in run.stdout.splitlines() if line.startswith("{")]
        ok &= run.returncode == 0
        print(json.dumps({"variant": name, "returncode": run.returncode,
                          "result": json.loads(lines[-1]) if lines else None,
                          "error": (run.stderr.strip().splitlines() or [""])[-1][:400]
                          if run.returncode else None}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Mutation check of the port's element-by-element kernel rules on a CUDA
card: the bfloat16 attention kernels' (paddle_tpu_torch.ops.cuda_attention
FWD_BF16_RULE and BWD_BF16_RULE), the bias+activation backward's
(cuda_kernels.BIAS_ACT_BWD_RULE), the LayerNorm+residual forward's
(FUSED_KERNELS' tolerance) and the softmax cross-entropy forward's (2e-5 on
the loss and lse).

    python3 tools/port_attention_mutants.py [NAME ...]

Builds deliberately broken copies of paddle_tpu_torch in temporary
directories outside the checkout, each with its own kernel build, and holds
each against its plain version in its own process.  The attention mutants
run chip_smoke.check_attention_kernels at [8, 12, 2048, 64] bf16 (BERT-base
at seq 2048, no bias, not causal):
  - fwd_skips_last_key_tile: the forward stops before its last tile of 64
    keys;
  - fwd_leaves_out_last_key: the forward treats the last key as past the
    end of the sequence;
  - dkv_skips_last_query_tile: the dK/dV kernel stops before its last tile of
    64 queries;
  - dq_skips_last_key_tile: the dQ kernel stops before its last tile of 64
    keys.
The bf16-score forward's mutants (csrc/attention_fwd_bs.cu) run
chip_smoke.check_bf16_score_kernels, bf16, each at two shapes: [8, 12,
2048, 64] (a cluster of 4, 8 buffered tiles a CTA) and [2, 12, 128, 64] x
513 keys (one key past one CTA's score buffer: a cluster of 2, the last
tile one key):
  - bs_fwd_score_pass_skips_last_tile: the score pass leaves out each CTA's
    last key tile (its row maxima and its buffered scores);
  - bs_fwd_output_reads_neighbouring_tile: the output pass reads the next
    tile of the score buffer;
  - bs_fwd_drops_peer_partial: the cluster's sum of partial P V leaves out
    the last CTA's.
The bf16-score backward's mutants (csrc/attention_bwd_bs.cu) run the same
check at [8, 12, 2048, 64] and at [4, 12, 65, 64] x 65 keys (one row past
a CTA's own 64 and a streamed tile's, so that each last tile holds one row):
  - bs_dkv_skips_last_query_tile: dK/dV takes nothing from its last tile of
    64 queries (its P^T and dS^T fragments zeroed);
  - bs_dkv_reads_neighbouring_row_max: dK/dV takes each query's row max m
    from the neighbouring query of its pair;
  - bs_dq_skips_last_key_tile: dQ takes nothing from its last tile of 64 keys;
  - bs_dq_drops_di: dQ forms dS = bf16(P dP) * scale, di taken as 0.
The mutant of fault C5 (the port's bf16-score backward before it took the
gradient through the row max) is both bf16-score backwards without it:
  - bs_bwd_drops_max_cotangent: dQ takes each row's share of its max's
    cotangent as 0 (so dK/dV adds 0 too), in attention_bwd_bs.cu and in
    flash_attention.cu's float32-input kBS dQ.
It runs the same check with float32 inputs (the FFMA kBS kernels) at the
65-key case of phase 3, [1, 2, 65, 16] x 65, and at its many forced ties,
causal [1, 4, 70, 64] x 100 (twelve keys made one, 8 apart); phase 3 prints the
worst share bfloat16's rule gives the same fault (rule_sees_max_cotangent).
The row-wise mutants run one call at the BERT-base training shape, bf16,
[4096, 3072] gelu for the bias+activation backward, [4096, 768] with a
residual for the LayerNorm forward and [4096, 30522] with MLM labels (85%
ignored) for the cross-entropy forward.  Before the call the caching allocator
is poisoned with NaN tensors of the outputs' sizes (chip_smoke.poison), so
memory left by an earlier correct call cannot hide an element the mutant
fails to write; every output is then held to its rule:
  - bias_act_bwd_skips_last_band_row: each band of the backward stops one
    row short;
  - bias_act_bwd_drops_a_partial_row: the column pass leaves out the last
    band's partial row of dbias;
  - ln_fwd_stops_one_row_early: the forward leaves out the last row;
  - ln_fwd_drops_last_chunk: the forward leaves out the last 16-byte chunk
    of every row;
  - xent_fwd_skips_last_live_row: the softmax cross-entropy forward stops
    before the last row, which the check labels;
  - xent_fwd_drops_last_chunk: the cross-entropy forward leaves out the last
    16-byte chunk of every row.
Prints one JSON line per mutant (whether a check rejected it, each checked
output's worst share of its allowance (NaN where poisoned memory showed
through), the error), and exits 0 only when every mutant was rejected.
Imports nothing of JAX or paddle_tpu.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATTENTION = "paddle_tpu_torch/csrc/flash_attention.cu"
BS_FWD = "paddle_tpu_torch/csrc/attention_fwd_bs.cu"
BS_BWD = "paddle_tpu_torch/csrc/attention_bwd_bs.cu"
BIAS_ACT = "paddle_tpu_torch/csrc/bias_act.cu"
LAYER_NORM = "paddle_tpu_torch/csrc/ln_residual.cu"
XENT = "paddle_tpu_torch/csrc/softmax_xent.cu"


def _after(path, anchor, extra):
    return path, anchor, anchor + extra


# name -> (source, a line of it, what replaces that line in the mutant)
MUTANTS = {
    "fwd_skips_last_key_tile": _after(
        ATTENTION, "    __syncthreads();  // tile t (and at t = 0 Q) landed for every thread\n",
        "    if (t == n_tiles - 1) break;\n"),
    "fwd_leaves_out_last_key": _after(
        ATTENTION,
        "  const int n_tiles = pr.key_tiles(q0 + q_rows);  // >= 1; the forward's key tiles\n",
        "  pr.Lk -= 1;\n"),
    "dkv_skips_last_query_tile": _after(
        ATTENTION,
        "    __syncthreads();  // tile t (and at the first K and V) landed for every thread\n",
        "    if (t == t_end - 1) break;\n"),
    "dq_skips_last_key_tile": _after(
        ATTENTION,
        "    __syncthreads();  // tile t (and at t = 0 Q and dO) landed for every thread\n",
        "    if (t == n_tiles - 1) break;\n"),
    "bias_act_bwd_skips_last_band_row": _after(
        BIAS_ACT, "      if (row >= r1) break;  // past the group's last row of the band\n",
        "      if (row == r1 - 1) break;\n"),
    "bias_act_bwd_drops_a_partial_row": (
        BIAS_ACT, "                         static_cast<int>(bands), d, stream);\n",
        "                         static_cast<int>(bands) - 1, d, stream);\n"),
    "ln_fwd_stops_one_row_early": (
        LAYER_NORM,
        "  const bool active = row < rows;  // no early return: row_sum synchronises the block\n",
        "  const bool active = row < rows - 1;\n"),
    "ln_fwd_drops_last_chunk": _after(
        LAYER_NORM, "    if (active && col < d) {\n      float sc[VEC], bi[VEC];\n",
        "      if (col + VEC >= d) continue;\n"),
    "xent_fwd_skips_last_live_row": _after(
        XENT, "    if (row >= rows) break;\n", "    if (row == rows - 1) break;\n"),
    "xent_fwd_drops_last_chunk": (
        XENT, "    if (i < n_vec) {\n      dst[k] = body[i];\n",
        "    if (i < n_vec - 1) {\n      dst[k] = body[i];\n"),
    "bs_fwd_score_pass_skips_last_tile": _after(
        BS_FWD, "    st_cur = st_nxt;\n", "    if (i == n - 1) return;\n"),
    "bs_fwd_output_reads_neighbouring_tile": (
        BS_FWD, "  auto make_p = [&](int i, uint32_t (&pa)[16]) {\n    if (i < nb) {\n"
                "      load_words(i, w);\n",
        "  auto make_p = [&](int i, uint32_t (&pa)[16]) {\n    if (i < nb) {\n"
        "      load_words((i + 1) % nb, w);\n"),
    "bs_fwd_drops_peer_partial": (
        BS_FWD, "      for (int x = 0; x < C; ++x) {  // the cluster's partial P V, in rank order\n",
        "      for (int x = 0; x < C - 1; ++x) {\n"),
    "bs_dkv_skips_last_query_tile": (
        BS_BWD, "    const uint32_t q_addr = ring_addr + (i % S) * T::kStageKV;\n    rs_issue",
        "    if (i == n - 1)\n      for (int w = 0; w < NC / 4; ++w) pa[w] = ds[w] = 0u;\n"
        "    const uint32_t q_addr = ring_addr + (i % S) * T::kStageKV;\n    rs_issue"),
    "bs_dkv_reads_neighbouring_row_max": (
        BS_BWD, "        const float2 mf = *reinterpret_cast<const float2*>(m_s + col);\n",
        "        const float2 mf = make_float2(m_s[col + 1], m_s[col]);\n"),
    "bs_dq_skips_last_key_tile": (
        BS_BWD, "    rs_issue<DH, 4>(dq, ds, ring_addr + (t % S) * T::kStageQ, 0);  // dQ += dS K\n",
        "    if (t == n - 1)\n      for (int w = 0; w < 16; ++w) ds[w] = 0u;\n"
        "    rs_issue<DH, 4>(dq, ds, ring_addr + (t % S) * T::kStageQ, 0);\n"),
    "bs_dq_drops_di": (
        BS_BWD, "    di_r[hh] = di_s[row];\n", "    di_r[hh] = 0.f;\n"),
    "bs_bwd_drops_max_cotangent": [
        (BS_BWD, "    t_r[hh] = c > 0 ? round_bf16(round_bf16(-sum) / static_cast<float>(c)) : 0.f;\n",
         "    t_r[hh] = 0.f;\n"),
        (ATTENTION,
         "      t_r[r] = c > 0 ? round_bf16(round_bf16(-sum) / static_cast<float>(c)) : 0.f;\n",
         "      t_r[r] = 0.f;\n")],
}
# the shapes and input dtype the C5 mutant runs at, by suffix
C5_CASES = {"l65": (1, 2, 65, 65, 16, None, False),
            "many_ties": (1, 4, 70, 100, 64, "many_ties", True)}
# the shapes each bf16-score forward mutant runs at, by suffix
BS_CASES = {"seq2048": (8, 12, 2048, 2048, 64, None, False),
            "lk513": (2, 12, 128, 513, 64, None, False)}
# the shapes each bf16-score backward mutant runs at, by suffix
BS_BWD_CASES = {"seq2048": (8, 12, 2048, 2048, 64, None, False),
                "l65": (4, 12, 65, 65, 64, None, False)}
CHECK_ATTENTION = (
    "import torch, chip_smoke\n"
    "from paddle_tpu_torch.ops import cuda_attention as ca\n"
    "chip_smoke.check_attention_kernels(torch, ca, cases=[(8, 12, 2048, 2048, 64, None, False, "
    "'normal')], dtypes=('bfloat16',))\n")
# one poisoned call; every output's worst share of its allowance is printed
# before the verdict, so a mutant shows each output it broke
CHECK_ROWWISE = """
import json, math, torch, chip_smoke
from paddle_tpu_torch.ops import cuda_kernels as ck
gen = torch.Generator(device="cuda").manual_seed(7)
def rn(*shape, s=1.0, d=torch.bfloat16):
    return (torch.randn(*shape, generator=gen, device="cuda") * s).to(d)
shares = {}
if KERNEL == "bias_act_bwd":
    x, g, b = rn(4096, 3072), rn(4096, 3072), rn(3072, s=0.1, d=torch.float32)
    chip_smoke.poison(torch, (x.shape, x.dtype), ((3072,), torch.float32))
    got = ck.bias_act_bwd(x, b, g, "gelu")
    want = ck.bias_act_bwd_plain(x, b, g, "gelu")
    for w, a, c, t in zip(("dx", "dbias"), got, want, ck.bias_act_bwd_allowed(x, b, g, "gelu", want)):
        shares[w] = float(((a.float() - c.float()).abs() / t).max())
elif KERNEL == "softmax_xent_fwd":
    V = 30522
    x = rn(4096, V, s=2.0)
    lab = torch.randint(0, V, (4096,), generator=gen, device="cuda")
    masked = torch.rand(4096, generator=gen, device="cuda") < 0.85
    lab = torch.where(masked, torch.full_like(lab, -100), lab)
    lab[-1] = 7  # the last row is labelled: the last live row
    lab = lab.to(torch.int32)
    live = lab != -100
    chip_smoke.poison(torch, ((4096,), torch.float32), ((4096,), torch.float32))
    loss, lse = ck.softmax_xent_fwd(x, lab)
    loss_p, lse_p = ck.softmax_xent_fwd_plain(x, lab)
    tol = chip_smoke.TOL["bfloat16"]["softmax_xent_fwd"]
    shares["loss"] = float((loss - loss_p).abs().max()) / tol
    shares["lse"] = float((lse - lse_p)[live].abs().max()) / tol
else:
    x, r = rn(4096, 768), rn(4096, 768)
    s, b = rn(768, s=0.2, d=torch.float32) + 1.0, rn(768, s=0.1, d=torch.float32)
    chip_smoke.poison(torch, (x.shape, x.dtype))
    got = ck.fused_ln_residual(x, r, s, b, 1e-5)
    err = float((got.float() - ck.ln_residual_plain(x, r, s, b, 1e-5).float()).abs().max())
    shares["out"] = err / chip_smoke.TOL["bfloat16"]["ln_residual_fwd"]
print(json.dumps({"kernel": KERNEL, "worst_share_of_allowed": shares}))
bad = {k: v for k, v in shares.items() if not v <= 1.0}
if bad:
    raise AssertionError(f"{KERNEL}: the worst share of the allowance exceeds 1: {bad}")
"""


def check_code(source, case=None, dtype="bfloat16"):
    if source == ATTENTION:
        return CHECK_ATTENTION
    if source in (BS_FWD, BS_BWD):
        return ("import torch, chip_smoke\n"
                "from paddle_tpu_torch.ops import cuda_attention as ca\n"
                f"chip_smoke.check_bf16_score_kernels(torch, ca, cases=[{case!r}], "
                f"dtypes=({dtype!r},))\n")
    kernel = {BIAS_ACT: "bias_act_bwd", LAYER_NORM: "ln_residual_fwd",
              XENT: "softmax_xent_fwd"}[source]
    return f"KERNEL = {kernel!r}\n" + CHECK_ROWWISE


def copy_port(workdir, edits):
    """Copy paddle_tpu_torch (without its build) and chip_smoke.py into
    `workdir`, then replace in each `source` of `edits` [(source, old,
    new)] its `old`, which must occur exactly once."""
    shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"), os.path.join(workdir, "paddle_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), workdir)
    for source, old, new in edits:
        path = os.path.join(workdir, source)
        with open(path) as f:
            src = f.read()
        if src.count(old) != 1:
            raise RuntimeError(f"{source}: {old.strip()!r} occurs {src.count(old)} times")
        with open(path, "w") as f:
            f.write(src.replace(old, new))


def run_in_copy(edits, code, timeout=900, source=ATTENTION):
    """Run `code` with Python in a fresh copy of the port built with `edits`
    [(source, old, new)], or [(old, new)] of `source`."""
    workdir = tempfile.mkdtemp(prefix="port-copy-")
    try:
        copy_port(workdir, [e if len(e) == 3 else (source,) + tuple(e) for e in edits])
        return subprocess.run([sys.executable, "-c", code], cwd=workdir, capture_output=True,
                              text=True, timeout=timeout)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def edits_of(name):
    """[(source, old, new)] of a mutant."""
    m = MUTANTS[name]
    return m if isinstance(m, list) else [m]


def runs(names):
    """(run name, mutant, its check code): a bf16-score forward mutant once
    for each of BS_CASES, a backward one for each of BS_BWD_CASES, the C5
    mutant for each of C5_CASES with float32 inputs."""
    for name in names:
        source = edits_of(name)[0][0]
        if name == "bs_bwd_drops_max_cotangent":
            for suffix, case in C5_CASES.items():
                yield f"{name}@{suffix}", name, check_code(source, case, "float32")
        elif source in (BS_FWD, BS_BWD):
            for suffix, case in (BS_CASES if source == BS_FWD else BS_BWD_CASES).items():
                yield f"{name}@{suffix}", name, check_code(source, case)
        else:
            yield name, name, check_code(source)


def main():
    names = sys.argv[1:] or list(MUTANTS)
    rejected_all = True
    for run_name, name, code in runs(names):
        run = run_in_copy(edits_of(name), code)
        records = [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]
        checks = [r for r in records if r.get("check", "").startswith("attention_")
                  or "worst_share_of_allowed" in r and "kernel" in r]
        error = (run.stderr.strip().splitlines() or [""])[-1]
        rejected = run.returncode != 0 and error.startswith("AssertionError") and (
            "exceeds" in error)
        rejected_all &= rejected
        print(json.dumps({"mutant": run_name, "rejected": rejected, "returncode": run.returncode,
                          "checks": checks, "error": error[:400]}), flush=True)
    return 0 if rejected_all else 1


if __name__ == "__main__":
    sys.exit(main())

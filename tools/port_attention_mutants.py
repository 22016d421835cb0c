#!/usr/bin/env python3
"""Mutation check of the bfloat16 attention kernels' element-by-element
rules (paddle_tpu_torch.ops.cuda_attention.FWD_BF16_RULE and BWD_BF16_RULE)
on a CUDA card.

    python3 tools/port_attention_mutants.py

Builds deliberately broken copies of paddle_tpu_torch in temporary
directories outside the checkout, each with its own kernel build, and runs
chip_smoke.check_attention_kernels on each, in its own process, at
[8, 12, 2048, 64] bf16 (BERT-base at seq 2048, no bias, not causal):
  - fwd_skips_last_key_tile: the forward stops before its last tile of 64
    keys;
  - fwd_leaves_out_last_key: the forward treats the last key as past the
    end of the sequence;
  - dkv_skips_last_query_tile: the dK/dV kernel stops before its last tile of
    64 queries;
  - dq_skips_last_key_tile: the dQ kernel stops before its last tile of 64
    keys.
Prints one JSON line per mutant (whether the check rejected it, the check
records of the attention kernels, the error), and exits 0 only when every
mutant was rejected.  Imports nothing of JAX or paddle_tpu.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
# name -> (line of the source to break, what follows it in the mutant)
MUTANTS = {
    "fwd_skips_last_key_tile": (
        "    __syncthreads();  // tile t (and at t = 0 Q) landed for every thread\n",
        "    if (t == n_tiles - 1) break;\n"),
    "fwd_leaves_out_last_key": (
        "  const int n_tiles = pr.key_tiles(q0 + q_rows);  // >= 1; the forward's key tiles\n",
        "  pr.Lk -= 1;\n"),
    "dkv_skips_last_query_tile": (
        "    __syncthreads();  // tile t (and at the first K and V) landed for every thread\n",
        "    if (t == t_end - 1) break;\n"),
    "dq_skips_last_key_tile": (
        "    __syncthreads();  // tile t (and at t = 0 Q and dO) landed for every thread\n",
        "    if (t == n_tiles - 1) break;\n"),
}
CHECK = ("import torch, chip_smoke\n"
         "from paddle_tpu_torch.ops import cuda_attention as ca\n"
         "chip_smoke.check_attention_kernels(torch, ca, cases=[(8, 12, 2048, 2048, 64, None, False, "
         "'normal')], dtypes=('bfloat16',))\n")


def copy_port(workdir, edits):
    """Copy paddle_tpu_torch (without its build) and chip_smoke.py into
    `workdir`, then replace in SOURCE each `old` of `edits` [(old, new)],
    which must occur exactly once."""
    shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"), os.path.join(workdir, "paddle_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), workdir)
    path = os.path.join(workdir, SOURCE)
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{SOURCE}: {old.strip()!r} occurs {src.count(old)} times")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)


def run_in_copy(edits, code, timeout=900):
    """Run `code` with Python in a fresh copy of the port built with `edits`."""
    workdir = tempfile.mkdtemp(prefix="port-copy-")
    try:
        copy_port(workdir, edits)
        return subprocess.run([sys.executable, "-c", code], cwd=workdir, capture_output=True,
                              text=True, timeout=timeout)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main():
    rejected_all = True
    for name, (anchor, extra) in MUTANTS.items():
        run = run_in_copy([(anchor, anchor + extra)], CHECK)
        records = [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]
        checks = [r for r in records if r.get("check", "").startswith("attention_")]
        error = (run.stderr.strip().splitlines() or [""])[-1]
        rejected = run.returncode != 0 and "exceeds" in error
        rejected_all &= rejected
        print(json.dumps({"mutant": name, "rejected": rejected, "returncode": run.returncode,
                          "attention_checks": checks, "error": error[:400]}), flush=True)
    return 0 if rejected_all else 1


if __name__ == "__main__":
    sys.exit(main())

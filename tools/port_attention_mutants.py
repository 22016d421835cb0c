#!/usr/bin/env python3
"""Mutation check of the bfloat16 attention backward's element-by-element
rule (paddle_tpu_torch.ops.cuda_attention.BWD_BF16_RULE) on a CUDA card.

    python3 tools/port_attention_mutants.py

Builds deliberately broken copies of paddle_tpu_torch in temporary
directories outside the checkout, each with its own kernel build, and runs
chip_smoke.check_attention_kernels on each, in its own process, at
[8, 12, 2048, 64] bf16 (BERT-base at seq 2048, no bias, not causal):
  - dkv_skips_last_query_tile: the dK/dV kernel stops before its last tile of
    64 queries;
  - dq_skips_last_key_tile: the dQ kernel stops before its last tile of 64
    keys.
Prints one JSON line per mutant (whether the check rejected it, the check
records of the gradient it broke, the error), and exits 0 only when every
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


def mutate(workdir, anchor, extra):
    shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"), os.path.join(workdir, "paddle_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), workdir)
    path = os.path.join(workdir, SOURCE)
    with open(path) as f:
        src = f.read()
    if src.count(anchor) != 1:
        raise RuntimeError(f"{SOURCE}: the line to break occurs {src.count(anchor)} times")
    with open(path, "w") as f:
        f.write(src.replace(anchor, anchor + extra))


def main():
    rejected_all = True
    for name, (anchor, extra) in MUTANTS.items():
        workdir = tempfile.mkdtemp(prefix=f"mutant-{name}-")
        try:
            mutate(workdir, anchor, extra)
            run = subprocess.run([sys.executable, "-c", CHECK], cwd=workdir, capture_output=True,
                                 text=True, timeout=900)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        records = [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]
        grads = [r for r in records if r.get("check", "").startswith("attention_bwd")]
        error = (run.stderr.strip().splitlines() or [""])[-1]
        rejected = run.returncode != 0 and "exceeds" in error
        rejected_all &= rejected
        print(json.dumps({"mutant": name, "rejected": rejected, "returncode": run.returncode,
                          "gradient_checks": grads, "error": error[:400]}), flush=True)
    return 0 if rejected_all else 1


if __name__ == "__main__":
    sys.exit(main())

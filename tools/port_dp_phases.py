#!/usr/bin/env python3
"""Run chip_smoke.py's data-parallel phases alone on one CUDA card, in one
process: build the kernel library, run phase 12 (bf16 BERT-base, fused
attention, 32 x 128, its graphed arm, kept for phase 75), start phase 76's
gang of two ranks (chip_smoke.dp_gang_start), run phase 75
(chip_smoke.dp_world1), then phase 76 (chip_smoke.dp_gang_card), and, with
--gpu-tests, the data-parallel and dygraph cases of tests/test_torch_gpu.py.

    python3 tools/port_dp_phases.py [--gpu-tests]

Every phase runs with all of its checks and raises as it does in
chip_smoke.py.  Prints the card's name and power limit, the build's
seconds, each phase's JSON records and one {"phase_seconds": ...} line a
phase.  Exits non-zero when a phase or a test fails.  Imports nothing of
JAX or paddle_tpu.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch

    import chip_smoke as C
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import cuda_kernels as ck

    if not torch.cuda.is_available():
        print("port_dp_phases: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"phase": "build", "seconds": _build.build()["seconds"]}), flush=True)
    fluid.monitor.enable()
    tmp = tempfile.mkdtemp()

    def lap(name, t0):
        print(json.dumps({"phase_seconds": name, "s": time.perf_counter() - t0, "card": card}),
              flush=True)

    t0 = time.perf_counter()
    C.train(fluid, torch, ck, card, "train_fused", True, 128, 32, C.FUSED_PER_STEP,
            arms=("graphed",), keep=True)
    lap("train_fused", t0)
    gang = C.dp_gang_start(tmp)
    try:
        t0 = time.perf_counter()
        C.dp_world1(fluid, torch, ck, card)
        lap("dp_world1", t0)
        t0 = time.perf_counter()
        C.dp_gang_card(fluid, torch, ck, card, gang)
        lap("dp_gang_card", t0)
    finally:
        C.dp_gang_stop(gang)
    if "--gpu-tests" in sys.argv[1:]:
        # tests/conftest.py imports JAX, which the card's host lacks
        r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-o",
                            "markers=gpu: needs a CUDA device", "-p", "no:cacheprovider", "-q",
                            "tests/test_torch_gpu.py", "-k",
                            "world_one or two_rank or dygraph_conv_bn"], cwd=ROOT)
        print("gpu tests rc", r.returncode, flush=True)
        return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())

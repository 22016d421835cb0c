#!/usr/bin/env python3
"""Time, in one process on one CUDA card, the phases of chip_smoke.py whose
depth was cut, or was tried cut, to make room for its phases 69-72, at
both depths, and phases 69-72 themselves.

    python3 tools/port_smoke_cuts.py

In this order:
  - phases 69-72 (chip_smoke.host_table_phases), which print their own
    seconds;
  - phase 55's BERT half (chip_smoke.amp_bert_parity, its two arms in
    turn) with 2 layers (before) and AMP_PARITY_LAYERS (now), each with
    the seconds its Executor.run calls took on the card and on the CPU;
  - phase 14 (chip_smoke.train_parity, fused attention) at 32 x 128 (its
    batch) and 8 x 128 (a cut tried and dropped), and at 1 x 2048;
  - phase 64 (chip_smoke.quant_serving over phase 56's bf16 encoder, saved
    here by chip_smoke.save_encoder) at SERVE_REQUESTS (400) requests a
    round and at 200 (a cut tried and dropped).
Every phase runs with all of its checks and raises as it does in
chip_smoke.py.  Prints the card's name and power limit, the CPUs this
process may use (affinity and cgroup quota) beside torch's intra-op
threads, and then one JSON line a run: {"phase_seconds": name, "s": ...,
"depth": ..., "card": ...}.  Imports nothing of JAX or paddle_tpu.
"""
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def cpu_quota():
    """The CPUs the cgroup's quota grants, or None where it sets none."""
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota, period = f.read().split()
    except (OSError, ValueError):
        return None
    return None if quota == "max" else int(quota) / int(period)


@contextlib.contextmanager
def run_seconds(fluid, into):
    """Sum the seconds of Executor.run by place ("card" or "cpu") into `into`."""
    run = fluid.Executor.run

    def timed(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return run(self, *a, **k)
        finally:
            key = "cpu" if isinstance(self.place, fluid.CPUPlace) else "card"
            into[key] = into.get(key, 0.0) + time.perf_counter() - t0

    fluid.Executor.run = timed
    try:
        yield into
    finally:
        fluid.Executor.run = run


def timed(card, name, depth, fn, extra=None):
    t0 = time.perf_counter()
    fn()
    cs.emit({"phase_seconds": name, "s": time.perf_counter() - t0, "depth": depth,
             **(extra or {}), "card": card})


def main():
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import cuda_kernels as ck

    if not torch.cuda.is_available():
        print("port_smoke_cuts: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    cs.emit({"cpus": {"os_cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
                      "cgroup_quota": cpu_quota(), "torch_threads": torch.get_num_threads()}})
    info = _build.build()
    cs.emit({"phase": "build", "seconds": info["seconds"]})
    os.makedirs(os.path.join(ROOT, ".chip_smoke_tmp"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, ".chip_smoke_tmp"))
    fluid.monitor.enable()
    try:
        timed(card, "phases 69-72", "as in chip_smoke",
              lambda: cs.host_table_phases(fluid, torch, ck, tmp, card))
        layers_now = cs.AMP_PARITY_LAYERS
        for layers in (2, layers_now):
            cs.AMP_PARITY_LAYERS = layers
            split = {}
            with run_seconds(fluid, split):
                timed(card, "amp_bert_parity", f"{layers} layer(s) at 2 x 128",
                      lambda: cs.amp_bert_parity(fluid, torch), {"run_s": split})
        cs.AMP_PARITY_LAYERS = layers_now
        for seq_len, batch in ((128, 32), (128, 8), (2048, 1)):
            timed(card, "train_fused_parity", f"{batch} x {seq_len}",
                  lambda: cs.train_parity(fluid, torch, "train_fused_parity", True, seq_len,
                                          batch))
        bert_dir = os.path.join(tmp, "bert_base_bf16_encoder")
        cs.save_encoder(fluid, torch, bert_dir, "bfloat16", 12)
        requests_now = cs.SERVE_REQUESTS
        for requests in (requests_now, 200):
            cs.SERVE_REQUESTS = requests
            timed(card, "quant_serving", f"{requests} requests a round",
                  lambda: cs.quant_serving(fluid, torch, ck, tmp, card, bert_dir))
            shutil.rmtree(os.path.join(tmp, "bert_base_int8"), ignore_errors=True)
            shutil.rmtree(os.path.join(tmp, "bert_base_int8_drift"), ignore_errors=True)
            with contextlib.suppress(FileNotFoundError):
                os.remove(os.path.join(tmp, "quant_metrics.jsonl"))
        cs.SERVE_REQUESTS = requests_now
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

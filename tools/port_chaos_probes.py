#!/usr/bin/env python3
"""The chaos campaign's planted-defect probes on one CUDA card, repeated:
the seed-20 smoke campaign once (train, online, serving), then with
PADDLE_CHAOS_PLANTED_BUG set, each spec the CPU's shrinker tries at seed 8
run three times through chaos.run_one (its verdict, error, fired faults,
violated invariants and diverged variables, and seconds), and the whole
planted campaign twice (its spec, shrunk spec and probe count, and seconds).

    python3 tools/port_chaos_probes.py

A verdict that differs between repeats, or from the CPU's, points at state
one run leaves to the next.  Imports nothing of JAX or paddle_tpu.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the specs the shrinker tries on the CPU, from the planted arm's caught spec down
PROBES = ("nan@2;device@7:UNAVAILABLE", "nan@0;device@7:UNAVAILABLE",
          "nan@0;device@3:UNAVAILABLE", "nan@0;device@1:UNAVAILABLE",
          "nan@0;device@0:UNAVAILABLE")


def main():
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import chaos

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    fluid.monitor.enable()
    card = fluid.CUDAPlace(0)
    chaos.run_campaign(("train", "online", "serving"), seed=20, per_scenario=1, place=card)
    os.environ[chaos.PLANTED_BUG_ENV] = "1"
    try:
        for rep in range(3):
            for spec in PROBES:
                t0 = time.perf_counter()
                r = chaos.run_one("train", spec, seed=8, place=card)
                print(rep, spec, r.ok, r.error, r.fired, [v.invariant for v in chaos.evaluate(r)],
                      r.data.get("diverged_vars"), round(time.perf_counter() - t0, 2), flush=True)
        for _ in range(2):
            t0 = time.perf_counter()
            p = chaos.run_campaign(("train",), seed=8, per_scenario=1, place=card)
            print("planted campaign", [(v["spec"], v.get("shrunk_spec"), v.get("shrink_runs"))
                                       for v in p.violations],
                  round(time.perf_counter() - t0, 2), flush=True)
    finally:
        os.environ.pop(chaos.PLANTED_BUG_ENV, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())

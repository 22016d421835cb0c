#!/usr/bin/env python3
"""Probe the two gradient-sync modes of a gang on one CUDA card: two ranks
(launch.run_gang of this script, gloo, both on the card) train phase 76's
f32 parity program (BERT, 2 layers, fused attention, global batch 8 x 128,
dropout 0) for PROBE_STEPS Adam steps (default 2) in each mode, and each
rank prints one line `PROBE <rank> {json}`:
  - plain_grads_vs_expected: the gang's gradients against each rank's own
    gradients all-reduced by hand, both of the last step (like for like
    only at PROBE_STEPS=1: from step 2 each rank's own run has taken its
    own update);
  - serial_vs_serial, bucketed_vs_bucketed, plain_vs_plain: each mode
    against a repeat of itself (every persistable after the last step);
  - serial_vs_bucketed, serial_vs_plain, bucketed_vs_bucketed_big (one
    bucket): the modes against each other;
  - per_step: the sync's inputs, outputs and their pointers' 16-byte
    alignment, serial against bucketed, step by step;
  - hook: the bucketed mode's hooked gradients against the ones
    torch.autograd.grad returns.
Each comparison is [the number of tensors that differ, the worst three
(name, max abs difference)].

    python3 tools/port_dp_probe.py

Imports nothing of JAX or paddle_tpu.
"""
import json
import os
import sys
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def rank_main():
    import numpy as np, torch, torch.distributed
    import chip_smoke as C
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_distributed()
    HOOK = {"checks": 0, "differ": 0, "names": []}
    _orig_finish = dist._HookedBuckets.finish

    def finish(self, named_grads):
        by = dict(named_grads)
        for b, got in enumerate(self.got):
            for n, g in got.items():
                HOOK["checks"] += 1
                if not torch.equal(g, by[n]) or g.data_ptr() != by[n].data_ptr():
                    HOOK["differ"] += 1
                    HOOK["names"].append((n, g.data_ptr() == by[n].data_ptr(),
                                          float((g - by[n]).abs().max())))
        return _orig_finish(self, named_grads)

    dist._HookedBuckets.finish = finish
    REC = {}
    _orig_call = dist.GradSync.__call__
    _orig_fin = dist._HookedBuckets.finish

    def call(self, named):
        out = _orig_call(self, named)
        REC.setdefault(("serial" if self.mode == "serial" else "other"), []).append(
            ({n: g.detach().clone() for n, g in named}, {n: g.detach().clone() for n, g in out.items()},
             {n: g.data_ptr() % 16 for n, g in out.items()}))
        return out

    def fin(self, named):
        out = _orig_fin(self, named)
        REC.setdefault("bucketed", []).append(
            ({n: g.detach().clone() for n, g in named}, {n: g.detach().clone() for n, g in out.items()},
             {n: g.data_ptr() % 16 for n, g in out.items()}))
        return out

    dist.GradSync.__call__ = call
    dist._HookedBuckets.finish = fin
    rank, world = dist.trainer_id(), dist.num_trainers()
    place = fluid.CUDAPlace(0)
    main, loss, state, gfeed = C.train_parity_setup(fluid, True, 128, 8)
    per = 8 // world
    feed = {k: v[rank * per:(rank + 1) * per] for k, v in gfeed.items()}
    params = [p.name for p in main.all_parameters()]
    fetch = [loss] + [f"{p}@GRAD" for p in params]

    STEPS = int(os.environ["PROBE_STEPS"])

    def step(prog, grads=True):
        s = fluid.Scope()
        fluid.io.load_numpy_params(s, state, device=place.device)
        e = fluid.Executor(place)
        for _ in range(STEPS):
            out = e.run(prog, feed=feed, fetch_list=fetch if grads else [loss], scope=s)
        moments = {n: s.to_numpy(n).copy() for n in state}
        return [np.array(o, np.float32) for o in out[1:]], moments

    local, _ = step(main)
    expect = []
    for g in local:
        t = torch.from_numpy(g.copy())
        torch.distributed.all_reduce(t)
        expect.append((t * 0.5).numpy())
    res = {}
    got, _ = step(fluid.CompiledProgram(main).with_data_parallel(loss_name=loss))
    diff = {p: float(np.abs(a - b).max()) for p, a, b in zip(params, got, expect)
            if not np.array_equal(a, b)}
    res["plain_grads_vs_expected"] = {"n_differ": len(diff), "worst": sorted(diff.items(), key=lambda x: -x[1])[:4]}
    moms = {}
    for i, mode in enumerate(["serial", "bucketed", "serial", "bucketed", "plain", "plain", "bucketed_big"]):
        prog = fluid.CompiledProgram(main).with_data_parallel(loss_name=loss)
        if mode.startswith("bucketed"):
            prog = prog.with_grad_overlap(mode="bucketed", bucket_mb=1e6 if mode == "bucketed_big" else None)
        elif mode == "serial":
            prog = prog.with_grad_overlap(mode="serial")
        moms[i] = step(prog, grads=False)[1]

    def cmp(a, b):
        d = {n: float(np.abs(moms[a][n] - moms[b][n]).max()) for n in moms[a]
             if not np.array_equal(moms[a][n], moms[b][n])}
        return [len(d), sorted(d.items(), key=lambda x: -x[1])[:3]]

    res["serial_vs_serial"] = cmp(0, 2)
    res["bucketed_vs_bucketed"] = cmp(1, 3)
    res["plain_vs_plain"] = cmp(4, 5)
    res["serial_vs_bucketed"] = cmp(0, 1)
    res["serial_vs_plain"] = cmp(0, 4)
    res["bucketed_vs_bucketed_big"] = cmp(1, 6)
    local2, m2 = step(main)
    res["local_repeat_differ"] = sum(not np.array_equal(a, b) for a, b in zip(local, local2))
    m1 = step(main)[1]
    res["local_state_repeat_differ"] = [n for n in m1 if not np.array_equal(m1[n], m2[n])][:6]
    cmp2 = []
    ser, buc = REC.get("serial", []), REC.get("bucketed", [])
    for k in range(min(len(ser), len(buc), STEPS)):
        (si, so, sa), (bi, bo, ba) = ser[k], buc[k]
        cmp2.append({"step": k, "inputs_differ": [n for n in si if not torch.equal(si[n], bi[n])][:4],
                     "outputs_differ": [n for n in so if not torch.equal(so[n], bo[n])][:4],
                     "align_differ": [(n, sa[n], ba[n]) for n in sa if sa[n] != ba[n]][:6]})
    res["per_step"] = cmp2
    res["hook"] = {"checks": HOOK["checks"], "differ": HOOK["differ"], "names": HOOK["names"][:6]}
    print("PROBE", rank, json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main())
    from paddle_tpu_torch import _build, launch
    print(_build.build()["seconds"], flush=True)
    steps = os.environ.get("PROBE_STEPS", "2")
    r = launch.run_gang([sys.executable, os.path.abspath(__file__), "--rank"], 2, max_restarts=0,
                        timeout=400, extra_env={"PROBE_STEPS": steps})
    for c, o, e in r.workers:
        print("steps", steps, c, o[-4000:], e[-3000:] if c else "")
    sys.exit(0 if r.ok else 1)

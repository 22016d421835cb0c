#!/usr/bin/env python3
"""How far rounding noise moves DeepFM's float32 training state, on the CPU.

    python3 tools/deepfm_conditioning.py

chip_smoke.py phase 16 holds DeepFM's persistables on the card to those on
the CPU within 1e-5 of each one's largest magnitude.  That can only hold
where the training steps are well conditioned: where a change of the order
of one rounding in the inputs moves no persistable by more than a small
share of that tolerance.  This script measures it for two optimizer
settings of phase 16's model (26 fields, vocab 200,000, embed 16, MLP 64 x
64, batch 512, 3 Adagrad steps then 3 lazy_mode Adam steps from one
state): it trains twice on the CPU, the second time with every fc weight
moved by one float32 ulp, and prints, per setting, each persistable's
largest difference as a share of its tolerance, both over all elements and
over the elements whose gradient is not 0 to rounding (chip_smoke.ZERO_GRAD
of the model's largest) at any step.  The settings:
  - zero_moment: Adagrad(0.05) from a zero moment and Adam(1e-3, epsilon
    1e-8), the defaults;
  - phase16: Adagrad(0.05) from a moment of 0.1 and Adam(1e-3, epsilon
    1e-6), as phase 16 trains.
Runs in a few minutes on the CPU; imports nothing of JAX or paddle_tpu.
"""
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as fluid  # noqa: E402

SETTINGS = {
    "zero_moment": (dict(), dict(epsilon=1e-8)),
    "phase16": (dict(initial_accumulator_value=0.1), dict(epsilon=1e-6)),
}


def train(programs, states, feed, perturb, params, grads=None):
    """3 steps of each program on the CPU from `states`; the fc weights
    moved by one ulp with `perturb`.  Fills `grads` ({param: near-zero
    mask}) when given; returns every persistable."""
    exe = fluid.Executor(fluid.CPUPlace())
    rng = np.random.RandomState(5)
    scopes = []
    for (main, _, loss, _), state in zip(programs, states):
        state = dict(state)
        if perturb and not scopes:
            for n in params:
                if n.startswith("fc") and ".w_" in n:
                    ulp = 1 + 2.0 ** -23 * rng.choice([-1, 1], state[n].shape)
                    state[n] = (state[n] * ulp).astype(np.float32)
        scope = fluid.Scope()
        fluid.io.load_numpy_params(scope, state)
        for p in main.all_parameters() if scopes else ():
            scope.set_var(p.name, scopes[0].find_var(p.name))
        for _ in range(cs.PARITY_STEPS):
            out = exe.run(main, feed=feed, fetch_list=[loss] + [f"{p}@GRAD" for p in params],
                          scope=scope)
            if grads is not None:
                peak = max(float(np.abs(g).max()) for g in out[1:])
                for p, g in zip(params, out[1:]):
                    small = np.abs(g) <= cs.ZERO_GRAD * peak
                    grads[p] = grads[p] | small if p in grads else small
        scopes.append(scope)
    return {n: sc.to_numpy(n) for sc, st in zip(scopes, states) for n in st}


def measure(adagrad_kw, adam_kw):
    programs = [
        cs.build_deepfm(fluid, cs.DEEPFM_PARITY,
                        lambda: fluid.optimizer.Adagrad(cs.PARITY_LR["adagrad"], **adagrad_kw)),
        cs.build_deepfm(fluid, cs.DEEPFM_PARITY,
                        lambda: fluid.optimizer.Adam(cs.PARITY_LR["adam"], lazy_mode=True,
                                                     **adam_kw))]
    exe = fluid.Executor(fluid.CPUPlace())
    states = []
    for main, startup, _, _ in programs:
        init = fluid.Scope()
        exe.run(startup, scope=init)
        states.append({v.name: init.to_numpy(v.name) for v in main.list_vars() if v.persistable})
    feed = cs.deepfm_feed(cs.DEEPFM_PARITY_BATCH, cs.DEEPFM_PARITY, 2)
    params = [p.name for p in programs[1][0].all_parameters()]
    near_zero = {}
    base = train(programs, states, feed, False, params, near_zero)
    moved = train(programs, states, feed, True, params)
    shares = {}
    for name, want in base.items():
        err = np.abs(moved[name] - want)
        tol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
        held = err[~near_zero[name]] if name in near_zero else err
        shares[name] = (float(err.max()) / tol, float(held.max()) / tol if held.size else 0.0)
    return shares


def main():
    for setting, (adagrad_kw, adam_kw) in SETTINGS.items():
        shares = measure(adagrad_kw, adam_kw)
        worst = max(shares, key=lambda n: shares[n][1])
        print(json.dumps({"setting": setting, "adagrad": adagrad_kw, "adam": adam_kw,
                          "worst": worst, "share_all": shares[worst][0],
                          "share_held": shares[worst][1],
                          "shares_held": {n: s[1] for n, s in sorted(shares.items())}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

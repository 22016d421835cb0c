"""In-place update audit over the port's model zoo (the counterpart of
tools/donation_audit.py for paddle_tpu_torch).

The port's executor updates every read-and-written persistable (parameters,
optimizer accumulators, batch-norm running statistics) in the scope's own
tensor: an eager step writes the new value back under the same name, and a
CUDA-graph replay copies it into the tensor the graph captured
(core/executor.py `_Plan.written`, `_capture`).  A written persistable
whose value changes shape or dtype, or that the step never reads, cannot
be updated in place: each step allocates a second buffer for it.

Classification per written persistable (program order), the JAX tool's:

  donated            read + written, the new value's shape and dtype equal
                     the old one's -> updated in place
  copied_aval_drift  read + written, but the new value's shape or dtype
                     differs -> a fresh allocation every step
  copied_not_read    written but never read -> outside the in-place set
                     (steps>1 refuses these; steps=1 double-buffers)

Trainable parameters that are never written at all are `never_updated`
(the program's optimizer does not touch them).

The classes come from one eager step of the Executor on the CPU (the
values' shapes and dtypes before and after; the tiny zoo by default).  On
the card (`--card`), each `donated` persistable of a graphed plan must also
keep its storage (`data_ptr`) across a replay: the in-place contract a
CUDA-graph replay relies on.  A plan refused a graph (SelectedRows
gradients: DeepFM) runs eagerly and writes each new value as a new tensor;
its refusal is reported instead.

    python tools/port_donation_audit.py                 # report, tiny zoo
    python tools/port_donation_audit.py --check         # exit 1 on any drop
    python tools/port_donation_audit.py --program bert --json
    python tools/port_donation_audit.py --card --full   # on the card
"""
from __future__ import annotations

import argparse
import json
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


# --------------------------------------------------------------------------
# the zoo (program + startup + example feed + fetch names)
# --------------------------------------------------------------------------


def build_zoo(tiny: bool = True, only=None):
    """[(name, main, startup, feed {name: np.ndarray}, fetch_names)] over
    the port's own models, at the configurations tools/donation_audit.py
    build_zoo gives the JAX package's (`tiny`: CI size)."""
    out = []

    def want(n):
        return only is None or n == only

    if want("mnist"):
        from paddle_tpu_torch.models import mnist

        main, startup, feeds, fetches = mnist.build(learning_rate=1e-3)
        rng = np.random.RandomState(0)
        feed = {"img": rng.rand(4, 1, 28, 28).astype("f4"),
                "label": rng.randint(0, 10, (4, 1)).astype("i8")}
        out.append(("mnist", main, startup, feed, [fetches["loss"].name]))

    if want("resnet50"):
        from paddle_tpu_torch.models import resnet

        if tiny:
            main, startup, feeds, fetches = resnet.build(
                depth=50, class_dim=10, image_shape=(3, 32, 32),
                with_optimizer=True)
            img = np.random.RandomState(0).rand(2, 3, 32, 32).astype("f4")
        else:
            main, startup, feeds, fetches = resnet.build(
                dtype="bfloat16", class_dim=1000, with_optimizer=True,
                stem="space_to_depth")
            img = np.random.RandomState(0).rand(2, 3, 224, 224).astype("f4")
        feed = {"img": img,
                "label": np.zeros((img.shape[0], 1), "i8")}
        out.append(("resnet50", main, startup, feed, [fetches["loss"].name]))

    if want("bert"):
        from paddle_tpu_torch.models import transformer

        kw = (dict(vocab_size=200, seq_len=16, d_model=32, n_layers=2,
                   n_heads=2, d_ff=64) if tiny else
              dict(vocab_size=30522, seq_len=128, d_model=768, n_layers=12,
                   n_heads=12, d_ff=3072, dtype="bfloat16"))
        main, startup, feeds, fetches = transformer.build_bert(
            with_optimizer=True, **kw)
        b = transformer.make_fake_batch(2, kw["seq_len"], kw["vocab_size"],
                                        rng=np.random.RandomState(0))
        out.append(("bert", main, startup, dict(b), [fetches["loss"].name]))

    if want("nmt"):
        from paddle_tpu_torch.lod import lod_var_name
        from paddle_tpu_torch.models import nmt

        kw = (dict(src_vocab=80, tgt_vocab=80, d_model=32, n_layers=1,
                   n_heads=2, d_ff=64) if tiny else
              dict(src_vocab=8000, tgt_vocab=8000, d_model=512, n_layers=6,
                   n_heads=8, d_ff=2048))
        main, startup, feeds, fetches = nmt.build_transformer_nmt(
            dropout=0.1, learning_rate=2.0, **kw)
        rng = np.random.RandomState(0)
        b, T = 2, 12
        feed = {}
        for nm in ("src_word", "trg_word", "lbl_word"):
            feed[nm] = rng.randint(1, 80, (b, T, 1)).astype("i4")
            feed[lod_var_name(nm)] = np.full((b,), T, "i4")
        out.append(("nmt", main, startup, feed, [fetches["loss"].name]))

    if want("deepfm"):
        from paddle_tpu_torch.models import deepfm

        kw = (dict(num_fields=4, vocab_size=50, embed_dim=4,
                   mlp_dims=(8,)) if tiny else
              dict(num_fields=26, vocab_size=200000, embed_dim=16,
                   mlp_dims=(400, 400, 400)))
        main, startup, feeds, fetches = deepfm.build(learning_rate=0.05, **kw)
        rng = np.random.RandomState(0)
        nf = kw["num_fields"]
        feed = {"feat_ids": rng.randint(0, kw["vocab_size"], (4, nf)).astype("i4"),
                "label": (rng.rand(4, 1) < 0.3).astype("f4")}
        out.append(("deepfm", main, startup, feed, [fetches["loss"].name]))

    return out


# --------------------------------------------------------------------------
# the audit
# --------------------------------------------------------------------------


def _aval(v):
    return (tuple(v.shape), str(v.dtype).replace("torch.", ""))


def audit_program(main, startup, feed, fetch_names, place=None):
    """Audit one program's step; returns the classification dict.

    Takes the plan the Executor builds for (main, feed, fetches) and runs
    one eager step, comparing each written persistable's value after the
    step with its value before it; on the card (`place` a CUDAPlace) it
    then captures and replays the step's graph and records, under
    `storage_moved`, every donated persistable whose tensor the replay left
    at another address."""
    import paddle_tpu_torch as fluid

    place = place or fluid.CPUPlace()
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    before = {}
    for v in main.list_vars():
        t = scope.find_var(v.name) if v.persistable else None
        if t is not None and hasattr(t, "shape"):
            before[v.name] = _aval(t)
    exe.run(main, feed=feed, fetch_list=list(fetch_names), scope=scope)
    plan = exe.last_plan
    donated, drift, not_read = [], [], []
    for n in plan.written:
        if n not in plan.read_names:
            not_read.append(n)
            continue
        after = scope.find_var(n)
        same = (n in before and after is not None and hasattr(after, "shape")
                and _aval(after) == before[n])
        (donated if same else drift).append(n)

    written = set(plan.written)
    trainable = [p.name for p in main.all_parameters()
                 if getattr(p, "trainable", True)]
    has_optimizer = any(op.type == "backward"
                        for op in main.global_block().ops)
    never = [p for p in trainable if p not in written] if has_optimizer else []

    report = {
        "persistable_written": len(plan.written),
        "donated": len(donated),
        "copied_aval_drift": sorted(drift),
        "copied_not_read": sorted(not_read),
        "never_updated": sorted(never),
        "trainable_params": len(trainable),
        "read_only_state": len([n for n in plan.state_names if n not in written]),
    }
    if exe.place.device.type == "cuda":
        report["graph_refusal"] = plan.graph_refusal
        if plan.graphable:  # an eager plan writes new tensors each step, by design
            exe.run(main, feed=feed, fetch_list=list(fetch_names), scope=scope)  # captures
            ptrs = {n: scope.find_var(n).data_ptr() for n in donated}
            exe.run(main, feed=feed, fetch_list=list(fetch_names), scope=scope)  # replays
            report["graphed"] = exe.last_plan.graphed
            report["storage_moved"] = sorted(n for n in donated
                                             if scope.find_var(n).data_ptr() != ptrs[n])
    return report


def audit_zoo(tiny=True, only=None, place=None):
    """{model: report} over the zoo; each report gains `clean`."""
    reports = {}
    for name, main, startup, feed, fetches in build_zoo(tiny, only):
        r = audit_program(main, startup, feed, fetches, place=place)
        r["clean"] = not (r["copied_aval_drift"] or r["copied_not_read"]
                          or r["never_updated"] or r.get("storage_moved")
                          or r.get("graphed") is False)  # graphable, yet not captured
        reports[name] = r
    return reports


def render(reports) -> str:
    lines = ["# in-place update audit (a persistable not updated in place costs a "
             "second buffer and its traffic every step)"]
    for name, r in reports.items():
        verdict = "OK" if r["clean"] else "DROPS"
        card = (f", graphed {r['graphed']}, storage kept by "
                f"{r['donated'] - len(r['storage_moved'])}/{r['donated']}"
                if "storage_moved" in r else
                f", refused a graph ({r['graph_refusal']}): eager steps write new tensors"
                if r.get("graph_refusal") else "")
        lines.append(
            f"{name:10s} {verdict:6s} donated {r['donated']}/"
            f"{r['persistable_written']} written persistables, "
            f"{r['trainable_params']} trainable params, "
            f"{r['read_only_state']} read-only{card}")
        for k in ("copied_aval_drift", "copied_not_read", "never_updated", "storage_moved"):
            if r.get(k):
                lines.append(f"  {k}: {r[k][:8]}"
                             + (" ..." if len(r[k]) > 8 else ""))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless every zoo program updates every written "
                         "persistable in place")
    ap.add_argument("--full", action="store_true",
                    help="full-size model configs (default: CI-size tiny)")
    ap.add_argument("--card", action="store_true",
                    help="run on CUDAPlace(0) and hold each donated persistable's "
                         "storage across a graphed step")
    ap.add_argument("--program", default=None,
                    help="audit one zoo program (mnist|resnet50|bert|nmt|deepfm)")
    ap.add_argument("--json", action="store_true", help="machine output")
    args = ap.parse_args(argv)

    import paddle_tpu_torch as fluid

    place = fluid.CUDAPlace(0) if args.card else fluid.CPUPlace()
    if args.card:
        from paddle_tpu_torch import _build

        _build.ensure_built()
    reports = audit_zoo(tiny=not args.full, only=args.program, place=place)
    if args.json:
        print(json.dumps(reports))
    else:
        print(render(reports))
    if args.check:
        dirty = {n: r for n, r in reports.items() if not r["clean"]}
        if dirty:
            print(f"port_donation_audit --check: FAILED — updates not in place in "
                  f"{sorted(dirty)}", file=sys.stderr)
            return 1
        print(f"port_donation_audit --check: OK — every persistable update in "
              f"{sorted(reports)} is in place", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

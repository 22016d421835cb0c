#!/usr/bin/env python3
"""Time the row-wise kernels of an earlier tree of the port and of this one
against each other on one CUDA card, in turns, and count the instructions
of their loops.

    python3 tools/port_rowwise_ab.py --parent DIR [--kernels NAME ...] [--sass] [--out DIR]

DIR is an unpacked tree of an earlier commit (`git archive`).  The trees
run in turns, parent, this tree, this tree, parent, each in its own process
with its own kernel build.  The kernels (all three unless --kernels names
some):
  - bias_act_bwd: the bias+activation backward (`ck.bias_act_bwd`, gelu) at
    [4096, 3072] and [16384, 3072] bf16;
  - ln_residual_fwd: the LayerNorm+residual forward (`ck.fused_ln_residual`)
    at [4096, 768] and [16384, 768] bf16 with a residual, and at the serving
    batch-1 shape [128, 768];
  - softmax_xent_fwd: the softmax cross-entropy forward
    (`ck.softmax_xent_fwd`) at [4096, 30522] and [16384, 30522] bf16 with
    MLM labels (85% ignored, as chip_smoke's phase 3 draws them), at
    [4096, 30522] float32 with the same labels, at ResNet's [256, 1000]
    bf16 and float32 with every row labelled, and, to split its time, at
    [4096, 30522] bf16 with every row ignored and with every row labelled.
Each process first holds each wrapper's output against its plain version
(the bias-act backward by `ck.bias_act_bwd_allowed` where the tree has it,
else within 5e-2 * max|plain|; the forward within 5e-2; the cross-entropy's
loss and the labelled rows' lse within 2e-5), then times it with
chip_smoke.time_ms of this tree (CUDA events, median of 100, stream backed
up), records the device time of each kernel one call launches
(chip_smoke.launch_split, torch.profiler) at [4096, .], and the host time
of one call (`host_us`: the median and least of 21 rounds of 50 calls
enqueued behind a sleeping stream, so none waits for the device, over the
host clock). With `--sass`, each process also disassembles its tree's
kernel library (`cuobjdump -sass`) and prints, for each instantiation of
the timed kernels, the instructions of every loop (a backward branch and
its target) and the opcodes among them, and writes the whole listing under
--out.
Prints one JSON line per process run.  Imports nothing of JAX or
paddle_tpu.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r'''
import importlib.util, json, os, subprocess, sys, time, torch
spec = importlib.util.spec_from_file_location("smoke", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from paddle_tpu_torch import _build
from paddle_tpu_torch.ops import cuda_kernels as ck
rec = {"tree": TREE}
info = _build.build()
log = info["log"].splitlines()
rec["ptxas"] = [" | ".join(l.strip() for l in log[i:i + 4]) for i, l in enumerate(log)
                if "Compiling entry function" in l and any(k in l for k in KERNELS)]
if SASS:
    rec["sass_loops"] = cs_sass(info["path"])
def host_us(fn, n=50, rounds=21):
    """Host time of one call: the median over `rounds` of n calls enqueued
    behind a sleeping stream (the host shares its cores, so one round
    varies)."""
    for _ in range(10):
        fn()
    per = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        per.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    per.sort()
    return {"median": per[len(per) // 2], "min": per[0]}
gen = torch.Generator(device="cuda").manual_seed(0)
dt = torch.bfloat16
def rn(*shape, s=1.0, d=dt):
    return (torch.randn(*shape, generator=gen, device="cuda") * s).to(d)
for rows in (4096, 16384) if "bias_act_bwd" in KERNELS else ():
    x, g, b = rn(rows, 3072), rn(rows, 3072), rn(3072, s=0.1, d=torch.float32)
    got, want = ck.bias_act_bwd(x, b, g, "gelu"), ck.bias_act_bwd_plain(x, b, g, "gelu")
    if hasattr(ck, "bias_act_bwd_allowed"):
        share = max(float(((a.float() - w.float()).abs() / t).max())
                    for a, w, t in zip(got, want, ck.bias_act_bwd_allowed(x, b, g, "gelu", want)))
    else:
        share = max(float((a.float() - w.float()).abs().max()) / (5e-2 * float(w.float().abs().max()))
                    for a, w in zip(got, want))
    assert share <= 1.0, ("bias_act_bwd", rows, share)
    key = f"bias_act_bwd [{rows},3072] bf16 gelu"
    call = lambda: ck.bias_act_bwd(x, b, g, "gelu")
    rec[key] = {"ms": cs.time_ms(call), "worst_share": share}
    if rows == 4096:
        rec[key]["us_per_call"] = cs.launch_split(torch, call)
        rec[key]["host_us"] = host_us(call)
    del x, g, got, want
for rows in (4096, 16384, 128) if "ln_residual_fwd" in KERNELS else ():
    x, r = rn(rows, 768), rn(rows, 768)
    s, b = rn(768, s=0.2, d=torch.float32) + 1.0, rn(768, s=0.1, d=torch.float32)
    err = float((ck.fused_ln_residual(x, r, s, b, 1e-5).float()
                 - ck.ln_residual_plain(x, r, s, b, 1e-5).float()).abs().max())
    assert err <= 5e-2, ("ln_residual_fwd", rows, err)
    key = f"ln_residual_fwd [{rows},768] bf16 + residual"
    call = lambda: ck.fused_ln_residual(x, r, s, b, 1e-5)
    rec[key] = {"ms": cs.time_ms(call), "max_abs_err": err}
    if rows == 4096:
        rec[key]["us_per_call"] = cs.launch_split(torch, call)
    if rows in (4096, 128):
        rec[key]["host_us"] = host_us(call)
    del x, r
XENT = [  # (rows, V, dtype, labels)
    (4096, 30522, torch.bfloat16, "mlm"), (16384, 30522, torch.bfloat16, "mlm"),
    (4096, 30522, torch.float32, "mlm"), (256, 1000, torch.bfloat16, "all"),
    (256, 1000, torch.float32, "all"), (4096, 30522, torch.bfloat16, "none"),
    (4096, 30522, torch.bfloat16, "all")]
for rows, v, d, which in XENT if "softmax_xent_fwd" in KERNELS else ():
    x = rn(rows, v, s=2.0, d=d)
    lab = torch.randint(0, v, (rows,), generator=gen, device="cuda")
    if which != "all":
        masked = torch.rand(rows, generator=gen, device="cuda") < (0.85 if which == "mlm" else 2.0)
        lab = torch.where(masked, torch.full_like(lab, -100), lab)
    if which == "mlm":
        lab[0], lab[1], lab[2] = 0, v - 1, -100
    lab = lab.to(torch.int32)
    live = lab != -100
    (loss, lse), (loss_p, lse_p) = ck.softmax_xent_fwd(x, lab), ck.softmax_xent_fwd_plain(x, lab)
    err = max(float((loss - loss_p).abs().max()), float((lse - lse_p)[live].abs().max())
              if bool(live.any()) else 0.0)
    assert err <= 2e-5, ("softmax_xent_fwd", rows, v, which, err)
    key = f"softmax_xent_fwd [{rows},{v}] {str(d).split('.')[-1]} {int(live.sum())} rows labelled"
    call = lambda: ck.softmax_xent_fwd(x, lab)
    rec[key] = {"ms": cs.time_ms(call), "max_abs_err": err}
    if (rows, v, d, which) == XENT[0]:
        rec[key]["us_per_call"] = cs.launch_split(torch, call)
        rec[key]["host_us"] = host_us(call)
    del x, loss_p, lse_p
    torch.cuda.empty_cache()
print(json.dumps(rec))
'''

SASS_FN = r'''
import re
def cs_sass(lib):
    """Loops of the timed kernels' instantiations in `lib`: for each backward
    branch, the instructions from its target to it and their opcodes."""
    cuobj = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")  # beside nvcc
    text = subprocess.run([cuobj, "-sass", lib], capture_output=True, text=True).stdout
    out, keep = {}, []
    for block in text.split("Function : ")[1:]:
        name = block.splitlines()[0].strip()
        if not any(k in name for k in KERNELS):
            continue
        keep.append("Function : " + block)
        ins, labels, pending = [], {}, []
        for line in block.splitlines()[1:]:
            m = re.match(r"\s*(\.L_x_\d+):", line)
            if m:
                pending.append(m.group(1))
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if not m:
                continue
            addr = int(m.group(1), 16)
            for p in pending:
                labels[p] = addr
            pending = []
            ins.append((addr, m.group(2).strip()))
        loops = []
        for addr, text_ in ins:
            if " BRA " not in " " + text_.split(" ", 1)[-1] and not re.search(r"(^|\s)BRA\b", text_):
                continue
            m = re.search(r"`\((\.L_x_\d+)\)", text_) or re.search(r"BRA\s+(0x[0-9a-f]+)", text_)
            if not m:
                continue
            tgt = labels.get(m.group(1)) if m.group(1).startswith(".L") else int(m.group(1), 16)
            if tgt is None or tgt > addr:
                continue
            body = [t for a, t in ins if tgt <= a <= addr]
            ops = {}
            for t in body:
                op = t.split()[0]
                if op.startswith("@"):
                    op = t.split()[1]
                op = op.split(".")[0]
                ops[op] = ops.get(op, 0) + 1
            loops.append({"from": hex(tgt), "to": hex(addr), "instructions": len(body),
                          "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1]))})
        out[name] = {"instructions": len(ins), "loops": loops}
    if OUT:
        with open(os.path.join(OUT, "sass_" + os.path.basename(TREE.rstrip("/")) + ".txt"), "w") as f:
            f.write("".join(keep))
    return out
'''


KERNELS = ("bias_act_bwd", "ln_residual_fwd", "softmax_xent_fwd")


def run_tree(name, tree, sass, out, kernels=KERNELS):
    code = (f"ROOT = {ROOT!r}\nTREE = {name!r}\nSASS = {sass!r}\nOUT = {out!r}\n"
            f"KERNELS = {tuple(kernels)!r}\n"
            + RUN.replace("if SASS:", SASS_FN + "\nif SASS:"))
    run = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True, text=True,
                         timeout=900)
    lines = [line for line in run.stdout.splitlines() if line.startswith("{")]
    if run.returncode == 0 and lines:
        return json.loads(lines[-1])
    return {"tree": name, "error": run.stderr.strip()[-2000:]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="an unpacked tree of an earlier commit")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS),
                    help="the kernels to time (default: all)")
    ap.add_argument("--sass", action="store_true", help="count the loops' instructions")
    ap.add_argument("--out", default="", help="directory for the SASS listings")
    args = ap.parse_args()
    if args.out:  # absolute: each tree's process runs in its own directory
        args.out = os.path.abspath(args.out)
        os.makedirs(args.out, exist_ok=True)
    trees = {"parent": os.path.abspath(args.parent), "this": ROOT}
    ok = True
    for name in ("parent", "this", "this", "parent"):
        rec = run_tree(name, trees[name], args.sass, args.out, args.kernels)
        ok &= "error" not in rec
        print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""Op and fused-kernel micro-benchmarks of paddle_tpu_torch (the
port's counterpart of tools/opbench.py; reference role:
paddle/fluid/operators/benchmark/op_tester.cc).

  * variants are timed round-robin (A,B,A,B,...) so drift in the card's
    clocks or the host's load hits every variant equally;
  * each round times a window of `iters` dispatches ended by one
    `torch.cuda.synchronize()`; per-variant stats report best / median /
    spread over rounds (host wall time, launches included) and, on the
    card, `device_*_ms`: CUDA events around a window whose stream a sleep
    kernel backed up first, so the host enqueues the window before the
    device reaches it and the events see device time only.

Library use:

    from tools.port_opbench import interleave
    stats = interleave({"a": dispatch_a, "b": dispatch_b}, rounds=5)

CLI, one op through the port's program / Executor path:

    python tools/port_opbench.py --op relu --input X=256x1024 --grad
    python tools/port_opbench.py --op scale --input X=4x4 --attr scale=2.0 --cpu

Fused-kernel A/B: each entry of ops/cuda_kernels.py FUSED_KERNELS is
checked against its plain version at the registry tolerance, then timed
interleaved against the PyTorch composite PERF.md's kernel table names for
its row (`F.layer_norm(x+res)`, `addcmul` + `relu_`, `torch._fused_adam_`,
`F.cross_entropy`, `F.gelu(x+b)`), at the registry's example shapes:

    python tools/port_opbench.py --fused                     # all, on the card
    python tools/port_opbench.py --fused ln_residual --grad  # forward + backward
    python tools/port_opbench.py --fused --cpu               # parity only

On the CPU (`--cpu`, or no card) no kernel can run: `--fused` holds the
wrappers' plain forwards and explicit plain backwards against the plain
versions (and prints each composite's distance) and times nothing.  One JSON line per
(kernel, dtype), with `roofline_frac`: the registry's `analytic` (flops,
bytes) over the H100 chip model of core/resource_plan.py, divided by each
arm's time (forward arm only: the model prices one forward).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import zlib

if __name__ == "__main__":  # `python tools/port_opbench.py` from the repo root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from typing import Callable, Dict

import numpy as np

SLEEP_CYCLES = 50_000_000  # ~25 ms of device time at the H100's clocks
CYCLES_PER_S = 1.98e9  # the H100 SXM's boost clock: cycles of torch.cuda._sleep a second


# --------------------------------------------------------------------------
# core: interleaved A/B timing
# --------------------------------------------------------------------------

def _on_card(x) -> bool:
    import torch

    if isinstance(x, (list, tuple)):
        return any(_on_card(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    return False


def _sync(x):
    """Block until the dispatch's result is real: a card result waits for
    the device (`torch.cuda.synchronize()`), a host array is real."""
    if _on_card(x):
        import torch

        torch.cuda.synchronize()


def interleave(variants: Dict[str, Callable], rounds: int = 4, iters: int = 8,
               warmup: int = 2) -> Dict[str, dict]:
    """Time each zero-arg dispatch callable round-robin.

    Returns {name: {best_ms, median_ms, spread_pct, windows_ms}} where each
    window is (wall time of `iters` dispatches + one sync) / iters and
    spread_pct = (max-min)/median over windows; on the card also
    {device_best_ms, device_median_ms, device_windows_ms} from CUDA events
    around each window behind a backed-up stream, and device_backed_up:
    whether the device had not yet reached every window's start when the
    host had enqueued the window (else host gaps are in its time)."""
    order = list(variants.items())
    card = False
    for name, fn in order:  # build + warm every variant before timing any
        out = None
        for _ in range(warmup):
            out = fn()
        card = card or _on_card(out)
        _sync(out)
    windows: Dict[str, list] = {name: [] for name, _ in order}
    device: Dict[str, list] = {name: [] for name, _ in order}
    backed: Dict[str, list] = {name: [] for name, _ in order}
    for _ in range(rounds):
        for name, fn in order:
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn()
            _sync(out)
            windows[name].append((time.perf_counter() - t0) / iters)
            if card:
                import torch

                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                # back the stream up for four times the host's window, so the
                # device reaches `start` only once the window is enqueued
                wall = windows[name][-1] * iters
                torch.cuda._sleep(max(SLEEP_CYCLES, int(4 * wall * CYCLES_PER_S)))
                start.record()
                for _ in range(iters):
                    fn()
                end.record()
                backed[name].append(not start.query())
                torch.cuda.synchronize()
                device[name].append(start.elapsed_time(end) / iters)
    stats = {}
    for name, ws in windows.items():
        med = statistics.median(ws)
        stats[name] = {
            "best_ms": round(min(ws) * 1e3, 4),
            "median_ms": round(med * 1e3, 4),
            "spread_pct": round((max(ws) - min(ws)) / med * 100, 1),
            "windows_ms": [round(w * 1e3, 4) for w in ws],
        }
        if card:
            dv = device[name]
            stats[name].update({"device_best_ms": round(min(dv), 5),
                                "device_median_ms": round(statistics.median(dv), 5),
                                "device_windows_ms": [round(w, 5) for w in dv],
                                "device_backed_up": all(backed[name])})
    return stats


# --------------------------------------------------------------------------
# per-op timing through the program / Executor path
# --------------------------------------------------------------------------

def build_op_dispatch(op_type: str, inputs: Dict[str, np.ndarray],
                      attrs: dict | None = None, grad: bool = False,
                      place=None) -> Callable:
    """One-op program -> Executor dispatch closure (the card unless `place`
    says otherwise).

    With grad=True the op's (mean-reduced) first output is differentiated
    w.r.t. every floating input, so the window times forward + backward."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.program import Program, program_guard

    attrs = dict(attrs or {})
    prog, startup = Program(), Program()
    with program_guard(prog, startup):
        block = prog.global_block()
        in_io, feed = {}, {}
        for slot, arr in inputs.items():
            arr = np.asarray(arr)
            name = f"in_{slot}"
            block.create_var(name, shape=arr.shape, dtype=str(arr.dtype),
                             is_data=True)
            feed[name] = arr
            in_io[slot] = [name]
        fluid.core.registry.get_op_def(op_type)  # fail early on unknown op
        out_slots = _probe_output_slots(op_type)
        out_io = {}
        for slot in out_slots:
            v = block.create_var(f"out_{slot}")
            out_io[slot] = [v.name]
        block.append_op(op_type, inputs=in_io, outputs=out_io, attrs=attrs)
        fetch_name = out_io[out_slots[0]][0]
        if grad:
            loss = fluid.layers.mean(block.var(fetch_name))
            float_ins = [n for n, a in feed.items()
                         if np.issubdtype(a.dtype, np.floating)]
            grads = fluid.calc_gradient(loss, [block.var(n) for n in float_ins])
            fetch_list = [loss.name] + [g.name for g in grads if g is not None]
        else:
            fetch_list = [fetch_name]

    exe = fluid.Executor(place or fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)

    def dispatch():
        return exe.run(prog, feed=feed, fetch_list=fetch_list, scope=scope,
                       return_numpy=False)

    return dispatch


_KNOWN_OUT_SLOTS = {
    # ops whose primary output slot is not "Out"
    "conv2d": ["Output"], "conv3d": ["Output"], "conv2d_transpose": ["Output"],
    "batch_norm": ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"],
    "layer_norm": ["Y", "Mean", "Variance"],
    "softmax_with_cross_entropy": ["Loss", "Softmax"],
    "cross_entropy": ["Y"], "matmul": ["Out"], "mul": ["Out"],
    "pool2d": ["Out"], "pool3d": ["Out"], "dropout": ["Out", "Mask"],
    "lrn": ["Out", "MidOut"], "maxout": ["Out"],
    "hinge_loss": ["Loss"], "log_loss": ["Loss"], "rank_loss": ["Out"],
    "huber_loss": ["Out", "Residual"], "kldiv_loss": ["Loss"],
    "warpctc": ["Loss", "WarpCTCGrad"], "topk": ["Out", "Indices"],
    "linear_chain_crf": ["TransitionExps", "Alpha", "EmissionExps",
                         "LogLikelihood"],
}


def _probe_output_slots(op_type: str):
    return _KNOWN_OUT_SLOTS.get(op_type, ["Out"])


# --------------------------------------------------------------------------
# fused-kernel A/B (ops/cuda_kernels.py registry)
# --------------------------------------------------------------------------

def _composite(kernel, args):
    """(fn, name): the PyTorch composite PERF.md's kernel table names for
    `kernel`'s row, over copies of the example made once (weights in the
    input's dtype, as the library calls take them)."""
    import torch
    import torch.nn.functional as F

    if kernel == "ln_residual":
        x, res, scale, bias = args
        w, b = scale.to(x.dtype), bias.to(x.dtype)
        return ((lambda a: F.layer_norm(a[0] + a[1], (a[0].shape[-1],), w, b, 1e-5)),
                "F.layer_norm(x+res)")
    if kernel == "bn_scale_shift_relu":
        x, mul, add = args
        m, a_ = mul.to(x.dtype)[None, :, None], add.to(x.dtype)[None, :, None]
        return (lambda a: torch.addcmul(a_, a[0], m).relu()), "torch.addcmul(add, x, mul).relu()"
    if kernel == "adam_slab":
        p, g, m, v = args
        state = [t.to(p.dtype).clone() for t in (p, g, m, v)]
        step = torch.zeros((), device=p.device)

        def adam(_a):
            torch._fused_adam_([state[0]], [state[1]], [state[2]], [state[3]], [], [step],
                               lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8,
                               amsgrad=False, maximize=False)
            return state[0]
        return adam, "torch._fused_adam_ on one tensor (p, g, m, v in p's dtype)"
    if kernel == "softmax_xent":
        logits, labels = args
        lab = labels.long()
        return ((lambda a: F.cross_entropy(a[0], lab, reduction="none", ignore_index=-100)),
                "F.cross_entropy(reduction='none', ignore_index=-100)")
    if kernel == "bias_act":
        x, b = args
        bx = b.to(x.dtype)
        return (lambda a: F.gelu(a[0] + bx)), "F.gelu(x+b)"
    raise KeyError(kernel)


def _leaves(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _grad_fn(fn, args, argnums):
    """fn(args) -> the gradients of sum(out**2) w.r.t. args[argnums], those
    the function reads (a composite's weights are copies in x's dtype)."""
    import torch

    def run():
        live = list(args)
        for i in argnums:
            live[i] = args[i].detach().requires_grad_(True)
        loss = sum((leaf.float() ** 2).sum() for leaf in _leaves(fn(live)))
        grads = torch.autograd.grad(loss, [live[i] for i in argnums], allow_unused=True)
        return [g for g in grads if g is not None]
    return run


def build_fused_dispatches(kernel: str, dtype: str = "float32", grad: bool = False,
                           device: str = "cuda"):
    """(dispatches, tol, composite name, parity error, composite's error)
    for one registry entry: `kernel` (the port's kernel wrapper; its plain
    version on the CPU) and `library` (the PyTorch composite), over the
    registry's example on `device`.  The wrapper's output is first held
    against the plain version's at the registry tolerance (the backward
    arms scale it by 1 + max|plain|, the JAX tool's bound), raising when
    they part.  With grad=True both arms differentiate sum(out**2) over
    grad_argnums."""
    import torch

    from paddle_tpu_torch.ops.cuda_kernels import FUSED_KERNELS

    spec = FUSED_KERNELS[kernel]
    tdtype = getattr(torch, dtype)
    args = spec["example"](tdtype, device=device)
    tol = spec["tol"][dtype]
    library, library_name = _composite(kernel, args)
    if grad:
        if not spec["grad_argnums"]:
            raise ValueError(f"--grad: fused kernel {kernel!r} is a state "
                             f"update, not a differentiable layer")
        argnums = tuple(i for i in spec["grad_argnums"] if args[i] is not None)
        fused = _grad_fn(spec["fused"], args, argnums)
        plain = _grad_fn(spec["reference"], args, argnums)
        lib = _grad_fn(library, args, argnums)
    else:
        def fresh():  # the in-place Adam kernel updates its own copies
            return [a.clone() if a is not None else None for a in args]

        fused = ((lambda: spec["fused"](fresh())) if kernel == "adam_slab"
                 else (lambda: spec["fused"](args)))
        plain = lambda: spec["reference"](args)  # noqa: E731
        lib = lambda: library(args)  # noqa: E731

    def held(got_fn, want_fn, what, gate=True):
        worst = 0.0
        for got, want in zip(_leaves(got_fn()), _leaves(want_fn())):
            got, want = got.float().reshape(-1), want.float().reshape(-1)
            err = float((got - want).abs().max()) if got.numel() else 0.0
            scale = 1.0 + (float(want.abs().max()) if grad and want.numel() else 0.0)
            if gate and err > tol * scale:
                raise AssertionError(
                    f"fused kernel {kernel!r} ({dtype}, grad={grad}): {what} parted from the "
                    f"plain version: max|d|={err:.3e} > tol={tol:.0e}*{scale:.1f}")
            worst = max(worst, err / scale)
        return worst

    # on the CPU the wrapper takes the plain forward and its explicit plain
    # backward, which the second arm holds against autograd of the plain
    # forward; the composite's distance is printed, not held (its bf16
    # products round where the kernel's do not)
    err = held(fused, plain, "the kernel" if device != "cpu" else "the plain version")
    library_err = (None if kernel == "adam_slab"  # its own bias correction, m and v in p's dtype
                   else held(lib, plain, "the composite", gate=False))
    if kernel == "adam_slab":  # time in place, as the executor runs it
        fused = lambda: spec["fused"](args)  # noqa: E731
    return {"kernel": fused, "library": lib}, tol, library_name, err, library_err


def run_fused_ab(kernels=None, dtypes=("float32",), grad=False, rounds=4, iters=8,
                 cpu=False):
    """[{kernel, dtype, grad, parity_tol, parity_err, kernel: stats,
    library: stats, speedup, roofline_ms, roofline_frac}] — one interleaved
    A/B per (kernel, dtype); on the CPU the parity alone."""
    from paddle_tpu_torch.ops.cuda_kernels import FUSED_KERNELS, registered_fused_kernels

    recs = []
    for kernel in (kernels or registered_fused_kernels()):
        if grad and not FUSED_KERNELS[kernel]["grad_argnums"]:
            print(f"port_opbench --fused: skipping {kernel!r} under --grad "
                  f"(state update, not a differentiable layer)", file=sys.stderr)
            continue
        for dtype in dtypes:
            dispatches, tol, library, err, library_err = build_fused_dispatches(
                kernel, dtype, grad=grad, device="cpu" if cpu else "cuda")
            rec = {"kernel": kernel, "dtype": dtype, "grad": grad, "cpu": cpu,
                   "parity_tol": tol, "parity_err": err, "library": library,
                   "library_err": library_err}
            if not cpu:
                stats = interleave(dispatches, rounds=rounds, iters=iters)
                rec.update({"kernel_stats": stats["kernel"], "library_stats": stats["library"],
                            "speedup": round(stats["library"]["device_best_ms"]
                                             / stats["kernel"]["device_best_ms"], 4)})
                rec.update(_roofline_frac(kernel, dtype, grad, stats))
            recs.append(rec)
    return recs


def _roofline_frac(kernel, dtype, grad, stats):
    """roofline_ms + per-arm roofline_frac from the registry's analytic
    (flops, bytes) at the example shapes over core/resource_plan.py's chip
    model: the roofline time divided by each arm's best device window.
    Forward arm only: the analytic model prices one forward."""
    import torch

    from paddle_tpu_torch.core.resource_plan import CHIP_HBM_BANDWIDTH, CHIP_PEAK_FLOPS
    from paddle_tpu_torch.ops.cuda_kernels import FUSED_KERNELS

    ana = FUSED_KERNELS[kernel].get("analytic")
    if ana is None or grad:
        return {}
    flops, bts = ana(FUSED_KERNELS[kernel]["example"](getattr(torch, dtype)))
    t_ms = max(flops / CHIP_PEAK_FLOPS, bts / CHIP_HBM_BANDWIDTH) * 1e3
    out = {"roofline_ms": round(t_ms, 6), "roofline_frac": {}}
    for arm in ("kernel", "library"):
        best = stats[arm]["device_best_ms"]
        out["roofline_frac"][arm] = round(t_ms / best, 4) if best else None
    return out


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def _parse_input(spec: str):
    """X=64x3x224x224[:float32] -> (slot, random ndarray)."""
    slot, shape = spec.split("=", 1)
    dtype = "float32"
    if ":" in shape:
        shape, dtype = shape.rsplit(":", 1)
    dims = tuple(int(d) for d in shape.split("x"))
    rng = np.random.RandomState(zlib.crc32(slot.encode()) % (2**31))
    if np.issubdtype(np.dtype(dtype), np.integer):
        arr = rng.randint(0, 10, dims).astype(dtype)
    else:
        arr = rng.rand(*dims).astype(dtype)
    return slot, arr


def _parse_attr(spec: str):
    """k=v with v parsed as bool/int/float/int-list/str."""
    k, v = spec.split("=", 1)
    if v in ("true", "True"):
        return k, True
    if v in ("false", "False"):
        return k, False
    if "," in v:
        parts = v.split(",")
        try:
            return k, [int(x) for x in parts]
        except ValueError:
            try:
                return k, [float(x) for x in parts]
            except ValueError:
                return k, v
    try:
        return k, int(v)
    except ValueError:
        pass
    try:
        return k, float(v)
    except ValueError:
        return k, v


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--op", default=None, help="registered op type")
    p.add_argument("--input", action="append", default=[],
                   metavar="SLOT=DIMxDIM[:dtype]")
    p.add_argument("--attr", action="append", default=[], metavar="K=V")
    p.add_argument("--grad", action="store_true",
                   help="time forward + backward (the gradient of the output's mean)")
    p.add_argument("--cpu", action="store_true", help="run on CPUPlace")
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--fused", nargs="?", const="all", default=None,
                   metavar="KERNEL",
                   help="interleaved kernel-vs-composite A/B over the fused-kernel "
                        "registry (ops/cuda_kernels.py); optional KERNEL narrows to "
                        "one.  One JSON line per (kernel, dtype) after a parity "
                        "check at the registry tolerance")
    p.add_argument("--dtype", default="float32,bfloat16",
                   help="--fused dtypes (comma-separated)")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="--fused: also write the JSON lines to PATH")
    args = p.parse_args(argv)

    if args.fused:
        import torch

        from paddle_tpu_torch.ops.cuda_kernels import registered_fused_kernels

        cpu = args.cpu or not torch.cuda.is_available()
        if cpu and not args.cpu:
            print("port_opbench --fused: no CUDA device; checking the plain versions "
                  "only (no kernel runs on the CPU)", file=sys.stderr)
        if not cpu:
            from paddle_tpu_torch import _build

            _build.ensure_built()
        kernels = (registered_fused_kernels() if args.fused == "all"
                   else [args.fused])
        recs = run_fused_ab(kernels, dtypes=args.dtype.split(","), grad=args.grad,
                            rounds=args.rounds, iters=args.iters, cpu=cpu)
        lines = [json.dumps(rec) for rec in recs]
        print("\n".join(lines))
        if args.out:
            with open(args.out, "a") as f:
                f.write("\n".join(lines) + "\n")
        return 0
    if not args.op:
        p.error("--op is required unless --fused is given")

    import paddle_tpu_torch as fluid

    inputs = dict(_parse_input(s) for s in args.input)
    attrs = dict(_parse_attr(s) for s in args.attr)
    place = fluid.CPUPlace() if args.cpu else fluid.CUDAPlace(0)
    dispatch = build_op_dispatch(args.op, inputs, attrs, grad=args.grad,
                                 place=place)
    stats = interleave({args.op: dispatch}, rounds=args.rounds,
                       iters=args.iters)
    rec = {"op": args.op, "grad": args.grad,
           "inputs": {k: list(v.shape) for k, v in inputs.items()},
           "attrs": attrs, **stats[args.op]}
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())

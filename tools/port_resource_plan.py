#!/usr/bin/env python
"""Render / gate the static resource plans of paddle_tpu_torch
(core/resource_plan.py; the port's counterpart of tools/resource_plan.py).

    python tools/port_resource_plan.py
        Plan every program of the port's zoo (mnist, resnet50, bert, nmt,
        deepfm: tools/port_donation_audit.py build_zoo) at CI-size configs
        (`--full`: full width): peak device memory with the watermark ops
        at the peak, the FLOPs / bytes roll-up, the roofline step time on
        the H100 chip model, and the predicted MFU.

    python tools/port_resource_plan.py --smoke
        Plan chip_smoke.py's training programs (phases 10, 12, 13, 15, 17)
        at the feed shapes those phases run: the peaks the executor's
        pre-check holds against the card's memory.  Card-free.

    python tools/port_resource_plan.py --check [--min-coverage F]
        Gate: exit 1 when any zoo program fails to plan or the cost-rule
        coverage over the zoo drops below the floor (1.0, the JAX tool's;
        with --calibrate, also when a plan leaves the calibration band).

    python tools/port_resource_plan.py --calibrate
        On the card: the plan's peak against the allocator's, measured as
        `torch.cuda.max_memory_allocated()` over one eager step above what
        was allocated before the program's startup ran (its parameters,
        state and feeds included, as the plan counts them), held to the JAX
        tool's band [CALIBRATION_RATIO_LO, CALIBRATION_RATIO_HI].

Exit codes: 0 clean, 1 gate failure.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

# Cost-rule coverage floor over the zoo's op types (the JAX tool's: 1.0).
COST_COVERAGE_FLOOR = 1.0

# Calibration band of plan peak / measured peak (the JAX tool's; never
# widened: a program outside it is a finding).
CALIBRATION_RATIO_LO = 0.6
CALIBRATION_RATIO_HI = 2.0


def _fmt_table(rows, headers):
    widths = [max(len(str(r[i])) for r in rows + [headers])
              for i in range(len(headers))]
    out = ["  ".join(str(h).ljust(w) for h, w in zip(headers, widths))]
    for r in rows:
        out.append("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))
    return "\n".join(out)


def zoo_plans(tiny=True, only=None):
    """[(name, program, plan, (startup, feed, fetches))] over the port's zoo
    (main programs at their example feed shapes, as the Executor stages
    them)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import resource_plan as rp
    from tools.port_donation_audit import build_zoo

    exe = fluid.Executor(fluid.CPUPlace())
    out = []
    for name, main, startup, feed, fetches in build_zoo(tiny=tiny, only=only):
        shapes = {n: tuple(t.shape) for n, t in exe._feeds(main.global_block(), feed, 1).items()}
        plan = rp.plan_program(main, shapes, fetches)
        out.append((name, main, plan, (startup, feed, fetches)))
    return out


def smoke_plans(only=None):
    """The same over chip_smoke.py's COST_PROGRAMS (full width, the phases'
    own feeds)."""
    import paddle_tpu_torch as fluid

    sys.path.insert(0, ROOT)
    import chip_smoke

    plans = chip_smoke.plan_cost_programs(fluid)
    return [(name, e["main"], e["plan"], (None, e["feed"], e["fetches"]))
            for name, e in plans.items() if only is None or name == only]


def measured_peak_bytes(main, startup, feed, fetches):
    """The allocator's peak over one eager step of `main` on the card above
    what was allocated before its startup ran: (bytes, how)."""
    import gc

    import torch

    import paddle_tpu_torch as fluid

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    exe = fluid.Executor(fluid.CUDAPlace(0), _graphs=False)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    exe.run(main, feed=feed, fetch_list=list(fetches), scope=scope, return_numpy=False)
    torch.cuda.synchronize()
    high = torch.cuda.max_memory_allocated()
    del exe, scope
    gc.collect()
    return int(high - base), "max_memory_allocated above the start"


def render(tiny=True, only=None, calibrate=False, smoke=False):
    """(text, results) — results: {name: {plan..., ratio?...}}."""
    from paddle_tpu_torch.core import resource_plan as rp

    plans = smoke_plans(only) if smoke else zoo_plans(tiny=tiny, only=only)
    rows = []
    results = {}
    for name, _, plan, _ in plans:
        rows.append((name, f"{plan.peak_bytes / 1e6:.2f}",
                     f"{plan.persistable_bytes / 1e6:.2f}",
                     f"{plan.feed_bytes / 1e6:.2f}",
                     f"{plan.peak_temp_bytes / 1e6:.2f}",
                     f"#{plan.peak_op_idx}({plan.peak_op_type})",
                     f"{plan.flops_total:.4g}",
                     f"{plan.roofline_step_s * 1e3:.3f}",
                     f"{plan.predicted_mfu:.3f}"))
        results[name] = {"plan": plan.to_dict()}
    what = "chip_smoke programs" if smoke else f"zoo, {'tiny' if tiny else 'full'} configs"
    parts = [f"# resource plans  ({what}; chip model {rp.CHIP_PEAK_FLOPS:.4g} FLOP/s, "
             f"{rp.CHIP_HBM_BANDWIDTH:.4g} B/s, {rp.CHIP_HBM_BYTES:.4g} B)",
             "", _fmt_table(rows, ["program", "peak_MB", "persistable_MB",
                                   "feed_MB", "live_temp_MB", "peak_op", "flops",
                                   "roofline_ms", "pred_MFU"])]
    parts.append("\n## peak attribution (watermark ops)")
    for name, _, plan, _ in plans:
        parts.append(f"- {name}: " + "; ".join(plan.watermark_ops()[:4]))
    cov = rp.cost_coverage([p for _, p, _, _ in plans])
    parts.append(f"\n## cost-rule coverage\nop types covered: "
                 f"{len(cov['covered_types'])} / "
                 f"{len(cov['covered_types']) + len(cov['missing_types'])} "
                 f"(frac {cov['frac']:.3f})")
    if cov["missing_types"]:
        parts.append("missing cost rules (default 1-flop/elem model used): "
                     + ", ".join(cov["missing_types"]))
    results["_coverage"] = cov
    if calibrate:
        parts.append("\n## calibration (plan peak vs measured, on the card)")
        crows = []
        for name, main, plan, (startup, feed, fetches) in plans:
            measured, how = measured_peak_bytes(main, startup, feed, fetches)
            ratio = plan.peak_bytes / measured if measured else float("inf")
            ok = CALIBRATION_RATIO_LO <= ratio <= CALIBRATION_RATIO_HI
            crows.append((name, f"{plan.peak_bytes / 1e6:.2f}",
                          f"{measured / 1e6:.2f}", f"{ratio:.3f}",
                          how, "OK" if ok else "DRIFT"))
            results[name]["measured_bytes"] = measured
            results[name]["ratio"] = ratio
            results[name]["calibration_ok"] = ok
        parts.append(_fmt_table(crows, ["program", "plan_MB", "measured_MB",
                                        "ratio", "truth", "verdict"]))
        parts.append(f"tolerance band: [{CALIBRATION_RATIO_LO}, "
                     f"{CALIBRATION_RATIO_HI}]")
    return "\n".join(parts), results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--check", action="store_true",
                    help="gate: plans build, coverage >= floor (and with "
                         "--calibrate: calibration inside the band)")
    ap.add_argument("--calibrate", action="store_true",
                    help="compare plan peaks against the allocator on the card")
    ap.add_argument("--full", action="store_true",
                    help="full-size model configs (default: CI-size tiny)")
    ap.add_argument("--smoke", action="store_true",
                    help="plan chip_smoke.py's training programs at their feeds")
    ap.add_argument("--program", default=None,
                    help="plan one program (mnist|resnet50|bert|nmt|deepfm; with "
                         "--smoke a name of chip_smoke.COST_PROGRAMS)")
    ap.add_argument("--min-coverage", type=float, default=COST_COVERAGE_FLOOR,
                    help=f"cost-rule coverage floor for --check "
                         f"(default {COST_COVERAGE_FLOOR})")
    ap.add_argument("--json", action="store_true", help="machine output")
    args = ap.parse_args(argv)

    if args.calibrate:
        if args.smoke:
            ap.error("--calibrate runs the zoo's programs; chip_smoke measures its own")
        from paddle_tpu_torch import _build

        _build.ensure_built()
    try:
        text, results = render(tiny=not args.full, only=args.program,
                               calibrate=args.calibrate, smoke=args.smoke)
    except Exception as e:
        print(f"port_resource_plan: planning FAILED: {type(e).__name__}: {e}")
        return 1
    if args.json:
        print(json.dumps(results, default=str))
    else:
        print(text)

    if args.check:
        failed = False
        cov = results["_coverage"]
        programs = [k for k in results if not k.startswith("_")]
        if not programs:
            print("\nCHECK FAILED: zero programs planned")
            failed = True
        if cov["frac"] < args.min_coverage:
            print(f"\nCHECK FAILED: cost-rule coverage {cov['frac']:.3f} < "
                  f"floor {args.min_coverage} (missing: "
                  f"{cov['missing_types']})")
            failed = True
        for name in programs:
            r = results[name]
            if "calibration_ok" in r and not r["calibration_ok"]:
                print(f"\nCHECK FAILED: {name} plan/measured ratio "
                      f"{r['ratio']:.3f} outside "
                      f"[{CALIBRATION_RATIO_LO}, {CALIBRATION_RATIO_HI}]")
                failed = True
        if failed:
            return 1
        print(f"\nCHECK OK: {len(programs)} plans clean, coverage {cov['frac']:.3f} >= "
              f"{args.min_coverage}"
              + (f", calibration inside [{CALIBRATION_RATIO_LO}, {CALIBRATION_RATIO_HI}]"
                 if args.calibrate else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())

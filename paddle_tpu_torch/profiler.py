"""The Fluid profiler's surface over the port's monitor (counterpart of
paddle_tpu/profiler.py; reference python/paddle/fluid/profiler.py).

start / stop toggle the monitor, the aggregate table renders its span
stats, and the Chrome trace of the host spans goes through the monitor's
exporter.  The JAX package's `trace_dir` device trace (jax.profiler) is a
torch.profiler session with CUDA activity here: `stop_profiler` writes its
Chrome trace, with the monitor's spans as a lane of their own, to
`<trace_dir>/trace.json`, and raises when the session recorded no device
activity (no card, or no CUPTI) instead of writing a host-only trace.
`profile_program` times each op of the interpreter alone, synchronizing the
card after each.  `cuda_profiler` brackets a region with
torch.cuda.profiler.start / stop (the reference's nvprof hooks) on the card.

    with fluid.profiler.profiler(state="All", trace_dir="prof"):
        exe.run(main, feed=..., fetch_list=[loss])
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Optional

import torch

from .monitor import MONITOR as _MON

TRACE_FILE = "trace.json"

_trace_dir: Optional[str] = None
_device_prof = None  # the torch.profiler session of a trace_dir profile
_owns_enable = False  # did start_profiler() turn the monitor on?


def is_profiler_enabled() -> bool:
    return _MON.enabled


def record_run(tag: str, seconds: float):
    _MON.observe(tag, seconds)


def reset_profiler():
    _MON.reset()


def start_profiler(state: str = "All", tracer_option: Optional[str] = None,
                   trace_dir: Optional[str] = None):
    """state: CPU | GPU | All (kept for parity; the device trace needs
    trace_dir)."""
    global _trace_dir, _owns_enable, _device_prof
    _owns_enable = not _MON.enabled
    _MON.enable()
    _trace_dir = trace_dir
    if trace_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        _device_prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        _device_prof.__enter__()


def _stop_device_trace(trace_dir: str) -> str:
    """End the torch.profiler session and write its Chrome trace, the
    monitor's events added as one more process lane; raise if the session
    holds no device activity."""
    global _device_prof
    prof, _device_prof = _device_prof, None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    cuda = torch.autograd.DeviceType.CUDA
    if not any(e.device_type == cuda for e in prof.events()):
        raise RuntimeError(
            "profiler: the device trace recorded no CUDA activity (no card, or CUPTI "
            "gave no device records); no trace was written to " + repr(trace_dir))
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    from .monitor.exporters import chrome_trace_events

    # torch's trace times are microseconds since baseTimeNanoseconds where
    # the document names one, else since the epoch, as the monitor's
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    pid = "paddle_tpu_torch.monitor"
    for ev in chrome_trace_events(_MON, pid=pid, process_name=pid):
        if "ts" in ev:
            ev["ts"] -= base_us
        doc.setdefault("traceEvents", []).append(ev)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def stop_profiler(sorted_key: str = "total", profile_path: Optional[str] = None):
    global _trace_dir, _owns_enable
    # only turn the monitor off if start_profiler turned it on: a profiled
    # section inside an always-on monitor must not end its records
    if _owns_enable:
        _MON.disable()
    _owns_enable = False
    if _trace_dir is not None:
        trace_dir, _trace_dir = _trace_dir, None
        _stop_device_trace(trace_dir)
    table = summary(sorted_key)
    if profile_path:
        with open(profile_path, "w") as f:
            f.write(table)
    else:
        print(table)
    return table


def summary(sorted_key: str = "total") -> str:
    from .monitor.exporters import summary_table

    return summary_table(_MON, sorted_key)


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: str = "total", profile_path: Optional[str] = None,
             trace_dir: Optional[str] = None):
    """reference: fluid.profiler.profiler context manager (profiler.py:222)."""
    start_profiler(state, trace_dir=trace_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


def record_event(name: str, ts: float, seconds: float):
    # `ts` is ignored, as in the JAX package: observe() stamps epoch time
    # itself, which the monitor's other spans use
    _MON.observe(name, seconds)


def _scope_env(scope):
    env, s = {}, scope
    while s is not None:
        for name in s.local_var_names():
            env.setdefault(name, s.find_var(name))
        s = s.parent
    return env


def profile_program(program, feed, fetch_list=None, scope=None, place=None, repeat: int = 1):
    """Per-op time attribution (reference: the per-op table the C++
    profiler printed from RecordEvent around every `op->Run`): each op of
    the global block runs alone through the interpreter, followed by a
    `torch.cuda.synchronize()` on the card, `repeat` times.  Ops whose
    inputs do not exist without a backward pass (gradients) are left out.
    Returns the table, and records one monitor event an op."""
    from .core.executor import CUDAPlace, Executor, _runnable_ops
    from .core.lowering import LoweringContext, lower_one
    from .core.scope import global_scope

    scope = scope if scope is not None else global_scope()
    place = place if place is not None else CUDAPlace(0)
    block = program.global_block()
    ops = [o for o in _runnable_ops(block) if o.type != "backward"]
    env = _scope_env(scope)
    env.update(Executor(place)._feeds(block, feed or {}, 1))
    on_card = place.device.type == "cuda"
    per_op = defaultdict(lambda: {"calls": 0, "total_s": 0.0})
    ctx = LoweringContext(torch.Generator(device=place.device).manual_seed(0), place.device)
    with torch.no_grad():
        for _ in range(repeat):
            for op in ops:
                if any(n not in env for n in op.input_arg_names):
                    continue
                t0 = time.perf_counter()
                lower_one(ctx, op, env)
                if on_card:
                    torch.cuda.synchronize(place.device)
                dt = time.perf_counter() - t0
                per_op[op.type]["calls"] += 1
                per_op[op.type]["total_s"] += dt
                record_event(op.type, t0, dt)

    lines = [f"{'Op':<28} {'Calls':>8} {'Total(ms)':>12} {'Avg(ms)':>10}"]
    for t, r in sorted(per_op.items(), key=lambda kv: -kv[1]["total_s"]):
        lines.append(f"{t:<28} {r['calls']:>8} {r['total_s']*1e3:>12.3f} "
                     f"{r['total_s']/r['calls']*1e3:>10.3f}")
    return "\n".join(lines)


def export_chrome_trace(path: str, pid: int = 0, process_name: str = "paddle_tpu"):
    """Write the monitor's recorded events as Chrome trace JSON
    (chrome://tracing / perfetto)."""
    from .monitor.exporters import export_chrome_trace as _export

    return _export(_MON, path, pid=pid, process_name=process_name)


def merge_chrome_traces(named_paths, out_path):
    """Merge several processes' traces into one timeline, one pid lane each."""
    from .monitor.exporters import merge_chrome_traces as _merge

    return _merge(named_paths, out_path)


@contextlib.contextmanager
def cuda_profiler(output_file, output_mode=None, config=None):
    """reference profiler.cuda_profiler (nvprof hooks): on the card the region
    runs between torch.cuda.profiler.start() and stop(), which an external
    CUDA profiler attached to the process records; without a card it is a
    no-op, as in the JAX package."""
    if not torch.cuda.is_available():
        yield
        return
    torch.cuda.synchronize()
    torch.cuda.profiler.start()
    try:
        yield
    finally:
        torch.cuda.synchronize()
        torch.cuda.profiler.stop()

"""paddle_tpu_torch.monitor: the port's observability (counterpart of
paddle_tpu/monitor).

    from paddle_tpu_torch import monitor

    monitor.enable()
    with monitor.span("compile", program=uuid):      # nested, thread-safe
        ...
    monitor.counter("executor.cache_miss").inc()

    print(monitor.export_prometheus())               # text exposition
    monitor.export_json("snapshot.json")
    monitor.export_chrome_trace("trace.json")        # chrome://tracing
    log = monitor.attach_logger(monitor.MonitorLogger("metrics.jsonl"))
    monitor.arm_flight_recorder("BLACKBOX.p0.json")  # dumped on a drain

Disabled (the default) every entry point is a branch.  The executor
reports `executor.cache_hit` / `executor.cache_miss` (plan cache),
`executor.graph_capture` / `executor.graph_replay` / `executor.graph_refused`
(CUDA graphs), the spans `executor.dispatch` and `executor.fetch`, and one
kind="step" record a run; `pipeline.train_loop` the `pipeline.inflight`
gauge, the `pipeline.host_blocked` span and kind="pipeline_step" records;
memstats the lazy `memory.*` gauges.  `paddle_tpu_torch.profiler` is the
Fluid profiler's surface over this module.  The serving runtime records
its request traces (`record_trace`, `request_traces`) and the exemplars of
slow or bad requests (`record_exemplar`, `exemplars`) here.
"""
from __future__ import annotations

import time

from . import exporters as _exp
from .core import (EXEMPLAR_CAP, FLIGHT_RECORDER_CAP, NULL_SPAN, TRACE_RING_CAP,  # noqa: F401
                   Counter, Gauge, Monitor, Span)
from .exporters import (MonitorLogger, escape_label_value, prometheus_text,  # noqa: F401
                        summary_table)
from .memstats import register_memory_gauges

__all__ = ["Counter", "Gauge", "Monitor", "MonitorLogger", "Span", "NULL_SPAN",
           "FLIGHT_RECORDER_CAP", "TRACE_RING_CAP", "EXEMPLAR_CAP", "MONITOR", "get_monitor", "enable", "disable", "is_enabled",
           "reset", "span", "observe", "counter", "gauge", "record_step", "step_records",
           "record_fleet_event", "record_trace", "request_traces", "record_exemplar", "exemplars",
           "set_lane", "attach_logger", "detach_logger", "export_prometheus", "export_json",
           "json_snapshot", "export_chrome_trace", "merge_chrome_traces", "summary",
           "prometheus_text", "escape_label_value", "arm_flight_recorder", "dump_blackbox",
           "blackbox_snapshot", "init_worker_telemetry", "telemetry_dir",
           "register_memory_gauges"]

MONITOR = Monitor()
register_memory_gauges(MONITOR)


def get_monitor() -> Monitor:
    return MONITOR


def enable():
    return MONITOR.enable()


def disable():
    return MONITOR.disable()


def is_enabled() -> bool:
    return MONITOR.enabled


def reset():
    return MONITOR.reset()


def span(name: str, **args):
    return MONITOR.span(name, **args)


def observe(name: str, seconds: float, **args):
    return MONITOR.observe(name, seconds, **args)


def counter(name: str) -> Counter:
    return MONITOR.counter(name)


def gauge(name: str) -> Gauge:
    return MONITOR.gauge(name)


def record_step(record: dict):
    return MONITOR.record_step(record)


def step_records():
    return MONITOR.step_records()


def record_fleet_event(action: str, **fields):
    """One serving-fleet lifecycle transition (replica_dead /
    replica_restarted / roll_started / roll_halted / roll_converged / ...)
    as a `kind="fleet_event"` step record plus a per-action counter: the
    stream `tools/serve_trace.py --fleet` renders as roll episodes and
    `tools/perf_report.py --check --check-roll-convergence` gates.  Returns
    the record."""
    rec = {"kind": "fleet_event", "action": action, "ts": time.time(), **fields}
    MONITOR.counter(f"serving.fleet.events[{action}]").inc()
    MONITOR.record_step(rec)
    return rec


def record_trace(record: dict):
    return MONITOR.record_trace(record)


def request_traces():
    return MONITOR.request_traces()


def record_exemplar(record: dict):
    return MONITOR.record_exemplar(record)


def exemplars():
    return MONITOR.exemplars()


def set_lane(lane: int, name=None):
    return MONITOR.set_lane(lane, name)


def attach_logger(logger):
    if isinstance(logger, MonitorLogger):
        logger.bind(MONITOR)
    return MONITOR.attach_logger(logger)


def detach_logger(logger):
    return MONITOR.detach_logger(logger)


def arm_flight_recorder(path: str, rank: int = 0) -> Monitor:
    """Name this process's black-box file (`BLACKBOX.p<rank>.json`); the
    bounded rings of the newest steps and spans are dumped there on a crash,
    a SIGTERM drain, a preemption or a divergence."""
    return MONITOR.arm_flight_recorder(path, rank)


def dump_blackbox(reason: str = "manual", path=None):
    """Atomically write the flight-recorder black box (first dump wins);
    returns its path, or None when unarmed."""
    return MONITOR.dump_blackbox(reason, path)


def blackbox_snapshot(reason: str = "manual") -> dict:
    return MONITOR.blackbox_snapshot(reason)


def init_worker_telemetry(telemetry_dir=None, rank=None, every: int = 1):
    """Arm this worker's end of the gang telemetry plane (rank-stamped JSONL
    stream, flight recorder, crash hook, exit-time Chrome trace); a no-op
    without a telemetry directory.  See exporters.py."""
    return _exp.init_worker_telemetry(telemetry_dir, rank, MONITOR, every)


def telemetry_dir():
    return _exp.telemetry_dir()


def export_prometheus(labels=None) -> str:
    return prometheus_text(MONITOR, labels=labels)


def export_json(path: str, include_steps: bool = True) -> str:
    return _exp.export_json(MONITOR, path, include_steps)


def json_snapshot(include_steps: bool = True) -> dict:
    return _exp.json_snapshot(MONITOR, include_steps)


def export_chrome_trace(path: str, pid=None, process_name=None) -> int:
    return _exp.export_chrome_trace(MONITOR, pid=pid, path=path, process_name=process_name)


def merge_chrome_traces(named_paths, out_path: str) -> str:
    return _exp.merge_chrome_traces(named_paths, out_path)


def summary(sorted_key: str = "total") -> str:
    return summary_table(MONITOR, sorted_key)

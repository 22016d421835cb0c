"""paddle_tpu_torch.monitor: the port's observability (counterpart of
paddle_tpu/monitor, without its exporters yet).

    from paddle_tpu_torch import monitor

    monitor.enable()
    with monitor.span("compile", program=uuid):
        ...
    monitor.counter("executor.cache_miss").inc()

Disabled (the default) every entry point is a branch.  The executor
reports `executor.cache_hit` / `executor.cache_miss` (plan cache),
`executor.graph_capture` / `executor.graph_replay` / `executor.graph_refused`
(CUDA graphs), the spans `executor.dispatch` and `executor.fetch`, and one
kind="step" record a run; `pipeline.train_loop` the `pipeline.inflight`
gauge, the `pipeline.host_blocked` span and kind="pipeline_step" records;
memstats the lazy `memory.*` gauges.
"""
from __future__ import annotations

from .core import NULL_SPAN, Counter, Gauge, Monitor, Span  # noqa: F401
from .memstats import register_memory_gauges

__all__ = ["Counter", "Gauge", "Monitor", "Span", "NULL_SPAN", "MONITOR", "get_monitor",
           "enable", "disable", "is_enabled", "reset", "span", "observe", "counter", "gauge",
           "record_step", "step_records", "register_memory_gauges"]

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

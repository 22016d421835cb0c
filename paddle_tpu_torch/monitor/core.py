"""Monitor core: span tracer, counter/gauge registry and step records (the
part of paddle_tpu/monitor/core.py that the executor and
`pipeline.train_loop` report into).

Disabled (the default), `span()` returns a shared do-nothing singleton and
`Counter.inc` / `Gauge.set` / `observe` / `record_step` are one branch.  The
exporters, the flight recorder and the request-trace rings of the JAX
package's monitor are not ported yet (ROADMAP A7).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

# cap on buffered step records, so an always-on monitor in a long-running
# trainer cannot grow without bound
STEP_CAP = 50_000


class _NullSpan:
    """Shared do-nothing span returned while the monitor is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **kw):
        return self


NULL_SPAN = _NullSpan()


class Span:
    """Timed region, aggregated under its name (`Monitor.span_stats`)."""

    __slots__ = ("mon", "name", "args", "t0")

    def __init__(self, mon: "Monitor", name: str, args: Optional[dict]):
        self.mon = mon
        self.name = name
        self.args = args
        self.t0 = 0.0

    def annotate(self, **kw):
        if self.args is None:
            self.args = dict(kw)
        else:
            self.args.update(kw)
        return self

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.mon._record(self.name, time.perf_counter() - self.t0)
        return False


class Counter:
    """Monotonic counter: `inc` is one branch when disabled, and takes a
    per-counter lock when enabled (`value += n` alone can lose increments
    to a thread switch)."""

    __slots__ = ("mon", "name", "value", "_lock")

    def __init__(self, mon: "Monitor", name: str):
        self.mon = mon
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1):
        if self.mon.enabled:
            with self._lock:
                self.value += n
        return self


class Gauge:
    """Point-in-time value: `set()` explicitly, or `set_fn()` a callable
    read lazily (how the memory gauges stay off the hot path)."""

    __slots__ = ("mon", "name", "value", "fn")

    def __init__(self, mon: "Monitor", name: str):
        self.mon = mon
        self.name = name
        self.value = 0.0
        self.fn: Optional[Callable[[], float]] = None

    def set(self, v: float):
        if self.mon.enabled:
            self.value = v
        return self

    def set_fn(self, fn: Callable[[], float]):
        self.fn = fn
        return self

    def read(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:
                return float("nan")
        return float(self.value)


class Monitor:
    """Process-global telemetry sink (monitor/__init__.py holds the one
    instance)."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        # span aggregates: name -> [calls, total_s, max_s, min_s]
        self._agg: Dict[str, list] = {}
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._steps: List[dict] = []

    def enable(self):
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False
        return self

    def reset(self):
        with self._lock:
            self._agg.clear()
            self._steps.clear()
            for c in self._counters.values():
                c.value = 0
            for g in self._gauges.values():
                if g.fn is None:
                    g.value = 0.0
        return self

    # -- spans -------------------------------------------------------------
    def span(self, name: str, **args):
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, args or None)

    def observe(self, name: str, seconds: float, **args):
        """Record a completed duration without a context manager."""
        if self.enabled:
            self._record(name, seconds)

    def _record(self, name, dur):
        with self._lock:
            a = self._agg.get(name)
            if a is None:
                self._agg[name] = [1, dur, dur, dur]
            else:
                a[0] += 1
                a[1] += dur
                a[2] = max(a[2], dur)
                a[3] = min(a[3], dur)

    def span_stats(self) -> Dict[str, dict]:
        with self._lock:
            return {n: {"calls": a[0], "total_s": a[1], "max_s": a[2], "min_s": a[3]}
                    for n, a in self._agg.items()}

    # -- counters / gauges -------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(self, name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(self, name))
        return g

    def counter_values(self) -> Dict[str, int]:
        return {n: c.value for n, c in sorted(self._counters.items())}

    # -- step records ------------------------------------------------------
    def record_step(self, record: dict):
        """Append one record (the executor's kind="step", or train_loop's
        kind="pipeline_step").  Only kind="step" records advance the
        executor.steps counter."""
        if not self.enabled:
            return
        record = dict(record)
        record.setdefault("kind", "step")
        record.setdefault("ts", time.time())
        steps = self.counter("executor.steps")
        record["step"] = steps.value
        with self._lock:
            if len(self._steps) < STEP_CAP:
                self._steps.append(record)
        if record["kind"] == "step":
            steps.inc()

    def step_records(self) -> List[dict]:
        with self._lock:
            return list(self._steps)

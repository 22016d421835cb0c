"""Machine-readable views of Monitor state (counterpart of
paddle_tpu/monitor/exporters.py; the same text, documents and events for
the same records).

One source of truth (monitor.core.Monitor), several formats:
  * Prometheus text exposition: counters, gauges, span summaries;
  * JSON snapshot: everything;
  * Chrome trace JSON, with per-process lanes and span nesting (tid and
    depth kept), and the merge of several processes' traces;
  * the summary table the Fluid profiler printed;
  * MonitorLogger: a JSONL appender of step records and snapshots;
  * the per-worker telemetry plane (`init_worker_telemetry`);
  * the serving runtime's request traces as Chrome-trace async lanes
    (`request_trace_events`), inside the same trace document.
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, Optional

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
PROM_PREFIX = "paddle_tpu_"


def _prom_name(name: str) -> str:
    """Sanitize an arbitrary span/counter/gauge name into a legal metric
    name ([a-zA-Z_:][a-zA-Z0-9_:]*): every illegal character becomes `_`,
    and the PROM_PREFIX guarantees a legal leading character even for
    names that start with a digit.  Collisions (two raw names mapping to
    one family) are disambiguated at emission with a `raw` label."""
    return PROM_PREFIX + _NAME_RE.sub("_", str(name))


def escape_label_value(v) -> str:
    r"""Escape a label value per the exposition format: backslash, double
    quote, and newline must be written as \\, \", and \n."""
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _label_key(k) -> str:
    """Sanitize a label NAME ([a-zA-Z_][a-zA-Z0-9_]*): illegal characters
    become `_`, and a leading digit gets a `_` prefix (label names have
    no PROM_PREFIX to fix their first character the way metric names do)."""
    s = _NAME_RE.sub("_", str(k)) or "_"
    return "_" + s if s[0].isdigit() else s


def _label_str(labels) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_label_key(k)}="{escape_label_value(v)}"'
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def prometheus_text(mon, labels=None) -> str:
    """Prometheus text exposition format (one page per scrape).

    Metric names are sanitized, `labels` (e.g.
    {"rank": 0}, what a multi-rank scrape endpoint stamps per worker) are
    escaped per the format, a family's TYPE line is emitted exactly once,
    and when two raw names sanitize to the same family the later samples
    carry a `raw="<original>"` label instead of emitting an invalid
    duplicate series."""
    base = _label_str(labels)
    lines = []
    seen_types = set()
    family_raw: Dict[str, str] = {}

    def emit(family: str, typ: str, raw: str, suffix: str, value: str):
        first = family_raw.setdefault(family, raw)
        if family not in seen_types:
            seen_types.add(family)
            lines.append(f"# TYPE {family} {typ}")
        lab = base
        if first != raw:  # sanitization collision: disambiguate the series
            extra = f'raw="{escape_label_value(raw)}"'
            lab = base[:-1] + "," + extra + "}" if base else "{" + extra + "}"
        lines.append(f"{family}{suffix}{lab} {value}")

    for name, v in mon.counter_values().items():
        emit(_prom_name(name), "counter", name, "", str(v))
    for name, v in mon.gauge_values().items():
        emit(_prom_name(name), "gauge", name, "", "NaN" if v != v else str(v))
    for name, s in sorted(mon.span_stats().items()):
        p = _prom_name(name)
        # a summary family only admits _count/_sum/quantiles; max is its
        # own gauge so strict OpenMetrics parsers accept the page
        emit(p + "_seconds", "summary", name, "_count", str(s["calls"]))
        emit(p + "_seconds", "summary", name, "_sum", f"{s['total_s']:.9f}")
        emit(p + "_max_seconds", "gauge", name, "", f"{s['max_s']:.9f}")
    return "\n".join(lines) + "\n"


def json_snapshot(mon, include_steps: bool = True) -> dict:
    snap = {
        "kind": "snapshot",
        "ts": time.time(),
        "lane": mon.lane,
        "lane_name": mon.lane_name,
        "counters": mon.counter_values(),
        "gauges": mon.gauge_values(),
        "spans": mon.span_stats(),
    }
    if include_steps:
        snap["steps"] = mon.step_records()
    return snap


def export_json(mon, path: str, include_steps: bool = True) -> str:
    with open(path, "w") as f:
        json.dump(json_snapshot(mon, include_steps), f, indent=1)
    return path


def request_trace_events(mon, pid: Optional[int] = None) -> list:
    """The monitor's request traces (serving/tracing.py) as Chrome-trace
    async lanes: a b/e pair a span, keyed by the request's trace id, so a
    request shows from submit to respond above the executor spans that
    served it."""
    pid = mon.lane if pid is None else pid
    events = []
    for tr in getattr(mon, "request_traces", list)() or ():
        rid = str(tr.get("trace_id", "?"))
        t0_us = float(tr.get("ts", 0.0) or 0.0) * 1e6
        spans = tr.get("spans") or ()
        for i, sp in enumerate(spans):
            ts = t0_us + float(sp.get("t_ms", 0.0) or 0.0) * 1e3
            b = {"name": f"req.{sp.get('name', '?')}", "ph": "b",
                 "cat": "request", "id": rid, "pid": pid, "tid": 0,
                 "ts": ts}
            if i == 0:
                b["args"] = {"trace_id": rid,
                             "model": str(tr.get("model", "")),
                             "outcome": str(tr.get("outcome", "")),
                             "reason": str(tr.get("reason", "")),
                             "bucket": str(tr.get("bucket", "")),
                             "pad_rows": str(tr.get("pad_rows", ""))}
            events.append(b)
            events.append({"name": b["name"], "ph": "e", "cat": "request",
                           "id": rid, "pid": pid, "tid": 0,
                           "ts": ts + float(sp.get("dur_ms", 0.0) or 0.0)
                           * 1e3})
    return events


def chrome_trace_events(mon, pid: Optional[int] = None,
                        process_name: Optional[str] = None) -> list:
    pid = mon.lane if pid is None else pid
    events = [{"name": "process_name", "ph": "M", "pid": pid,
               "args": {"name": process_name or mon.lane_name}}]
    for name, ts, dur, tid, depth, args in mon.events():
        ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
              "ts": ts * 1e6, "dur": dur * 1e6, "cat": "span"}
        if args:
            ev["args"] = {k: str(v) for k, v in args.items()}
        events.append(ev)
    events.extend(request_trace_events(mon, pid))
    return events


def export_chrome_trace(mon, path: str, pid: Optional[int] = None,
                        process_name: Optional[str] = None) -> int:
    """Write buffered span events as Chrome trace JSON; returns the number
    of span events written (metadata rows and request-lane events
    excluded)."""
    events = chrome_trace_events(mon, pid, process_name)
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return sum(1 for e in events if e.get("ph") == "X")


def merge_chrome_traces(named_paths, out_path: str) -> str:
    """Merge several processes' traces into one timeline, one pid lane per
    input (the reference tool's `trainer1=f1,ps=f2` mode)."""
    merged = []
    items = (list(named_paths.items()) if isinstance(named_paths, dict)
             else list(enumerate(named_paths)))
    for pid, (name, p) in enumerate(items):
        with open(p) as f:
            doc = json.load(f)
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = pid
            merged.append(ev)
        merged.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": str(name)}})
    with open(out_path, "w") as f:
        json.dump({"traceEvents": merged}, f)
    return out_path


def summary_table(mon, sorted_key: str = "total") -> str:
    """The aggregate span table the old profiler printed from EventList."""
    stats = mon.span_stats()
    keyfn = {
        "total": lambda kv: -kv[1]["total_s"],
        "calls": lambda kv: -kv[1]["calls"],
        "max": lambda kv: -kv[1]["max_s"],
        "min": lambda kv: kv[1]["min_s"],
        "ave": lambda kv: -(kv[1]["total_s"] / max(kv[1]["calls"], 1)),
    }.get(sorted_key, lambda kv: -kv[1]["total_s"])
    lines = [
        f"{'Event':<40} {'Calls':>8} {'Total(ms)':>12} {'Avg(ms)':>10} {'Max(ms)':>10} {'Min(ms)':>10}"
    ]
    for tag, r in sorted(stats.items(), key=keyfn):
        avg = r["total_s"] / max(r["calls"], 1)
        lines.append(
            f"{tag:<40} {r['calls']:>8} {r['total_s']*1e3:>12.3f} {avg*1e3:>10.3f} "
            f"{r['max_s']*1e3:>10.3f} {r['min_s']*1e3:>10.3f}"
        )
    return "\n".join(lines)


class MonitorLogger:
    """Appends JSONL records for bench tooling: every `every`-th step
    record as it happens, plus full snapshots on demand.

        logger = monitor.attach_logger(MonitorLogger("metrics.jsonl"))
        ... train ...
        logger.write_snapshot()   # final counter/gauge state
        monitor.detach_logger(logger)
    """

    def __init__(self, path: str, every: int = 1):
        from ..core.locks import named_lock

        self.path = path
        self.every = max(int(every), 1)
        self._n = 0
        self._mon = None  # set by Monitor.attach_logger callers via bind
        self._fh = None   # persistent append handle: one write+flush per
        # record instead of open/close syscalls on every training step
        # records arrive from more than one thread (the heartbeat thread
        # emits dist_events, the training thread emits steps); a lock keeps
        # lines whole — interleaved partial writes would tear the JSONL
        self._wlock = named_lock("monitor.logger", rank=66, telemetry=False)

    def bind(self, mon):
        self._mon = mon
        return self

    def _file(self):
        if self._fh is None or self._fh.closed:
            self._fh = open(self.path, "a")
        return self._fh

    def close(self):
        if self._fh is not None and not self._fh.closed:
            self._fh.close()

    def on_step(self, record: dict):
        with self._wlock:
            # the sampling counter shares the lock: two threads racing
            # `_n += 1` would lose updates and skew the every-N sampling
            self._n += 1
            if self._n % self.every:
                return
            f = self._file()
            f.write(json.dumps(record, default=str) + "\n")
            f.flush()

    def write_snapshot(self, mon=None):
        mon = mon or self._mon
        if mon is None:
            from . import MONITOR

            mon = MONITOR
        line = json.dumps(json_snapshot(mon, include_steps=False),
                          default=str) + "\n"
        with self._wlock:
            f = self._file()
            f.write(line)
            f.flush()
        return self.path


# ---- the per-worker telemetry plane ------------------------------------------

_TELEMETRY: Dict[str, object] = {}


def telemetry_dir() -> Optional[str]:
    """The rank-stamped telemetry directory this process was armed with
    (None outside a telemetry-armed gang)."""
    return _TELEMETRY.get("dir")


def init_worker_telemetry(telemetry_dir: Optional[str] = None,
                          rank: Optional[int] = None, mon=None,
                          every: int = 1):
    """Arm this worker's end of the gang telemetry plane.

    A gang supervisor exports `PADDLE_TELEMETRY_DIR` per incarnation (the
    JAX package's launch.run_gang; the port's launcher comes with A10); each
    worker then, by an explicit call:

      * enables the monitor and attaches a rank-stamped
        `metrics.p<rank>.jsonl` MonitorLogger, the per-rank step stream;
      * arms the flight recorder at `BLACKBOX.p<rank>.json` (dumped on a
        crash and on a preemption's drain);
      * chains `sys.excepthook` so an unhandled exception dumps the black
        box before the traceback prints (the "crash" trigger);
      * registers an atexit hook writing the final counter snapshot and a
        `trace.p<rank>.json` Chrome trace for the merged timeline.

    Idempotent per process; returns the attached MonitorLogger (None when
    no directory is configured — the single-process default)."""
    import atexit
    import sys

    if "logger" in _TELEMETRY:
        return _TELEMETRY["logger"]
    root = telemetry_dir or os.environ.get("PADDLE_TELEMETRY_DIR")
    if not root:
        return None
    if rank is None:
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    if mon is None:
        from . import MONITOR

        mon = MONITOR
    os.makedirs(root, exist_ok=True)
    mon.enable()
    mon.set_lane(rank, f"trainer{rank}")
    mon.arm_flight_recorder(
        os.path.join(root, f"BLACKBOX.p{rank}.json"), rank)
    logger = MonitorLogger(
        os.path.join(root, f"metrics.p{rank}.jsonl"), every=every)
    logger.bind(mon)
    mon.attach_logger(logger)
    _TELEMETRY.update(dir=root, rank=rank, logger=logger)

    prev_hook = sys.excepthook

    def _crash_hook(tp, val, tb):
        mon.dump_blackbox(f"crash:{getattr(tp, '__name__', tp)}")
        prev_hook(tp, val, tb)

    sys.excepthook = _crash_hook

    def _final_flush():
        try:
            logger.write_snapshot(mon)
            export_chrome_trace(mon, os.path.join(root,
                                                  f"trace.p{rank}.json"))
        except Exception:
            pass

    atexit.register(_final_flush)
    return logger

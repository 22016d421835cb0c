"""The port's monitor, exporters, flight recorder and profiler against the
JAX package's (paddle_tpu/monitor, paddle_tpu/profiler.py), on the CPU.

The same spans, counters, gauges and step records, under one fixed clock,
go into a fresh Monitor of each package: the Prometheus page, the JSON
snapshot and the summary table are equal as strings or dicts, the Chrome
trace event for event.  A preemption under `resilient_train_loop` dumps the
black box with the same reason in both, and `profile_program` gives the
same op rows and call counts."""
import json
import math
import os
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import monitor as j_monitor
from paddle_tpu import profiler as j_profiler
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.monitor import core as j_core
from paddle_tpu.monitor import exporters as j_exp
from paddle_tpu_torch import monitor as t_monitor
from paddle_tpu_torch import profiler as t_profiler
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.monitor import core as t_core
from paddle_tpu_torch.monitor import exporters as t_exp
from paddle_tpu_torch.ops import cuda_kernels as ck

PKGS = {
    "jax": dict(fluid=jfluid, core=j_core, exp=j_exp, monitor=j_monitor, profiler=j_profiler,
                unique=j_unique),
    "torch": dict(fluid=tfluid, core=t_core, exp=t_exp, monitor=t_monitor, profiler=t_profiler,
                  unique=t_unique),
}


@pytest.fixture(autouse=True)
def launches_unchanged():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before, "a CPU run must not count a kernel launch"


class _Clock:
    """time.time and time.perf_counter, stepping 1.25 ms a read."""

    def __init__(self):
        self.t = 1_700_000_000.0

    def __call__(self):
        self.t += 0.00125
        return self.t


def _drive(pkg, monkeypatch, n_steps=3, n_spans=2):
    """One fresh Monitor fed a fixed script under a fixed clock."""
    clock = _Clock()
    monkeypatch.setattr(time, "time", clock)
    monkeypatch.setattr(time, "perf_counter", clock)
    mon = pkg["core"].Monitor().enable()
    for i in range(n_spans):
        with mon.span("executor.dispatch", program="p0", step=i):
            with mon.span("executor.fetch"):
                pass
    mon.observe("reader.wait", 0.0042)
    mon.counter("executor.cache_hit").inc(5)
    mon.counter("executor.cache_miss").inc()
    mon.counter("x.y").inc(2)  # sanitizes to the same family as x_y
    mon.counter("x_y").inc(3)
    mon.counter("9lives").inc()
    mon.gauge("pipeline.inflight").set(2)
    mon.gauge("memory.nan").set(float("nan"))
    for s in range(n_steps):
        mon.record_step({"kind": "step", "loss": 0.5 - 0.1 * s, "feed_ms": 1.5})
    mon.record_step({"kind": "pipeline_step", "inflight": 2})
    return mon


def _both(monkeypatch, fn, **kw):
    return {name: fn(pkg, _drive(pkg, monkeypatch, **kw)) for name, pkg in PKGS.items()}


def _same_nan(a, b):
    """Dicts equal, NaN equal to NaN."""
    return json.dumps(a, sort_keys=True, default=str) == json.dumps(b, sort_keys=True, default=str)


LABELS = {"rank": 0, "job": 'tr"ain\\er\nx', "1st": "a"}


@pytest.mark.parametrize("labels", [None, LABELS], ids=["plain", "escaped_labels"])
def test_prometheus_text_matches(monkeypatch, labels):
    got = _both(monkeypatch, lambda pkg, mon: pkg["exp"].prometheus_text(mon, labels=labels))
    assert got["torch"] == got["jax"]
    assert 'raw="x_y"' in got["torch"] and " NaN\n" in got["torch"]


@pytest.mark.parametrize("include_steps", [True, False])
def test_json_snapshot_matches(monkeypatch, include_steps):
    got = _both(monkeypatch, lambda pkg, mon: pkg["exp"].json_snapshot(mon, include_steps))
    assert _same_nan(got["torch"], got["jax"])
    if include_steps:
        assert [r["step"] for r in got["torch"]["steps"]] == [0, 1, 2, 3]
        assert got["torch"]["gauges"]["executor.steps_per_sec_ema"] > 0


@pytest.mark.parametrize("sorted_key", ["total", "calls", "max", "min", "ave"])
def test_summary_table_matches(monkeypatch, sorted_key):
    got = _both(monkeypatch, lambda pkg, mon: pkg["exp"].summary_table(mon, sorted_key))
    assert got["torch"] == got["jax"]
    assert len(got["torch"].splitlines()) == 4  # the header and three span names


def test_chrome_trace_events_match(monkeypatch):
    got = _both(monkeypatch, lambda pkg, mon: pkg["exp"].chrome_trace_events(
        mon, pid=3, process_name="trainer3"))
    assert len(got["torch"]) == len(got["jax"]) == 1 + 2 * 2 + 1
    for t, j in zip(got["torch"], got["jax"]):
        assert t == j
    nested = [e for e in got["torch"] if e["name"] == "executor.fetch"]
    outer = [e for e in got["torch"] if e["name"] == "executor.dispatch"]
    assert nested[0]["ts"] > outer[0]["ts"] and nested[0]["dur"] < outer[0]["dur"]
    assert outer[0]["args"] == {"program": "p0", "step": "0"}


def test_chrome_trace_export_and_merge(monkeypatch, tmp_path):
    """export_chrome_trace writes the same document and returns the same
    count; merge_chrome_traces merges two files into one, a lane each."""
    docs = {}
    for name, pkg in PKGS.items():
        a, b = tmp_path / f"{name}_a.json", tmp_path / f"{name}_b.json"
        n = pkg["exp"].export_chrome_trace(_drive(pkg, monkeypatch), str(a))
        pkg["exp"].export_chrome_trace(_drive(pkg, monkeypatch, n_spans=1), str(b), pid=7)
        assert n == 5
        out = tmp_path / f"{name}_merged.json"
        assert pkg["exp"].merge_chrome_traces({"trainer0": str(a), "trainer1": str(b)},
                                              str(out)) == str(out)
        docs[name] = json.loads(out.read_text())
    assert docs["torch"] == docs["jax"]
    events = docs["torch"]["traceEvents"]
    assert {e["pid"] for e in events} == {0, 1}
    assert sum(1 for e in events if e["ph"] == "X") == 5 + 3


def test_monitor_logger_writes_the_same_jsonl(monkeypatch, tmp_path):
    lines = {}
    for name, pkg in PKGS.items():
        mon = _drive(pkg, monkeypatch, n_steps=0)
        logger = pkg["exp"].MonitorLogger(str(tmp_path / f"{name}.jsonl"), every=2).bind(mon)
        mon.attach_logger(logger)
        for s in range(5):
            mon.record_step({"kind": "step", "loss": float(s)})
        logger.write_snapshot()
        mon.detach_logger(logger)
        lines[name] = [json.loads(line) for line in open(logger.path)]
    assert _same_nan(lines["torch"], lines["jax"])
    assert [r.get("step") for r in lines["torch"][:-1]] == [1, 3]
    assert lines["torch"][-1]["kind"] == "snapshot"


# --- the flight recorder ------------------------------------------------------------

def test_blackbox_snapshot_has_the_jax_keys_and_ring_bounds(monkeypatch):
    """Past FLIGHT_RECORDER_CAP records the rings keep the newest; the
    snapshot is the JAX package's document (its exemplars empty in both)."""
    cap = t_core.FLIGHT_RECORDER_CAP
    assert cap == j_core.FLIGHT_RECORDER_CAP
    got = _both(monkeypatch, lambda pkg, mon: mon.blackbox_snapshot("manual"),
                n_steps=cap + 10, n_spans=cap)
    t, j = got["torch"], got["jax"]
    assert sorted(t) == sorted(j)
    assert _same_nan(t, j)
    assert len(t["steps"]) == len(t["events"]) == cap
    assert t["steps"][-1]["kind"] == "pipeline_step" and t["steps"][0]["step"] == 11
    assert t["exemplars"] == [] and t["reason"] == "manual"


def test_dump_blackbox_is_atomic_and_the_first_dump_wins(monkeypatch, tmp_path):
    for name, pkg in PKGS.items():
        mon = _drive(pkg, monkeypatch)
        assert mon.dump_blackbox("unarmed") is None
        path = str(tmp_path / f"BLACKBOX.{name}.json")
        mon.arm_flight_recorder(path, rank=2)
        assert mon.flight_recorder_path() == path
        assert mon.dump_blackbox("watchdog") == path
        assert mon.dump_blackbox("crash:RuntimeError") == path  # the first dump wins
        doc = json.loads(open(path).read())
        assert doc["reason"] == "watchdog" and doc["rank"] == 2
        assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
        mon.reset()  # re-opens the latch
        assert mon.dump_blackbox("second run") == path
        assert json.loads(open(path).read())["reason"] == "second run"


def _fit_a_line(pkg):
    fluid = pkg["fluid"]
    main, startup = fluid.Program(), fluid.Program()
    with pkg["unique"].guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [13], dtype="float32")
        y = fluid.layers.data("y", [1], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.square_error_cost(fluid.layers.fc(x, 1), y))
        fluid.optimizer.SGD(0.01).minimize(loss)
    return main, startup, loss


def _feeds(n):
    r = np.random.RandomState(0)
    out = []
    for _ in range(n):
        x = r.rand(8, 13).astype("f4")
        out.append({"x": x, "y": x.sum(1, keepdims=True)})
    return out


@pytest.fixture
def armed(tmp_path):
    """Each package's process monitor armed at its own BLACKBOX file; reset
    and disarmed after."""
    paths = {}
    for name, pkg in PKGS.items():
        mon = pkg["monitor"].MONITOR
        mon.reset()
        mon.enable()
        paths[name] = str(tmp_path / f"BLACKBOX.{name}.p0.json")
        pkg["monitor"].arm_flight_recorder(paths[name], 0)
    yield paths
    for pkg in PKGS.values():
        mon = pkg["monitor"].MONITOR
        mon.disable()
        mon.reset()
        mon._bb_path = None


@pytest.mark.parametrize("checkpoint", [False, True], ids=["no_checkpoint", "checkpoint"])
def test_preemption_dumps_the_blackbox_in_both_packages(armed, tmp_path, checkpoint):
    """preempt@4 on the fit-a-line program under resilient_train_loop: the
    drain writes the black box in both packages, with the same reason, the
    same step records' steps and the flush's resilience_event in it."""
    docs = {}
    for name, pkg in PKGS.items():
        fluid = pkg["fluid"]
        main, startup, loss = _fit_a_line(pkg)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        kw = {}
        if checkpoint:
            kw["checkpoint_manager"] = fluid.CheckpointManager(
                str(tmp_path / f"ckpt_{name}"), program=main, scope=scope,
                **({"place": fluid.CPUPlace()} if name == "torch" else {}))
        stats = fluid.resilient_train_loop(exe, main, lambda: _feeds(10), [loss], scope=scope,
                                           injector=fluid.FaultInjector("preempt@4"), **kw)
        assert stats.preempted and stats.resume_step == 4
        docs[name] = json.loads(open(armed[name]).read())
    t, j = docs["torch"], docs["jax"]
    assert t["reason"] == j["reason"] == "sigterm_drain"
    assert sorted(t) == sorted(j)
    kinds = lambda d: [(r["kind"], r.get("action")) for r in d["steps"]]  # noqa: E731
    assert kinds(t) == kinds(j)
    assert ("resilience_event", "preempt_flush") in kinds(t)
    assert t["counters"]["resilience.preemptions"] == j["counters"]["resilience.preemptions"] == 1


# --- the profiler -------------------------------------------------------------------

def _rows(table):
    """{op or span: calls} of a profiler table."""
    return {line.split()[0]: int(line.split()[1]) for line in table.splitlines()[1:]}


def test_profile_program_gives_the_same_op_rows(tmp_path):
    """profile_program inside profiler.profiler(): the same ops with the same
    call counts in both packages, in its own table and in the summary the
    profiler writes (whose rows also hold each package's executor spans)."""
    tables = {}
    for name, pkg in PKGS.items():
        fluid, prof = pkg["fluid"], pkg["profiler"]
        main, startup, loss = _fit_a_line(pkg)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        prof.reset_profiler()
        path = str(tmp_path / f"{name}.txt")
        with prof.profiler("All", "calls", profile_path=path):
            table = prof.profile_program(main, _feeds(1)[0], scope=scope, place=fluid.CPUPlace(),
                                         repeat=3)
        tables[name] = (_rows(table), _rows(open(path).read()))
        assert not pkg["monitor"].is_enabled()  # the profiler turned it on, and off
        prof.reset_profiler()
    ops, summary = tables["torch"]
    assert ops == tables["jax"][0]
    assert ops == {"mul": 3, "elementwise_add": 3, "square_error_cost": 3, "mean": 3}
    assert {k: summary[k] for k in ops} == {k: tables["jax"][1][k] for k in ops} == ops


def test_profiler_leaves_an_enabled_monitor_on_and_refuses_a_host_only_trace(tmp_path):
    t_monitor.enable()
    try:
        with t_profiler.profiler(profile_path=str(tmp_path / "t.txt")):
            pass
        assert t_monitor.is_enabled()
    finally:
        t_monitor.disable()
        t_monitor.reset()
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        with t_profiler.profiler(profile_path=str(tmp_path / "t.txt"),
                                 trace_dir=str(tmp_path / "trace")):
            pass
    assert not os.path.exists(tmp_path / "trace" / "trace.json")
    assert not t_monitor.is_enabled()
    with t_profiler.cuda_profiler("unused.txt"):  # no card: the JAX package's no-op
        pass

"""Request-flight tracing of the port's serving runtime against the JAX
package's on the CPU (the cases of tests/test_request_tracing.py that reach
ported code).

Both packages serve the same model (saved by the JAX package) to the same
requests; each case returns the traces' outcomes, reason codes and span
names, the serving_batch / serving_event records' fields that are not
times, the exemplars, the pad and SLO gauges and counters, and the two
packages must agree.  The stdlib tools `tools/serve_trace.py` and
`tools/perf_report.py` (run, never edited) check the port's monitor JSONL
as they check the JAX package's.
"""
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu_torch.core import unique_name as t_unique

D_IN, D_OUT = 8, 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(fluid, unique, name):
    from importlib import import_module

    return SimpleNamespace(name=name, fluid=fluid, serving=fluid.serving,
                           monitor=fluid.monitor, mon=fluid.monitor.MONITOR,
                           ServingError=fluid.errors.ServingError, unique=unique,
                           tracing=import_module(f"{fluid.__name__}.serving.tracing"),
                           batcher=import_module(f"{fluid.__name__}.serving.batcher"))


PKGS = {"jax": _pkg(jfluid, j_unique, "jax"), "torch": _pkg(tfluid, t_unique, "torch")}


@pytest.fixture
def mon():
    for P in PKGS.values():
        P.monitor.reset()
        P.monitor.enable()
    yield
    for P in PKGS.values():
        P.monitor.disable()
        P.monitor.reset()


def _save_model(dirname, w_scale=1.0, poison_nan=False):
    with j_unique.guard():
        main, startup = jfluid.Program(), jfluid.Program()
        with jfluid.program_guard(main, startup):
            x = jfluid.layers.data("x", [D_IN], dtype="float32")
            out = jfluid.layers.fc(x, D_OUT, act=None)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    startup.random_seed = 3
    exe.run(startup, scope=scope)
    for v in main.list_vars():
        if v.persistable:
            arr = np.full(np.asarray(scope.find_var(v.name)).shape, w_scale, dtype="float32")
            if poison_nan:
                arr.flat[0] = np.nan
            scope.set_var(v.name, arr)
    jfluid.io.save_inference_model(dirname, ["x"], [out], exe, main, scope)
    return dirname


def _server(P, tmp, name="m", buckets=(2, 4), w_scale=1.0, **kw):
    d = _save_model(str(tmp / f"model_{name}_{w_scale}"), w_scale)
    reg = P.serving.ModelRegistry(place=P.fluid.CPUPlace())
    srv = P.serving.Server(reg, buckets=buckets, **kw)
    srv.load_model(name, d, warm=kw.get("start", True))
    return srv, d


def _traces(P, outcome=None):
    ts = P.monitor.request_traces()
    return ts if outcome is None else [t for t in ts if t.get("outcome") == outcome]


def _shape(t):
    """A trace without its times and ids."""
    keep = ("kind", "model", "rows", "outcome", "reason", "deadline_ms", "bucket",
            "pad_rows", "batch_rows", "slo_miss", "queue_depth")
    return {**{k: t[k] for k in keep if k in t}, "spans": [s["name"] for s in t["spans"]]}


def _both(case, tmp_path, **kw):
    got = {}
    for P in PKGS.values():
        P.monitor.reset()
        tmp = tmp_path / P.name
        tmp.mkdir()
        got[P.name] = case(P, tmp, **kw)
    assert got["torch"] == got["jax"]
    return got["torch"]


# --------------------------------------------------------------------------
# the span tree of a completed request
# --------------------------------------------------------------------------

def _case_completed(P, tmp):
    srv, _ = _server(P, tmp, buckets=(2,))
    try:
        srv.infer("m", {"x": np.ones((1, D_IN), "f4")})
    finally:
        srv.stop()
    (t,) = _traces(P, "completed")
    assert t["trace_id"].startswith("r") and t["lat_ms"] > 0
    total = sum(s["dur_ms"] for s in t["spans"])
    assert total == pytest.approx(t["total_ms"], abs=0.01)
    for prev, nxt in zip(t["spans"], t["spans"][1:]):
        assert nxt["t_ms"] == pytest.approx(prev["t_ms"] + prev["dur_ms"], abs=0.01)
    (b,) = [r for r in P.monitor.step_records() if r.get("kind") == "serving_batch"]
    assert b["trace_ids"] == [t["trace_id"]] and 0.0 <= b["queue_wait_frac"] <= 1.0
    assert b["queue_ms_max"] >= b["queue_ms_mean"] >= 0
    assert all(b[k] >= 0 for k in ("t_build_s", "t_infer_s", "t_fetch_s"))
    return {"trace": _shape(t), "phases": list(P.tracing.TRACE_PHASES),
            "batch": {k: b[k] for k in ("model", "bucket", "rows", "requests", "pad_rows",
                                        "pad_frac", "occupancy", "queue_depth")}}


def test_completed_trace_full_span_tree_and_batch_record(tmp_path, mon):
    got = _both(_case_completed, tmp_path)
    assert got["trace"]["spans"] == got["phases"]
    assert got["trace"]["bucket"] == 2 and got["trace"]["pad_rows"] == 1
    assert got["batch"]["pad_frac"] == 0.5


# --------------------------------------------------------------------------
# every terminal outcome closes a trace
# --------------------------------------------------------------------------

def _case_all_outcomes(P, tmp):
    srv, _ = _server(P, tmp, buckets=(2, 4), max_queue=2, start=False)
    srv.registry.warm("m", (2, 4))
    xv = np.ones((1, D_IN), "f4")
    completed = srv.submit("m", {"x": xv})
    doomed = srv.submit("m", {"x": xv}, deadline_ms=5)
    with pytest.raises(P.ServingError) as shed_ei:
        srv.submit("m", {"x": xv})
    with pytest.raises(P.ServingError) as rej_ei:
        srv.submit("nope", {"x": xv})
    time.sleep(0.08)
    srv.start()
    completed.result(timeout=30)
    with pytest.raises(P.ServingError):
        doomed.result(timeout=30)
    srv.stop()
    srv2, _ = _server(P, tmp, name="m2", buckets=(2,), start=False)
    leftover = srv2.submit("m2", {"x": xv})
    srv2.stop()
    with pytest.raises(P.ServingError) as sd_ei:
        leftover.result(timeout=5)
    assert shed_ei.value.trace_id == _traces(P, "shed")[0]["trace_id"]
    assert len([t for t in _traces(P) if t["outcome"] != "rejected"]) == \
        srv.stats()["requests"] + srv2.stats()["requests"]
    return {"traces": sorted((_shape(t) for t in _traces(P)), key=json.dumps),
            "reasons": [shed_ei.value.reason, rej_ei.value.reason, sd_ei.value.reason],
            "ledgers": [srv.ledger(), srv2.ledger()]}


def test_all_terminal_outcomes_close_traces(tmp_path, mon):
    got = _both(_case_all_outcomes, tmp_path)
    by = {}
    for t in got["traces"]:
        by[t["outcome"]] = (t.get("reason"), t["spans"][-1])
    assert by == {"completed": (None, "respond"), "shed": ("overload", "admission"),
                  "timeout": ("timeout", "batch_build"),
                  "rejected": ("model_missing", "admission"),
                  "shutdown": ("shutdown", "queue")}
    assert got["reasons"] == ["overload", "model_missing", "shutdown"]


def _case_error_path(P, tmp, monkeypatch):
    srv, _ = _server(P, tmp, buckets=(2,))
    try:
        def bomb(*a, **k):
            raise OSError("simulated result-split disaster")

        monkeypatch.setattr(P.batcher, "split_rows", bomb)
        with pytest.raises(Exception):
            srv.infer("m", {"x": np.ones((1, D_IN), "f4")})
    finally:
        srv.stop()
    (t,) = _traces(P, "error")
    return {"trace": _shape(t), "errors": srv.stats()["errors"],
            "exemplars": [e["outcome"] for e in P.monitor.blackbox_snapshot()["exemplars"]]}


def test_error_path_closes_traces_classified(tmp_path, mon, monkeypatch):
    got = _both(_case_error_path, tmp_path, monkeypatch=monkeypatch)
    assert got["trace"]["spans"][-1] == "error" and got["trace"]["reason"] == "OSError"
    assert got["errors"] == 1 and got["exemplars"] == ["error"]


# --------------------------------------------------------------------------
# exemplars and control ids
# --------------------------------------------------------------------------

def _case_exemplars(P, tmp):
    srv, _ = _server(P, tmp, buckets=(2,), max_queue=1, start=False)
    srv.registry.warm("m", (2,))
    xv = np.ones((1, D_IN), "f4")
    doomed = srv.submit("m", {"x": xv}, deadline_ms=5)
    with pytest.raises(P.ServingError):
        srv.submit("m", {"x": xv})
    time.sleep(0.08)
    srv.start()
    with pytest.raises(P.ServingError):
        doomed.result(timeout=30)
    srv.stop()
    exes = P.monitor.blackbox_snapshot()["exemplars"]
    assert all(e["kind"] == "serving_trace" for e in exes)
    return sorted(json.dumps(_shape(e), sort_keys=True) for e in exes)


def test_shed_and_timeout_exemplars_in_blackbox(tmp_path, mon):
    got = _both(_case_exemplars, tmp_path)
    assert sorted(json.loads(e)["outcome"] for e in got) == ["shed", "timeout"]


def _case_control_ids(P, tmp):
    srv, _ = _server(P, tmp, buckets=(2,))
    xv = np.ones((1, D_IN), "f4")
    try:
        srv.infer("m", {"x": xv})
        v2 = _save_model(str(tmp / "v2"), w_scale=2.0)
        srv.publish("m", v2)
        srv.rollback("m")
        bad = _save_model(str(tmp / "bad"), w_scale=2.0, poison_nan=True)
        with pytest.raises(P.ServingError) as ei:
            srv.publish("m", bad)
        srv.infer("m", {"x": xv})
    finally:
        srv.stop()
    events = {r["action"]: r for r in P.monitor.step_records()
              if r.get("kind") == "serving_event"}
    exes = [e for e in P.monitor.blackbox_snapshot()["exemplars"]
            if e.get("reason") == "publish_rejected"]
    return {"publish": events["publish"]["trace_id"].split("-")[0],
            "rollback": events["rollback"]["trace_id"].split("-")[0],
            "rejected_id_shared": (ei.value.trace_id == events["publish_rejected"]["trace_id"]
                                   == exes[0]["trace_id"]),
            "reason": ei.value.reason, "completed": len(_traces(P, "completed"))}


def test_publish_rollback_and_rejection_carry_control_ids(tmp_path, mon):
    got = _both(_case_control_ids, tmp_path)
    assert got == {"publish": "pub", "rollback": "rb", "rejected_id_shared": True,
                   "reason": "publish_rejected", "completed": 2}


# --------------------------------------------------------------------------
# the disabled monitor
# --------------------------------------------------------------------------

def test_disabled_monitor_null_trace(tmp_path):
    for P in PKGS.values():
        P.monitor.disable()
        P.monitor.reset()
        tr = P.tracing.maybe_trace(P.mon, "m")
        assert tr is P.tracing.NULL_TRACE is P.tracing.maybe_trace(P.mon, "o", deadline_ms=5.0)
        assert tr.trace_id is None and tr.enabled is False and tr.close("completed") is None
        tmp = tmp_path / P.name
        tmp.mkdir()
        srv, _ = _server(P, tmp, buckets=(2,))
        try:
            (out,) = srv.infer("m", {"x": np.ones((1, D_IN), "f4")})
            assert out.shape == (1, D_OUT)
        finally:
            srv.stop()
        assert P.monitor.request_traces() == [] and srv.stats()["requests"] == 1


# --------------------------------------------------------------------------
# pad waste, queue wait and the SLO
# --------------------------------------------------------------------------

def _settled(srv, completed, timeout=30.0):
    """Wait until the server's own ledger counts `completed` requests.  A
    worker resolves each request's future before it counts the request's
    batch, in both packages, so a client that reads right after its result
    can find its batch not yet counted (ROADMAP C)."""
    deadline = time.monotonic() + timeout
    while srv.stats()["completed"] < completed:
        assert time.monotonic() < deadline, srv.stats()
        time.sleep(0.005)


def _case_pad(P, tmp):
    srv, _ = _server(P, tmp, buckets=(2, 4))
    try:
        srv.infer("m", {"x": np.ones((1, D_IN), "f4")})
        srv.infer("m", {"x": np.ones((3, D_IN), "f4")})
        # the gauges read the server's ledger, and stop() releases them
        _settled(srv, 2)
        queue_wait = P.monitor.gauge("serving.queue_wait_frac").read()
        pad_frac = [P.monitor.gauge(f"serving.bucket[{b}].pad_frac").read() for b in (2, 4)]
    finally:
        srv.stop()
    # the monitor's counters are bumped after the ledger: read once stop()
    # has drained the queue and joined the workers
    attr = srv.bucket_attribution()
    assert 0.0 <= queue_wait <= 1.0
    return {"pad_rows": P.monitor.counter("serving.pad_rows").value,
            "pad_frac": pad_frac,
            "attr": {b: {k: a[k] for k in ("pad_rows", "requests", "rows", "occupancy",
                                           "pad_frac", "batches")}
                     for b, a in attr.items()}}


def test_pad_counter_and_bucket_pad_frac_gauge(tmp_path, mon):
    got = _both(_case_pad, tmp_path)
    assert got["pad_rows"] == 2 and got["pad_frac"] == [0.5, 0.25]
    assert got["attr"][4]["occupancy"] == 0.75


def _case_slo(P, tmp):
    srv, _ = _server(P, tmp, buckets=(2,), max_queue=1, start=False)
    srv.registry.warm("m", (2,))
    xv = np.ones((1, D_IN), "f4")
    doomed = srv.submit("m", {"x": xv}, deadline_ms=5)
    with pytest.raises(P.ServingError):
        srv.submit("m", {"x": xv})
    time.sleep(0.08)
    srv.start()
    with pytest.raises(P.ServingError):
        doomed.result(timeout=30)
    srv.infer("m", {"x": xv})
    _settled(srv, 1)
    gauges = {"good_frac": round(P.monitor.gauge("serving.slo_good_frac").read(), 6),
              "burn": round(P.monitor.gauge("serving.slo_burn_rate").read(), 6)}
    srv.stop()
    return {"slo": srv.stats()["slo"], "good": P.monitor.counter("serving.slo_good").value,
            "bad": P.monitor.counter("serving.slo_bad").value, **gauges}


def test_slo_burn_accounting(tmp_path, mon):
    got = _both(_case_slo, tmp_path)
    assert got["slo"]["good"] == got["good"] == 1 and got["slo"]["bad"] == got["bad"] == 2
    assert got["good_frac"] == pytest.approx(1 / 3, abs=1e-3) and got["burn"] > 1.0


# --------------------------------------------------------------------------
# the rings, RequestTrace, the Chrome-trace lanes
# --------------------------------------------------------------------------

def test_trace_and_exemplar_rings_bounded(mon):
    from paddle_tpu.monitor import EXEMPLAR_CAP, TRACE_RING_CAP

    assert (tfluid.monitor.TRACE_RING_CAP, tfluid.monitor.EXEMPLAR_CAP) == (
        TRACE_RING_CAP, EXEMPLAR_CAP)
    m = tfluid.monitor
    for i in range(TRACE_RING_CAP + 50):
        m.record_trace({"trace_id": f"r{i}", "outcome": "completed", "spans": []})
    assert len(m.request_traces()) == TRACE_RING_CAP
    assert m.request_traces()[-1]["trace_id"] == f"r{TRACE_RING_CAP + 49}"
    assert m.step_records()[-1]["kind"] == "serving_trace"
    for i in range(EXEMPLAR_CAP + 20):
        m.record_exemplar({"trace_id": f"e{i}"})
    assert len(m.exemplars()) == EXEMPLAR_CAP
    assert len(m.blackbox_snapshot()["exemplars"]) == EXEMPLAR_CAP
    m.reset()
    assert m.request_traces() == [] and m.exemplars() == []
    m.disable()
    m.record_trace({"trace_id": "r1", "outcome": "completed"})
    m.record_exemplar({"trace_id": "r1"})
    assert m.request_traces() == [] and m.exemplars() == []


def test_request_trace_first_close_wins_and_phases_freeze():
    recs = {}
    for P in PKGS.values():
        tr = P.tracing.RequestTrace("m", rows=1)
        tr.phase("admission").phase("queue")
        rec = tr.close("timeout", reason="timeout", final="batch_build")
        assert tr.close("error", reason="boom") is None
        tr.phase("device")
        assert len(tr.marks) == 3
        assert P.tracing.control_trace_id("pub").startswith("pub-")
        recs[P.name] = _shape(rec)
    assert recs["torch"] == recs["jax"]
    assert recs["torch"]["spans"] == ["admission", "queue", "batch_build"]


def _case_chrome(P, tmp):
    srv, _ = _server(P, tmp, buckets=(2,))
    try:
        srv.infer("m", {"x": np.ones((1, D_IN), "f4")})
    finally:
        srv.stop()
    path = str(tmp / "trace.json")
    assert P.monitor.export_chrome_trace(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    req = [e for e in events if e.get("cat") == "request"]
    (t,) = _traces(P, "completed")
    assert {e["id"] for e in req} == {t["trace_id"]}
    merged = str(tmp / "merged.json")
    P.monitor.merge_chrome_traces({"r0": path}, merged)
    with open(merged) as f:
        assert any(e.get("cat") == "request" for e in json.load(f)["traceEvents"])
    return sorted((e["name"], e["ph"]) for e in req)


def test_chrome_trace_request_lanes(tmp_path, mon):
    got = _both(_case_chrome, tmp_path)
    assert len(got) == 12 and ("req.device", "b") in got


# --------------------------------------------------------------------------
# the stdlib tools on the port's monitor stream
# --------------------------------------------------------------------------

def _run_round(P, tmp):
    """3 completed and 1 shed, logged to JSONL."""
    path = str(tmp / "metrics.jsonl")
    logger = P.monitor.attach_logger(P.monitor.MonitorLogger(path))
    srv, _ = _server(P, tmp, buckets=(2,), max_queue=1, start=False)
    srv.registry.warm("m", (2,))
    xv = np.ones((1, D_IN), "f4")
    first = srv.submit("m", {"x": xv})
    with pytest.raises(P.ServingError):
        srv.submit("m", {"x": xv})
    srv.start()
    first.result(timeout=30)
    srv.infer("m", {"x": xv})
    srv.infer("m", {"x": xv})
    logger.write_snapshot()
    P.monitor.detach_logger(logger)
    srv.stop()
    return path


def _case_tools(P, tmp, capsys):
    from tools import perf_report, serve_trace

    path = _run_round(P, tmp)
    capsys.readouterr()
    rcs = [serve_trace.main([path]),
           serve_trace.main([path, "--request", _traces(P, "completed")[0]["trace_id"]]),
           serve_trace.main([path, "--top"]),
           serve_trace.main([path, "--check", "--max-queue-wait-frac", "0.999",
                             "--max-pad-frac", "0.9"]),
           serve_trace.main([path, "--check", "--max-pad-frac", "0.1"]),
           perf_report.check(path, max_queue_wait_frac=0.999, max_pad_frac=0.9),
           perf_report.check(path, max_pad_frac=0.1),
           perf_report.check(path, max_shed_frac=0.5, max_p99_ms=60_000.0),
           perf_report.check(path, max_shed_frac=0.1)]
    out = capsys.readouterr().out
    assert "completed" in out and "shed" in out and "queue_frac" in out
    cli = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "serve_trace.py"), path,
                          "--check", "--max-queue-wait-frac", "0.999"],
                         capture_output=True, text=True)
    return {"rcs": rcs, "cli": (cli.returncode, "OK" in cli.stdout)}


def test_serve_trace_and_perf_report_check_the_port_stream(tmp_path, mon, capsys):
    """`serve_trace` renders, reconciles and gates the port's JSONL as it
    does the JAX package's; `perf_report --check` with the serving gates
    (shed fraction 1/4 of 4 requests) too."""
    got = _both(_case_tools, tmp_path, capsys=capsys)
    assert got == {"rcs": [0, 0, 0, 0, 1, 0, 1, 0, 1], "cli": (0, True)}

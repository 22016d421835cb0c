"""The serving runtime (paddle_tpu_torch.serving) against the JAX package's
(paddle_tpu.serving) on the CPU.

Every case of tests/test_serving.py that reaches ported code runs here in
both packages, on the same model (a one-fc net saved by the JAX package,
weights all `w_scale`, so it serves s * (sum(x) + 1)) and the same seeded
requests, each package in a directory of its own; `Server(start=False)`
wherever an order must be fixed.  Each case returns what it saw -- the
responses, `stats()` without its times, `ledger()`, the monitor's serving.*
counters, the `serving_event` actions and the traces' outcomes, reason
codes and phases -- and the two packages must agree.  Times are never
compared.  On top: the port's registry releases a version's executor plans
when it drops the version (weakref test); quantized (int8) model
directories load, publish through the quant-parity rung and are priced as
in the JAX package.
"""
import errno
import gc
import json
import os
import shutil
import threading
import time
import weakref
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu_torch.core import unique_name as t_unique

D_IN, D_OUT = 8, 4


def _pkg(fluid, unique, name):
    return SimpleNamespace(
        name=name, fluid=fluid, serving=fluid.serving, monitor=fluid.monitor,
        mon=fluid.monitor.MONITOR, ServingError=fluid.errors.ServingError,
        unique=unique, io=fluid.io,
        server_mod=__import__(f"{fluid.__name__}.serving.server", fromlist=["_bk"]))


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


def _build_net(P):
    with P.unique.guard():
        main, startup = P.fluid.Program(), P.fluid.Program()
        with P.fluid.program_guard(main, startup):
            x = P.fluid.layers.data("x", [D_IN], dtype="float32")
            out = P.fluid.layers.fc(x, D_OUT, act=None)
    return main, startup, out


def _save_model(dirname, w_scale=1.0, poison_nan=False):
    """The JAX package saves the served model: both packages load it."""
    P = PKGS["jax"]
    main, startup, out = _build_net(P)
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


def _expected(xv, w_scale=1.0):
    return w_scale * (xv.sum(axis=1, keepdims=True) + 1.0) * np.ones((1, D_OUT), "f4")


def _server(P, tmp, name="m", buckets=(2, 4), w_scale=1.0, **kw):
    d = _save_model(str(tmp / f"model_{name}_{w_scale}"), w_scale)
    reg = P.serving.ModelRegistry(place=P.fluid.CPUPlace())
    srv = P.serving.Server(reg, buckets=buckets, **kw)
    srv.load_model(name, d, warm=kw.get("start", True))
    return srv, d


_TIMED = ("lat_p50_ms", "lat_p99_ms", "queue_wait_frac")


def _observe(P, srv=None, **extra):
    """What a case saw, without times or version ids (each package numbers
    its versions from its own process-wide count)."""
    obs = {"counters": {k: v for k, v in P.mon.counter_values().items()
                        if k.startswith("serving.") and v},
           "events": [(r["action"], r.get("model")) for r in P.mon.step_records()
                      if r.get("kind") == "serving_event"],
           "traces": [(t["outcome"], t.get("reason"), tuple(s["name"] for s in t["spans"]))
                      for t in P.mon.request_traces()]}
    if srv is not None:
        stats = {k: v for k, v in srv.stats().items() if k not in _TIMED}
        stats["models"] = {n: {"bytes": _param_bytes(srv.registry.acquire(n)),
                               "precision": m["precision"], "n_versions": len(m["versions"])}
                           for n, m in stats["models"].items()}
        if P.name == "torch":  # the port's ledger counts the parameters only
            for n, m in srv.registry.models().items():
                assert m["bytes"] == stats["models"][n]["bytes"]
        obs["stats"] = stats
        obs["ledger"] = srv.ledger()
    obs.update(extra)
    return obs


def _param_bytes(version):
    """The bytes of a version's persistables (the JAX package's ledger also
    counts the 8-byte PRNG key a run before the version was made leaves in
    its scope, as the publisher's smoke does)."""
    return sum(int(version.scope.find_var(v.name).nbytes)
               for v in version.program.list_vars() if v.persistable)


def _same(a, b, path="obs"):
    """Equal observations, arrays within float32 rounding."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                   rtol=1e-5, atol=1e-6, err_msg=path)
        return
    if isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
        return
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
        return
    if isinstance(a, float) and isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-6, abs=1e-9), (path, a, b)
        return
    assert a == b, (path, a, b)


def _both(case, tmp_path, **kw):
    """Run `case(P, tmp)` in each package, its monitor fresh, and hold the
    two observations equal; returns them."""
    got = {}
    for P in PKGS.values():
        P.monitor.reset()
        tmp = tmp_path / P.name
        tmp.mkdir()
        got[P.name] = case(P, tmp, **kw)
    _same(got["torch"], got["jax"])
    return got


# --------------------------------------------------------------------------
# the bucket policy (pure)
# --------------------------------------------------------------------------

def test_bucket_policy_in_both_packages():
    for P in PKGS.values():
        s = P.serving
        assert s.parse_buckets("8, 2,4,2") == (2, 4, 8)
        assert s.parse_buckets([4, 1]) == (1, 4)
        assert s.bucket_for(3, (2, 4, 8)) == 4 and s.bucket_for(4, (2, 4, 8)) == 4
        with pytest.raises(P.ServingError) as ei:
            s.bucket_for(9, (2, 4, 8))
        assert ei.value.reason == "oversize"
        assert s.parse_buckets() == (1, 2, 4, 8, 16, 32)
        feeds = {"x": np.arange(6, dtype="f4").reshape(3, 2)}
        padded = s.pad_feeds(feeds, 8)
        assert padded["x"].shape == (8, 2) and np.array_equal(padded["x"][3], feeds["x"][0])
        out = np.arange(16, dtype="f4").reshape(8, 2)
        parts = s.split_rows([out, np.float32(7.0)], [(0, 2), (2, 3)], 8)
        assert np.array_equal(parts[0][0], out[0:2]) and np.array_equal(parts[1][0], out[2:3])
        assert parts[0][1] == parts[1][1] == np.float32(7.0)


def test_serving_error_is_classified_in_both():
    for P in PKGS.values():
        e = P.ServingError("shed", reason="overload", model="m")
        assert P.fluid.errors.classify(e) is e
        assert e.phase == "serving" and isinstance(e, RuntimeError)
        assert "reason=overload" in str(e) and "model=m" in str(e)


def test_exports_match_the_jax_package_but_the_fleet():
    """The fleet's names (Router, ServingFleet) are exported too now: the
    port's serving exports are the JAX package's."""
    assert sorted(set(jfluid.serving.__all__) - set(tfluid.serving.__all__)) == []
    assert {"Router", "ServingFleet"} <= set(tfluid.serving.__all__)
    for name in tfluid.serving.__all__:
        assert hasattr(tfluid.serving, name), name


# --------------------------------------------------------------------------
# serving basics
# --------------------------------------------------------------------------

def _case_padding_parity(P, tmp):
    srv, _ = _server(P, tmp, buckets=(4,))
    outs = []
    try:
        rng = np.random.RandomState(0)
        for rows in (1, 3, 2, 4):
            xv = rng.rand(rows, D_IN).astype("f4")
            (out,) = srv.infer("m", {"x": xv})
            assert out.shape == (rows, D_OUT)
            np.testing.assert_allclose(out, _expected(xv), rtol=1e-5)
            outs.append(out)
    finally:
        srv.stop()
    return _observe(P, srv, outs=outs)


def test_serve_padding_parity(tmp_path, mon):
    _both(_case_padding_parity, tmp_path)


def _case_novel_size(P, tmp):
    srv, _ = _server(P, tmp, buckets=(2, 4))
    try:
        miss0 = P.monitor.counter("executor.cache_miss").value
        rng = np.random.RandomState(1)
        outs = [srv.infer("m", {"x": rng.rand(rows, D_IN).astype("f4")})[0]
                for rows in (3, 1, 2, 4, 3, 1)]
    finally:
        srv.stop()
    # read once stop() has joined the workers: every batch has run
    assert P.monitor.counter("executor.cache_miss").value == miss0
    return _observe(P, srv, outs=outs)


def test_novel_size_serves_from_padded_bucket_with_no_new_plan(tmp_path, mon):
    _both(_case_novel_size, tmp_path)


def _case_coalescing(P, tmp):
    srv, _ = _server(P, tmp, buckets=(8,), start=False)
    srv.registry.warm("m", (8,))
    futs = [srv.submit("m", {"x": np.full((2, D_IN), i, "f4")}) for i in range(3)]
    srv.start()
    outs = [f.result(timeout=30)[0] for f in futs]
    srv.stop()
    assert srv.stats()["batches"] == 1 and srv.stats()["rows"] == 6
    return _observe(P, srv, outs=outs, occupancy=srv.bucket_attribution()[8]["occupancy"])


def test_batch_coalescing_occupancy(tmp_path, mon):
    _both(_case_coalescing, tmp_path)


# --------------------------------------------------------------------------
# admission control and deadlines
# --------------------------------------------------------------------------

def _case_shed(P, tmp):
    srv, _ = _server(P, tmp, buckets=(2, 4), max_queue=3, start=False)
    srv.registry.warm("m", (2, 4))
    xv = np.ones((1, D_IN), "f4")
    admitted = [srv.submit("m", {"x": xv}) for _ in range(3)]
    reasons = []
    for _ in range(4):
        with pytest.raises(P.ServingError) as ei:
            srv.submit("m", {"x": xv})
        reasons.append(ei.value.reason)
    assert srv.stats()["shed"] == 4
    srv.start()
    outs = [f.result(timeout=30)[0] for f in admitted]
    srv.stop()
    assert srv.stats()["completed"] == 3 and srv.stats()["requests"] == 7
    return _observe(P, srv, outs=outs, reasons=reasons)


def test_admission_shed_exact(tmp_path, mon):
    got = _both(_case_shed, tmp_path)
    assert got["torch"]["reasons"] == ["overload"] * 4
    assert got["torch"]["counters"]["serving.shed"] == 4
    assert [a for a, _ in got["torch"]["events"]].count("shed") == 4


def _case_deadline(P, tmp):
    srv, _ = _server(P, tmp, buckets=(2,), start=False)
    srv.registry.warm("m", (2,))
    xv = np.ones((1, D_IN), "f4")
    doomed = srv.submit("m", {"x": xv}, deadline_ms=5)
    alive = srv.submit("m", {"x": xv})
    time.sleep(0.08)
    srv.start()
    with pytest.raises(P.ServingError) as ei:
        doomed.result(timeout=30)
    (out,) = alive.result(timeout=30)
    srv.stop()
    return _observe(P, srv, outs=[out], reason=ei.value.reason)


def test_deadline_expired_classified_batch_proceeds(tmp_path, mon):
    got = _both(_case_deadline, tmp_path)
    assert got["torch"]["reason"] == "timeout" and got["torch"]["stats"]["timeouts"] == 1


def _case_door(P, tmp):
    srv, _ = _server(P, tmp, buckets=(2, 4), start=False)
    srv.registry.warm("m", (2, 4))
    xv = np.ones((1, D_IN), "f4")
    good = srv.submit("m", {"x": xv})
    reasons = []
    for bad in ({"wrong": xv}, {"x": xv, "extra": xv}, {"x": np.ones((1, D_IN + 1), "f4")},
                {"x": np.float32(1.0)}, {"x": np.ones((5, D_IN), "f4")}):
        with pytest.raises(P.ServingError) as ei:
            srv.submit("m", bad)
        reasons.append(ei.value.reason)
    with pytest.raises(P.ServingError) as ei:
        srv.submit("nope", {"x": xv})
    reasons.append(ei.value.reason)
    srv.start()
    (out,) = good.result(timeout=30)
    srv.stop()
    assert srv.stats()["errors"] == 0
    return _observe(P, srv, outs=[out], reasons=reasons)


def test_oversize_and_bad_requests_fail_alone_at_the_door(tmp_path, mon):
    got = _both(_case_door, tmp_path)
    assert got["torch"]["reasons"] == ["bad_request"] * 4 + ["oversize", "model_missing"]
    assert got["torch"]["stats"]["rejected"] == 6


# --------------------------------------------------------------------------
# verified hot reload
# --------------------------------------------------------------------------

def _case_publish_rollback(P, tmp):
    srv, _ = _server(P, tmp, buckets=(2,))
    try:
        v2 = _save_model(str(tmp / "v2"), w_scale=2.0)
        xv = np.ones((1, D_IN), "f4")
        outs = [srv.infer("m", {"x": xv})[0]]
        srv.publish("m", v2)
        outs.append(srv.infer("m", {"x": xv})[0])
        srv.rollback("m")
        outs.append(srv.infer("m", {"x": xv})[0])
        for out, s in zip(outs, (1.0, 2.0, 1.0)):
            np.testing.assert_allclose(out, _expected(xv, s), rtol=1e-5)
    finally:
        srv.stop()
    return _observe(P, srv, outs=outs)


def test_publish_swaps_weights_and_rollback(tmp_path, mon):
    got = _both(_case_publish_rollback, tmp_path)
    assert got["torch"]["counters"]["serving.reloads"] == 1
    assert got["torch"]["counters"]["serving.rollbacks"] == 1


def _truncate_shard(d):
    victim = next(f for f in sorted(os.listdir(d)) if f.endswith(".npy"))
    p = os.path.join(d, victim)
    with open(p, "rb") as f:
        payload = f.read()
    with open(p, "wb") as f:
        f.write(payload[: len(payload) // 2])


def _tear_manifest(d):
    with open(os.path.join(d, "__manifest__.json"), "w") as f:
        f.write('{"vars": [{"name": "tor')


def _io_hook(P, marker, eno):
    def hook(op, path):
        if marker in path:
            raise OSError(eno, "store fault", path)

    P.io.set_io_fault_hook(hook)


REJECTIONS = ("truncated_shard", "bad_manifest", "nan_weight", "golden_drift",
              "transient_io", "persistent_io", "terminal_io")


def _case_rejection(P, tmp, which):
    srv, _ = _server(P, tmp, buckets=(2,))
    xv = np.ones((1, D_IN), "f4")
    detail = None
    try:
        before = srv.infer("m", {"x": xv})[0]
        bad = _save_model(str(tmp / f"bad_{which}"), w_scale=2.0,
                          poison_nan=which == "nan_weight")
        kw = {}
        if which == "truncated_shard":
            _truncate_shard(bad)
        elif which == "bad_manifest":
            _tear_manifest(bad)
        elif which == "golden_drift":
            kw = dict(golden_feeds={"x": xv}, golden_expect=[_expected(xv, 1.0)])
        if which == "transient_io":
            inj = P.fluid.FaultInjector(f"eio@0:*bad_{which}*").arm_io()
            try:
                srv.publish("m", bad)
            finally:
                inj.disarm_io()
            outcome = "published"
        else:
            if which in ("persistent_io", "terminal_io"):
                _io_hook(P, f"bad_{which}", errno.EIO if which == "persistent_io"
                         else errno.EACCES)
            try:
                with pytest.raises(P.ServingError) as ei:
                    srv.publish("m", bad, **kw)
            finally:
                P.io.set_io_fault_hook(None)
            outcome = ei.value.reason
            detail = str(ei.value)
            np.testing.assert_array_equal(srv.infer("m", {"x": xv})[0], before)
        quarantined = os.path.realpath(bad) in srv.registry.quarantined
        marker = os.path.exists(os.path.join(bad, P.serving.QUARANTINE_MARKER))
        after = srv.infer("m", {"x": xv})[0]
        if outcome == "publish_rejected":
            with pytest.raises(P.ServingError) as ei:  # a repeat rejects fast
                srv.publish("m", bad)
            assert "quarantined" in str(ei.value)
        elif outcome == "publish_io":
            srv.publish("m", bad)  # the store settled: the same source publishes
        after2 = srv.infer("m", {"x": xv})[0]
    finally:
        srv.stop()
    return _observe(P, srv, outcome=outcome, quarantined=quarantined, marker=marker,
                    outs=[before, after, after2], names_the_rung=detail is None or any(
                        w in detail for w in ("digest", "non-finite", "drifted", "store I/O")))


@pytest.mark.parametrize("which", REJECTIONS)
def test_publish_rejection_rungs(tmp_path, mon, which):
    """Each rung of the ladder: content defects reject and quarantine with
    the old version serving bit for bit; store I/O retries (transient) or
    fails classified as publish_io, never quarantined."""
    got = _both(_case_rejection, tmp_path, which=which)["torch"]
    if which in ("transient_io", "persistent_io", "terminal_io"):
        assert not got["quarantined"] and not got["marker"]
        assert got["outcome"] == ("published" if which == "transient_io" else "publish_io")
        if which == "transient_io":
            assert got["counters"]["serving.publish_retries"] == 1
        elif which == "persistent_io":
            assert got["counters"]["serving.publish_retries"] == \
                tfluid.serving.publisher.PUBLISH_IO_ATTEMPTS - 1
        else:
            assert "serving.publish_retries" not in got["counters"]
    else:
        assert got["outcome"] == "publish_rejected"
        assert got["quarantined"] and got["marker"] and got["names_the_rung"]
        assert got["counters"]["serving.publish_rejected"] == 2


def _case_checkpoint_publish(P, tmp):
    srv, _ = _server(P, tmp, buckets=(2,))
    xv = np.ones((1, D_IN), "f4")
    try:
        main, startup, _ = _build_net(P)
        exe = P.fluid.Executor(P.fluid.CPUPlace())
        scope = P.fluid.Scope()
        exe.run(startup, scope=scope)
        for v in main.list_vars():
            if v.persistable:
                scope.set_var(v.name, np.full(np.asarray(scope.find_var(v.name)).shape, 3.0, "f4"))
        kw = {} if P.name == "jax" else {"place": P.fluid.CPUPlace()}
        cm = P.fluid.CheckpointManager(str(tmp / "ckpts"), program=main, scope=scope, **kw)
        cm.save(step=7)
        srv.publish("m", cm)
        outs = [srv.infer("m", {"x": xv})[0]]
        np.testing.assert_allclose(outs[0], _expected(xv, 3.0), rtol=1e-5)
        torn = str(tmp / "ckpts" / "ckpt-0000000009")
        shutil.copytree(cm.latest(), torn)
        os.remove(os.path.join(torn, "COMMITTED"))
        with open(os.path.join(torn, "DIST"), "w") as f:
            f.write("2")
        with pytest.raises(P.ServingError) as ei:
            srv.publish("m", torn)
        assert ei.value.reason == "publish_rejected" and "COMMITTED" in str(ei.value)
        outs.append(srv.infer("m", {"x": xv})[0])
    finally:
        srv.stop()
    return _observe(P, srv, outs=outs)


def test_publish_from_committed_checkpoint(tmp_path, mon):
    """A CheckpointManager's committed checkpoint (each package's own)
    publishes weights-only; a torn distributed one is rejected."""
    _both(_case_checkpoint_publish, tmp_path)


def _case_reload_under_load(P, tmp):
    srv, _ = _server(P, tmp, buckets=(1, 2, 4), max_queue=10_000)
    v2 = _save_model(str(tmp / "v2"), w_scale=2.0)
    n_per, n_clients = 40, 3
    errors, done = [], [0]
    lock = threading.Lock()

    def client(seed):
        rng = np.random.RandomState(seed)
        for _ in range(n_per):
            xv = rng.rand(int(rng.randint(1, 4)), D_IN).astype("f4")
            try:
                (out,) = srv.infer("m", {"x": xv})
                if not (np.allclose(out, _expected(xv, 1.0), rtol=1e-4)
                        or np.allclose(out, _expected(xv, 2.0), rtol=1e-4)):
                    raise AssertionError("output matches neither version")
                with lock:
                    done[0] += 1
            except Exception as e:  # noqa: BLE001 - held below
                with lock:
                    errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    srv.publish("m", v2)
    srv.rollback("m")
    for t in threads:
        t.join()
    srv.stop()
    assert not errors, errors[:3]
    s = srv.stats()
    assert s["completed"] == done[0] == n_per * n_clients and s["shed"] == 0
    obs = _observe(P, srv)
    # how the traffic fell into batches depends on the threads' timing
    return {"ledger": obs["ledger"], "events": obs["events"],
            "counters": {k: obs["counters"].get(k) for k in (
                "serving.requests", "serving.completed", "serving.shed", "serving.errors",
                "serving.reloads", "serving.rollbacks")}}


def test_reload_under_load_zero_dropped(tmp_path, mon):
    _both(_case_reload_under_load, tmp_path)


def _case_staging(P, tmp):
    srv, _ = _server(P, tmp, buckets=(2,))
    xv = np.ones((1, D_IN), "f4")
    try:
        v2 = _save_model(str(tmp / "v2"), w_scale=2.0)
        v3 = _save_model(str(tmp / "v3"), w_scale=3.0)
        staged = srv.publish("m", v2, stage_only=True)
        assert srv.registry.staged("m") is staged
        outs = [srv.infer("m", {"x": xv})[0]]  # still the old version
        assert srv.registry.discard_staged("m") and srv.registry.staged("m") is None
        srv.publish("m", v3, stage_only=True)
        srv.registry.activate_staged("m")
        outs.append(srv.infer("m", {"x": xv})[0])
        with pytest.raises(P.ServingError) as ei:
            srv.registry.activate_staged("m")
        srv.rollback("m")
        outs.append(srv.infer("m", {"x": xv})[0])
        for out, s in zip(outs, (1.0, 3.0, 1.0)):
            np.testing.assert_allclose(out, _expected(xv, s), rtol=1e-5)
    finally:
        srv.stop()
    return _observe(P, srv, outs=outs, reason=ei.value.reason)


def test_staging_api(tmp_path, mon):
    got = _both(_case_staging, tmp_path)["torch"]
    assert [a for a, _ in got["events"]] == [
        "load", "stage", "publish_staged", "discard_staged", "stage", "publish_staged",
        "activate_staged", "rollback"]


def _case_quarantine_marker(P, tmp):
    srv, _ = _server(P, tmp, buckets=(2,))
    try:
        bad = _save_model(str(tmp / "bad"), w_scale=2.0, poison_nan=True)
        with pytest.raises(P.ServingError):
            srv.publish("m", bad)
    finally:
        srv.stop()
    mark = P.serving.quarantine_marker(bad)
    # another server (its own registry, nothing in memory) rejects fast on
    # the persisted marker
    srv2, _ = _server(P, tmp, name="m2", buckets=(2,))
    try:
        with pytest.raises(P.ServingError) as ei:
            srv2.publish("m2", bad)
    finally:
        srv2.stop()
    return _observe(P, srv2, marker_model=mark["model"], marker_detail=mark["detail"],
                    second=("persisted quarantine marker" in str(ei.value), ei.value.reason))


def test_quarantine_marker(tmp_path, mon):
    got = _both(_case_quarantine_marker, tmp_path)["torch"]
    assert got["second"] == (True, "publish_rejected") and "non-finite" in got["marker_detail"]


# --------------------------------------------------------------------------
# several models under a budget, aliasing, clones
# --------------------------------------------------------------------------

def _case_budget_eviction(P, tmp):
    d1 = _save_model(str(tmp / "m1"), 1.0)
    d2 = _save_model(str(tmp / "m2"), 2.0)
    reg = P.serving.ModelRegistry(place=P.fluid.CPUPlace(),
                                  hbm_budget_mb=P.serving.manifest_weight_bytes(d1) / 1e6 * 1.5)
    reg.load("m1", d1)
    reg.load("m2", d2)
    assert sorted(reg.models()) == ["m2"]
    with pytest.raises(P.ServingError) as ei:
        reg.acquire("m1")
    tiny = P.serving.ModelRegistry(
        place=P.fluid.CPUPlace(), hbm_budget_mb=P.serving.manifest_weight_bytes(d1) / 1e6 * 0.5)
    with pytest.raises(P.ServingError) as ei2:
        tiny.load("m1", d1)
    assert tiny.models() == {}
    return _observe(P, reasons=[ei.value.reason, ei2.value.reason], used=reg.used_bytes(),
                    plan=P.serving.plan_model_bytes(d1, 4),
                    manifest=P.serving.manifest_weight_bytes(d1))


def test_hbm_budget_evicts_cold_model_and_refuses_when_nothing_evictable(tmp_path, mon):
    got = _both(_case_budget_eviction, tmp_path)["torch"]
    assert got["reasons"] == ["model_missing", "hbm_budget"]
    assert got["counters"]["serving.evictions"] == 1
    assert ("evict", "m1") in got["events"]
    assert got["plan"] > got["manifest"] > 0  # the plan adds activations and feeds


def _case_alias(P, tmp):
    d = _save_model(str(tmp / "m"), 1.0)
    reg = P.serving.ModelRegistry(place=P.fluid.CPUPlace())
    reg.load("a", d, warm_buckets=(2,))
    miss0 = P.monitor.counter("executor.cache_miss").value
    reg.load("b", d, warm_buckets=(2,))
    assert P.monitor.counter("executor.cache_miss").value == miss0
    assert reg.acquire("a") is reg.acquire("b")
    assert reg.used_bytes() == reg.acquire("a").bytes
    return _observe(P, used=reg.used_bytes())


def test_registry_alias_shares_version_and_plans(tmp_path, mon):
    _both(_case_alias, tmp_path)


def _case_clones(P, tmp):
    d = _save_model(str(tmp / "m"), 1.0)
    p = P.fluid.inference.Predictor(P.fluid.inference.AnalysisConfig(d, P.fluid.CPUPlace()))
    p.run({"x": np.ones((4, D_IN), "f4")})
    miss0 = P.monitor.counter("executor.cache_miss").value
    clones = [p.clone() for _ in range(4)]
    assert all(c.exe is p.exe for c in clones)
    errors = []

    def run_clone(c, seed):
        try:
            rng = np.random.RandomState(seed)
            for _ in range(5):
                xv = rng.rand(4, D_IN).astype("f4")
                np.testing.assert_allclose(c.run({"x": xv})[0], _expected(xv), rtol=1e-4)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def hammer(seed):  # one predictor shared: dict API and a locked zero-copy transaction
        rng = np.random.RandomState(seed)
        try:
            for _ in range(10):
                xv = rng.rand(2, D_IN).astype("f4")
                if seed % 2:
                    (out,) = p.run({"x": xv})
                else:
                    with p.lock():
                        p.get_input_handle("x").copy_from_cpu(xv)
                        p.run_zero_copy()
                        out = p.get_output_handle(p.get_output_names()[0]).copy_to_cpu()
                np.testing.assert_allclose(out, _expected(xv), rtol=1e-4)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = ([threading.Thread(target=run_clone, args=(c, i)) for i, c in enumerate(clones)]
               + [threading.Thread(target=hammer, args=(i,)) for i in range(4)])
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:3]
    return {"new_batch_shapes": P.monitor.counter("executor.cache_miss").value - miss0,
            "lock": (p.lock().name, p.lock().rank, p.lock().reentrant)}


def test_concurrent_clones_share_one_plan(tmp_path, mon):
    got = _both(_case_clones, tmp_path)["torch"]
    assert got["new_batch_shapes"] == 1  # the hammers' batch of 2
    assert got["lock"] == ("inference.predictor", 20, True)


# --------------------------------------------------------------------------
# worker survival and shutdown
# --------------------------------------------------------------------------

def _case_postprocessing_crash(P, tmp, monkeypatch):
    srv, _ = _server(P, tmp, buckets=(2,))
    try:
        real_split = P.server_mod._bk.split_rows
        blown = []

        def bomb(*a, **k):
            if not blown:
                blown.append(1)
                raise OSError("disk full")
            return real_split(*a, **k)

        monkeypatch.setattr(P.server_mod._bk, "split_rows", bomb)
        xv = np.ones((1, D_IN), "f4")
        with pytest.raises(OSError):
            srv.infer("m", {"x": xv})
        (out,) = srv.infer("m", {"x": xv})
        np.testing.assert_allclose(out, _expected(xv), rtol=1e-5)
    finally:
        srv.stop()
    assert srv.stats()["errors"] == 1
    return _observe(P, srv, outs=[out])


def test_worker_survives_postprocessing_crash(tmp_path, mon, monkeypatch):
    _both(_case_postprocessing_crash, tmp_path, monkeypatch=monkeypatch)


def _case_shutdown(P, tmp):
    srv, _ = _server(P, tmp, buckets=(2,), start=False)
    srv.registry.warm("m", (2,))
    futs = [srv.submit("m", {"x": np.ones((1, D_IN), "f4")}) for _ in range(2)]
    srv.stop(drain=False)
    reasons = []
    for f in futs:
        with pytest.raises(P.ServingError) as ei:
            f.result(timeout=5)
        reasons.append(ei.value.reason)
    return _observe(P, srv, reasons=reasons)


def test_shutdown_leftovers_enter_the_ledger(tmp_path, mon):
    got = _both(_case_shutdown, tmp_path)["torch"]
    assert got["reasons"] == ["shutdown"] * 2 and got["ledger"]["shutdowns"] == 2
    assert got["ledger"]["balanced"]


# --------------------------------------------------------------------------
# the port's own: releasing plans, quantized dirs
# --------------------------------------------------------------------------

def _plans_of(exe, scope):
    return [k for k in exe._cache if k[4] == scope._uuid]


def test_dropping_a_version_releases_its_plans_and_weights(tmp_path, mon):
    """After `unload`, after an eviction and after a version trimmed past
    keep_versions, the executor holds no plan of the released scope, and a
    weak reference to one of its weight tensors is dead after gc.collect()."""
    d1 = _save_model(str(tmp_path / "m1"), 1.0)
    d2 = _save_model(str(tmp_path / "m2"), 2.0)
    reg = tfluid.serving.ModelRegistry(place=tfluid.CPUPlace())
    exe = reg.executor

    def loaded(name, d, registry=reg):
        v = registry.load(name, d, warm_buckets=(2, 4))
        v.run({"x": np.ones((2, D_IN), "f4")})
        scope = v.scope
        assert len(_plans_of(exe, scope)) == 2
        ref = weakref.ref(scope.find_var("fc_0.w_0"))
        return scope, ref

    # unload
    scope, ref = loaded("m1", d1)
    reg.unload("m1")
    assert _plans_of(exe, scope) == []
    del scope
    gc.collect()
    assert ref() is None
    # eviction under a budget of one model
    budget = tfluid.serving.ModelRegistry(
        place=tfluid.CPUPlace(), executor=exe,
        hbm_budget_mb=tfluid.serving.plan_model_bytes(d1, 4) / 1e6 * 1.2)
    scope, ref = loaded("m1", d1, budget)
    budget.load("m2", d2, warm_buckets=(2, 4))
    assert sorted(budget.models()) == ["m2"] and _plans_of(exe, scope) == []
    del scope
    gc.collect()
    assert ref() is None
    # a version trimmed past keep_versions=1 by a publish
    reg1 = tfluid.serving.ModelRegistry(place=tfluid.CPUPlace(), executor=exe, keep_versions=1)
    scope, ref = loaded("m", d1, reg1)
    tfluid.serving.publish(reg1, "m", d2, warm_buckets=(2,))
    assert _plans_of(exe, scope) == []
    del scope
    gc.collect()
    assert ref() is None
    assert tfluid.monitor.counter("executor.plans_released").value == 6


def test_a_batch_in_flight_keeps_its_plan_until_it_ends(tmp_path):
    """A version released while one of its runs is in flight releases its
    plans when that run ends, not before."""
    d = _save_model(str(tmp_path / "m"), 1.0)
    reg = tfluid.serving.ModelRegistry(place=tfluid.CPUPlace())
    version = reg.load("m", d, warm_buckets=(2,))
    entered, release = threading.Event(), threading.Event()
    real_run = version.predictor.run

    def slow_run(feeds, fetch_names=None):
        out = real_run(feeds, fetch_names=fetch_names)
        entered.set()
        release.wait(10)
        return out

    version.predictor.run = slow_run  # the load's thread (this one) serves from it
    seen = []

    def unloader():
        entered.wait(10)
        reg.unload("m")
        seen.append(len(_plans_of(reg.executor, version.scope)))  # still running on it
        release.set()

    t = threading.Thread(target=unloader)
    t.start()
    version.run({"x": np.ones((2, D_IN), "f4")})
    t.join()
    assert seen == [1]
    assert _plans_of(reg.executor, version.scope) == []


def test_a_batch_holds_its_version_from_the_moment_it_takes_it(tmp_path, mon, monkeypatch):
    """A version unloaded after a batch took it but before the batch runs
    (here: while the batch is built) keeps its plans until the batch ends:
    the batch runs on the warmed plan and builds none, and the plans go
    when it ends."""
    d = _save_model(str(tmp_path / "m"), 1.0)
    reg = tfluid.serving.ModelRegistry(place=tfluid.CPUPlace())
    srv = tfluid.serving.Server(reg, buckets=(2,), workers=1)
    version = srv.load_model("m", d)
    real_build = tfluid.serving.batcher.build_batch
    seen = []

    def build_after_unload(*a, **k):
        reg.unload("m")
        seen.append(len(_plans_of(reg.executor, version.scope)))
        return real_build(*a, **k)

    monkeypatch.setattr(tfluid.serving.batcher, "build_batch", build_after_unload)
    misses = tfluid.monitor.counter("executor.cache_miss").value
    xv = np.ones((1, D_IN), "f4")
    try:
        (out,) = srv.infer("m", {"x": xv})
    finally:
        srv.stop()
    np.testing.assert_allclose(out, _expected(xv), rtol=1e-5)
    assert seen == [1]
    assert tfluid.monitor.counter("executor.cache_miss").value == misses
    assert _plans_of(reg.executor, version.scope) == []


# --------------------------------------------------------------------------
# quantized (int8) model directories: load, the quant-parity rung
# --------------------------------------------------------------------------

def _save_quant_model(dirname, w_scale=1.0, serve_dtype="bfloat16", weight_bits=8):
    """The quantized twin of _save_model, saved by the JAX package: the same
    weights, int8 payloads on disk, dequantized into `serve_dtype` at load."""
    main, startup, out = _build_net(PKGS["jax"])
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    startup.random_seed = 3
    exe.run(startup, scope=scope)
    for v in main.list_vars():
        if v.persistable:
            scope.set_var(v.name, np.full(np.asarray(scope.find_var(v.name)).shape, w_scale,
                                          dtype="float32"))
    jfluid.io.save_quantized_inference_model(dirname, ["x"], [out], exe, main, scope,
                                             weight_bits=weight_bits, serve_dtype=serve_dtype)
    return dirname


def _quant_events(P):
    return [{k: r.get(k) for k in ("model", "max_abs_diff", "atol")}
            for r in P.mon.step_records()
            if r.get("kind") == "serving_event" and r.get("action") == "quant_parity"]


def _case_quant_load(P, tmp):
    quant = _save_quant_model(str(tmp / "quant"))
    srv = P.serving.Server(P.serving.ModelRegistry(place=P.fluid.CPUPlace()), buckets=(2,))
    try:
        srv.load_model("q", quant)
        xv = np.random.RandomState(3).rand(2, D_IN).astype("f4")
        (out,) = srv.infer("q", {"x": xv})
        version = srv.registry.acquire("q")
        dtypes = sorted({str(np.asarray(P.fluid.core.dtypes.to_numpy(version.scope.find_var(
            v.name)) if P.name == "torch" else version.scope.find_var(v.name)).dtype)
            for v in version.program.list_vars() if v.persistable})
        load = [r for r in P.mon.step_records()
                if r.get("kind") == "serving_event" and r.get("action") == "load"]
        info = srv.registry.models()["q"]
    finally:
        srv.stop()
    return _observe(P, srv, out=out, dtypes=dtypes, load_precision=load[-1]["precision"],
                    precision=info["precision"])


def test_quantized_dir_loads_with_the_jax_packages_precision_and_bytes(tmp_path, mon):
    """A quantized dir (int8 payloads, bf16 serve dtype) loads in the port:
    the same precision on models() and on the load event, the same
    persistables' bytes (bf16 weights) and the same responses."""
    got = _both(_case_quant_load, tmp_path)["torch"]
    assert got["precision"] == got["load_precision"] == "int8->bfloat16"
    assert got["dtypes"] == ["bfloat16", "float32"]  # the weight; the bias is not quantized
    assert got["stats"]["models"]["q"]["bytes"] == 2 * D_IN * D_OUT + 4 * D_OUT


def _case_quant_publish(P, tmp):
    srv, _ = _server(P, tmp, buckets=(2,))
    try:
        fp32 = srv.registry.models()["m"]
        qd = _save_quant_model(str(tmp / "quant_ok"))
        xv = np.ones((1, D_IN), "f4")
        before = srv.infer("m", {"x": xv})[0]
        srv.publish("m", qd)
        info = srv.registry.models()["m"]
        after = srv.infer("m", {"x": xv})[0]
        pub = [r for r in P.mon.step_records()
               if r.get("kind") == "serving_event" and r.get("action") == "publish"]
    finally:
        srv.stop()
    return _observe(P, srv, before=before, after=after, parity=_quant_events(P),
                    precision=(fp32["precision"], info["precision"], pub[-1]["precision"]),
                    narrower=info["bytes"] < fp32["bytes"])


def test_quant_publish_passes_the_parity_rung_as_in_the_jax_package(tmp_path, mon):
    """An int8 snapshot of the served weights publishes through the ladder:
    one quant_parity event with the same max_abs_diff and atol in both
    packages, the precision on models() and the publish event, half the
    weight bytes, the same outputs."""
    got = _both(_case_quant_publish, tmp_path)["torch"]
    assert got["precision"] == ("float32", "int8->bfloat16", "int8->bfloat16")
    assert got["narrower"]
    assert len(got["parity"]) == 1 and got["parity"][0]["model"] == "m"
    assert got["parity"][0]["max_abs_diff"] <= got["parity"][0]["atol"] == 5e-2
    np.testing.assert_allclose(got["after"], got["before"], rtol=1e-5)


def _case_quant_drift(P, tmp):
    srv, _ = _server(P, tmp, buckets=(2,))
    xv = np.ones((1, D_IN), "f4")
    try:
        before = srv.infer("m", {"x": xv})[0]
        bad = _save_quant_model(str(tmp / "quant_drift"))
        qpath = os.path.join(bad, P.io.QUANT_MANIFEST)
        with open(qpath) as f:
            qman = json.load(f)
        for rec in qman["weights"].values():
            rec["scale"] = (np.asarray(rec["scale"], "f4") * 37.0).tolist()
        with open(qpath, "w") as f:
            json.dump(qman, f)
        with pytest.raises(P.ServingError) as ei:
            srv.publish("m", bad)
        first = (ei.value.reason, "quant parity" in str(ei.value))
        marker = P.serving.quarantine_marker(bad)
        after = srv.infer("m", {"x": xv})[0]
        with pytest.raises(P.ServingError) as ei:  # a repeat rejects fast
            srv.publish("m", bad)
        second = (ei.value.reason, "quarantined" in str(ei.value))
        quarantined = os.path.realpath(bad) in srv.registry.quarantined
    finally:
        srv.stop()
    np.testing.assert_array_equal(after, before)
    return _observe(P, srv, first=first, second=second, quarantined=quarantined,
                    marker="quant parity" in marker["detail"], parity=_quant_events(P),
                    outs=[before, after])


def test_drifted_quant_snapshot_is_rejected_and_quarantined(tmp_path, mon):
    """Scales multiplied by 37 dequantize to finite, wrong weights: the
    parity rung rejects and quarantines the snapshot, the float version
    serves on bit for bit, and a repeat publish rejects fast, in both
    packages."""
    got = _both(_case_quant_drift, tmp_path)["torch"]
    assert got["first"] == ("publish_rejected", True)
    assert got["second"] == ("publish_rejected", True)
    assert got["quarantined"] and got["marker"] and got["parity"] == []
    assert got["counters"]["serving.publish_rejected"] == 2


def test_plan_and_manifest_bytes_equal_in_both(tmp_path):
    d = _save_model(str(tmp_path / "m"))
    q = _save_quant_model(str(tmp_path / "q"))
    for model in (d, q):
        for rows in (1, 4, 32):
            assert tfluid.serving.plan_model_bytes(model, rows) == \
                jfluid.serving.plan_model_bytes(model, rows)
        assert tfluid.serving.manifest_weight_bytes(model) == \
            jfluid.serving.manifest_weight_bytes(model)
    # a quantized dir is priced at its bf16 serve dtype: below its float twin
    assert tfluid.serving.manifest_weight_bytes(q) < tfluid.serving.manifest_weight_bytes(d)
    assert tfluid.serving.plan_model_bytes(q, 8) < tfluid.serving.plan_model_bytes(d, 8)
    j = json.load(open(os.path.join(d, "__model__.json")))
    tprog = tfluid.Program.from_dict(j)
    jprog = jfluid.Program.from_dict(j)
    shapes = {"x": (4, D_IN)}
    assert tfluid.serving.synthetic_feeds(tprog, ["x"], 4)["x"].tolist() == \
        jfluid.serving.synthetic_feeds(jprog, ["x"], 4)["x"].tolist()
    assert tfluid.serving.registry.synthetic_feed_shapes(tprog, ["x"], 4) == shapes

"""The serving fleet (paddle_tpu_torch.serving.ServingFleet, Router,
replica_main; paddle_tpu_torch.dist_resilience; paddle_tpu_torch.launch
--serve) against the JAX package's on the CPU.

Every case of tests/test_serving_fleet.py that reaches ported code runs
here in both packages, on its one-fc model saved by the JAX package (weights
all `s`, so it serves s * (sum(x) + 1)) with its FLEET_KW; the port's
replicas serve on `CPUPlace()`, and every replica gets OMP_NUM_THREADS=1.
The in-process units (the beat / health status machine, the router's
policy, the roll's reconcile pass, the staging API, the quarantine marker)
return what they saw and the two packages must agree exactly.  The
multi-process cases (SIGTERM racing boot, kill under load, the roll halting
on a NaN snapshot and on persistent EIO, SIGTERM drain, roll resume) hold
each package to the same responses (`_expected`, and each other within
1e-6), to the same invariants (ledger balance, error reasons, event
sequence, active versions), and never compare a count that depends on
timing.  Every wait is on an event, a beat status or a process exit, each
with its own deadline, and every fleet is stopped in a `finally`.
`tools/serve_trace.py --fleet --check` and `tools/perf_report.py --check
... --check-roll-convergence` run as commands over the port fleet's own
telemetry.  Besides: `python -m paddle_tpu_torch.launch --serve --device
cpu` serves and drains on SIGTERM, and a replica whose fleet names the card
exits non-zero where there is none.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

from test_serving import D_IN, _expected, _save_model

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "tools"))
import perf_report  # noqa: E402
import serve_trace  # noqa: E402

FLEET_KW = dict(buckets=(2, 4), hb_interval_s=0.15, miss_factor=4.0)
REPLICA_ENV = {"OMP_NUM_THREADS": "1"}
BOOT_S = 50.0  # a replica's boot, imports included; each wait has its own deadline


def _pkg(fluid, name, **fleet_kw):
    import importlib

    return SimpleNamespace(
        name=name, fluid=fluid, serving=fluid.serving, monitor=fluid.monitor,
        ServingError=fluid.errors.ServingError,
        dist=importlib.import_module(f"{fluid.__name__}.dist_resilience"),
        router=importlib.import_module(f"{fluid.__name__}.serving.router"),
        publisher=importlib.import_module(f"{fluid.__name__}.serving.publisher"),
        fleet_kw=fleet_kw)


PKGS = {"jax": _pkg(jfluid, "jax"),
        "torch": _pkg(tfluid, "torch", place=tfluid.CPUPlace())}


@pytest.fixture
def mon():
    for P in PKGS.values():
        P.monitor.reset()
        P.monitor.enable()
    yield
    for P in PKGS.values():
        P.monitor.disable()
        P.monitor.reset()


def _both(case, *args):
    return {name: case(P, *args) for name, P in PKGS.items()}


def _fleet(P, models, root, **kw):
    extra = dict(REPLICA_ENV, **kw.pop("extra_env", {}))
    return P.serving.ServingFleet(models, root=str(root), extra_env=extra,
                                  **{**FLEET_KW, **P.fleet_kw, **kw})


def _wait(cond, what, timeout):
    """Poll `cond()` until it is truthy (returned) or `timeout` passes."""
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"waited {timeout}s for {what}")
        time.sleep(0.02)


def _router_events(fleet, action=None):
    path = os.path.join(fleet.root, "telemetry", "router.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    evs = [r for r in recs if r.get("kind") == "fleet_event"]
    return [e for e in evs if e.get("action") == action] if action else evs


def _wait_event(fleet, action, timeout=30.0):
    return _wait(lambda: _router_events(fleet, action),
                 f"a {action!r} fleet_event (have "
                 f"{[e['action'] for e in _router_events(fleet)]})", timeout)


def _same_responses(got, rtol=1e-6):
    """The two packages' responses to the same requests agree."""
    for key in set(got["jax"]) & set(got["torch"]):
        np.testing.assert_allclose(got["torch"][key], got["jax"][key], rtol=rtol, atol=1e-6)


def _tools_pass(root):
    """The fleet's telemetry reconciles and its health / roll gates hold."""
    router_log = os.path.join(root, "telemetry", "router.jsonl")
    return (serve_trace.fleet_check(root),
            perf_report.check(router_log, min_healthy_replicas=2, check_roll_convergence=True))


# --------------------------------------------------------------------------
# in-process units
# --------------------------------------------------------------------------

def _case_beat_health(P, tmp):
    hb = str(tmp / f"hb_{P.name}")
    os.makedirs(hb)
    payload = {"q": 1, "draining": False, "port": 7}
    seen = []
    beat = P.dist.ReplicaBeat(hb, 0, 2, interval_s=0.05,
                              payload_fn=lambda: dict(payload)).start()
    health = P.dist.FleetHealth(hb, 2, interval_s=0.05, miss_factor=4.0, startup_grace_s=2.0)
    try:
        table = health.poll()  # start() wrote beat 1 before returning
        seen.append([table[0]["status"], table[0]["tel"], table[1]["status"],
                     health.dispatchable()])
        payload["draining"] = True
        beat.beat_now()
        _wait(lambda: health.poll()[0]["status"] == "draining", "draining", 10)
        seen.append([health.dispatchable(), health.alive()])
    finally:
        beat.stop(mark_down=True)
    seen.append(health.poll()[0]["status"])  # the tombstone: dead at once
    # grace expiry kills the never-seen rank
    _wait(lambda: health.poll()[1]["status"] == "dead", "rank 1 dead", 10)
    seen.append([i["status"] for i in health.poll().values()])
    # a restart clears the corpse's files: fresh grace, fresh seq space
    health.note_restart(0)
    seen.append(health.poll()[0]["status"])
    beat2 = P.dist.ReplicaBeat(hb, 0, 2, interval_s=0.05,
                               payload_fn=lambda: dict(payload)).start()
    try:
        status = _wait(lambda: health.poll()[0]["status"] != "booting" and
                       health.poll()[0]["status"], "rank 0 observed again", 10)
        seen.append(status)
    finally:
        beat2.stop()
    return seen


def test_replica_beat_and_fleet_health_status_machine(tmp_path):
    got = _both(_case_beat_health, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"] == [["alive", {"q": 1, "draining": False, "port": 7}, "booting", [0]],
                            [[], [0]], "dead", ["dead", "dead"], "booting", "draining"]


def test_a_corpses_beat_read_before_its_restart_does_not_register(tmp_path):
    """A poll that read the killed incarnation's beat file just before the
    supervisor's note_restart removed it must not put that beat back:
    the port's FleetHealth drops a read older than the rank's restart
    (chip_smoke phase 63 found the race: the corpse's port looked alive,
    the restarted replica was not listening yet).  The JAX package's
    poll registers it (ROADMAP C)."""
    hb = str(tmp_path / "hb")
    os.makedirs(hb)
    beat = tfluid.dist_resilience.ReplicaBeat(hb, 0, 1, interval_s=60.0,
                                              payload_fn=lambda: {"port": 7, "pid": 1}).start()
    beat.stop()
    health = tfluid.dist_resilience.FleetHealth(hb, 1, interval_s=0.05, startup_grace_s=5.0)
    assert health.poll()[0]["status"] == "alive"
    read = health.transport.poll

    def read_then_restart():
        got = read()  # the corpse's beat, read before ...
        health.note_restart(0)  # ... the supervisor restarts the rank
        return got

    health.transport.poll = read_then_restart
    assert health.poll()[0]["status"] == "booting"
    health.transport.poll = read
    assert health.poll()[0] == {"rank": 0, "seq": None, "age_s": None, "status": "booting",
                                "tel": None}


class _FakeHealth:
    def __init__(self, table):
        self.table = table
        self.world = len(table)

    def poll(self):
        return {r: dict(info) for r, info in self.table.items()}


ALIVE = {"status": "alive", "seq": 5, "age_s": 0.0, "tel": {"port": 1, "q": 0, "p99": 1.0}}


def _refusal(P, fn):
    try:
        fn()
    except P.ServingError as e:
        return e.reason
    return "no refusal"


def _ledger(router):
    s = router.stats()
    s.pop("ts")
    return s


def _case_dispatch_policy(P):
    R = P.router.Router
    x = {"x": np.ones((1, D_IN), "f4")}
    seen = []
    r = R(_FakeHealth({0: {**ALIVE, "status": "dead", "tel": None}}))
    seen.append(_refusal(P, lambda: r.infer("m", x)))  # no live replica
    seen.append(_ledger(r))
    r = R(_FakeHealth({0: {**ALIVE, "status": "draining"}}))
    seen.append(_refusal(P, lambda: r.infer("m", x)))  # draining takes no new traffic
    r = R(_FakeHealth({0: dict(ALIVE)}), inflight_cap=1)
    with r._lock:
        r._inflight[0] = 1
    seen.append(_refusal(P, lambda: r.infer("m", x)))  # at the cap: backpressure
    r = R(_FakeHealth({0: dict(ALIVE)}))
    r._mark_suspect(0, 5)
    seen.append(_refusal(P, lambda: r.infer("m", x)))  # suspect until the seq moves
    r.health.table[0]["seq"] = 6
    seen.append(r._pick(r.health.poll()))
    seen.append(_ledger(r))
    seen.append(r.inflight())
    return seen


def test_router_dispatch_policy_classified(mon):
    got = _both(_case_dispatch_policy)
    assert got["torch"] == got["jax"]
    assert got["torch"][:5:2] == ["replica_down", "replica_down", "replica_down"]
    assert got["torch"][3] == "overload"
    led = got["torch"][6]
    assert led["requests"] == led["completed"] + led["errors"]


def _case_least_loaded(P):
    def info(port, q, p99):
        return {"status": "alive", "seq": 3, "age_s": 0.0, "tel": {"port": port, "q": q, "p99": p99}}

    r = P.router.Router(_FakeHealth({0: info(1, 5, 9.0), 1: info(2, 0, 1.0)}))
    first = r._pick(r.health.poll())["rank"]  # shallower queue wins
    with r._lock:
        r._inflight[1] = 3  # router-side inflight outranks the beat telemetry
    return [first, r._pick(r.health.poll())["rank"], r.inflight()]


def test_router_least_loaded_pick():
    got = _both(_case_least_loaded)
    assert got["torch"] == got["jax"] == [1, 0, {0: 1, 1: 3}]


def _case_suspicion(P):
    R = P.router.Router
    alive = {**ALIVE, "seq": 1}
    seen = []
    r = R(_FakeHealth({0: dict(alive)}))
    r._mark_suspect(0, 50_000)  # a long-lived incarnation died at seq 50000
    seen.append(r._pick(r.health.poll())["rank"])  # fresh seq below it: forgiven
    with r._lock:
        seen.append(0 in r._suspect)
    r = R(_FakeHealth({0: dict(alive)}))
    r._mark_suspect(0, 50_000)
    r.note_restart(0)  # the supervisor clears it on relaunch
    seen.append(r._pick(r.health.poll())["rank"])
    r = R(_FakeHealth({0: {**alive, "seq": 7}}))
    r._mark_suspect(0, 7)  # stuck AT the suspicion point: still suspect
    seen.append(_refusal(P, lambda: r._pick(r.health.poll())))
    return seen


def test_router_suspicion_clears_on_replica_restart(mon):
    got = _both(_case_suspicion)
    assert got["torch"] == got["jax"] == [0, False, 0, "replica_down"]


def _case_reconcile(P, tmp):
    fleet = _fleet(P, {"m": "/old"}, tmp / f"fleet_{P.name}", n_replicas=2, start=False)
    active = {0: "/new", 1: "/old"}  # rank 1 acked, died, rebooted on last good
    staged = {0: False, 1: False}
    ops = []

    def fake_rpc(rank, msg, recover_timeout=60.0):
        op = msg["op"]
        ops.append((rank, op))
        if op == "active_src":
            return {"ok": True, "src": active[rank], "version": 1}
        if op == "stage":
            staged[rank] = True
            return {"ok": True, "version": 2, "src": msg["src"]}
        if op == "activate":
            if not staged[rank]:
                return {"ok": False, "reason": "model_missing", "error": "nothing staged"}
            active[rank] = "/new"
            staged[rank] = False
            return {"ok": True, "version": 2}
        raise AssertionError(f"unexpected op {op!r}")

    fleet._control_rpc = fake_rpc
    roll = {"model": "m", "src": "/new", "ctl": "roll-t", "phase": "activate",
            "verified": [0, 1], "acked": [0, 1], "last_good": "/old"}
    fleet._reconcile_acked(roll, recover_timeout=1.0)
    return [active, ops, [(e["action"], e["rank"], e["version"])
                          for e in _router_events(fleet, "replica_reactivated")]]


def test_roll_reconciles_replica_that_died_after_acking(tmp_path, mon):
    got = _both(_case_reconcile, tmp_path)
    assert got["torch"] == got["jax"]
    active, ops, events = got["torch"]
    assert active == {0: "/new", 1: "/new"}
    assert (1, "stage") in ops and (1, "activate") in ops and (0, "stage") not in ops
    assert events == [("replica_reactivated", 1, 2)]


def _case_staging(P, v1, v2):
    reg = P.serving.ModelRegistry(place=P.fluid.CPUPlace())
    reg.load("m", v1)
    seen = [_refusal(P, lambda: reg.activate_staged("m"))]  # nothing staged
    ver = P.serving.publish(reg, "m", v2, stage_only=True, warm_buckets=(2,))
    seen += [reg.staged("m") is ver, reg.models()["m"]["src"]]
    reg.activate_staged("m")
    seen += [reg.models()["m"]["src"], reg.staged("m")]
    P.serving.publish(reg, "m", v1, stage_only=True, warm_buckets=(2,))
    seen += [reg.discard_staged("m"), reg.discard_staged("m"), reg.models()["m"]["src"]]
    return seen


def test_registry_staging_api(tmp_path, mon):
    v1 = _save_model(str(tmp_path / "v1"), 1.0)
    v2 = _save_model(str(tmp_path / "v2"), 2.0)
    got = _both(_case_staging, v1, v2)
    assert got["torch"] == got["jax"] == [
        "model_missing", True, v1, v2, None, True, False, v2]


def _case_quarantine(P, tmp):
    v1 = _save_model(str(tmp / f"q_v1_{P.name}"), 1.0)
    bad = _save_model(str(tmp / f"q_bad_{P.name}"), 2.0, poison_nan=True)
    seen = []
    reg_a = P.serving.ModelRegistry(place=P.fluid.CPUPlace())
    reg_a.load("m", v1)
    seen.append(_refusal(P, lambda: P.serving.publish(reg_a, "m", bad, warm_buckets=(2,))))
    mk = P.serving.quarantine_marker(bad)
    seen += [mk is not None and mk["model"] == "m" and bool(mk["detail"]),
             os.path.exists(os.path.join(bad, P.serving.QUARANTINE_MARKER))]
    # a fresh registry (another replica process in fleet terms) refuses the
    # marked snapshot on the persisted marker, without running the ladder
    reg_b = P.serving.ModelRegistry(place=P.fluid.CPUPlace())
    reg_b.load("m", v1)
    try:
        P.serving.publish(reg_b, "m", bad, warm_buckets=(2,))
        seen.append("published")
    except P.ServingError as e:
        seen += [e.reason, "persisted quarantine marker" in str(e)]
    seen.append(reg_b.models()["m"]["src"] == v1)
    return seen


def test_quarantine_marker_persists_fleet_wide(tmp_path, mon):
    got = _both(_case_quarantine, tmp_path)
    assert got["torch"] == got["jax"] == [
        "publish_rejected", True, True, "publish_rejected", True, True]


# --------------------------------------------------------------------------
# multi-process
# --------------------------------------------------------------------------

def _case_sigterm_racing_boot(P, tmp):
    v1 = _save_model(str(tmp / f"rb_v1_{P.name}"), 1.0)
    fleet = _fleet(P, {"m": v1}, tmp / f"rb_fleet_{P.name}", n_replicas=2)
    try:
        victim = fleet._replicas[1]["proc"]
        victim.send_signal(signal.SIGTERM)  # at once: mid-import or mid-boot
        rc = victim.wait(timeout=BOOT_S)
        _wait_event(fleet, "replica_retired")
        seen = [rc in (0, -signal.SIGTERM), fleet._replicas[1]["retired"],
                fleet._replicas[1]["proc"] is victim,
                bool(_router_events(fleet, "replica_restarted"))]
        fleet.wait_healthy(min_replicas=1, timeout=BOOT_S)
        xv = np.ones((2, D_IN), "f4")
        (out,) = fleet.infer("m", {"x": xv})
        np.testing.assert_allclose(out, _expected(xv, 1.0), rtol=1e-5)
    finally:
        fleet.stop()
    return seen, {"out": out}


def test_sigterm_racing_boot_retires_instead_of_restarting(tmp_path, mon):
    got = _both(_case_sigterm_racing_boot, tmp_path)
    assert got["torch"][0] == got["jax"][0] == [True, True, True, False]
    _same_responses({k: v[1] for k, v in got.items()})


def _case_kill_under_load(P, tmp):
    v1 = _save_model(str(tmp / f"kl_v1_{P.name}"), 1.0)
    fleet = _fleet(P, {"m": v1}, tmp / f"kl_fleet_{P.name}", n_replicas=2, max_restarts=2)
    responses, errs, lock = {}, [], threading.Lock()
    try:
        fleet.wait_healthy(timeout=BOOT_S)

        def load(client):
            rng = np.random.RandomState(client)
            for i in range(40):
                xv = rng.rand(2, D_IN).astype("f4")
                try:
                    (out,) = fleet.infer("m", {"x": xv})
                    np.testing.assert_allclose(out, _expected(xv), rtol=1e-5)
                    with lock:
                        responses[(client, i)] = out
                except P.ServingError as e:
                    with lock:
                        errs.append(e.reason)
                time.sleep(0.01)

        threads = [threading.Thread(target=load, args=(c,)) for c in range(3)]
        for t in threads:
            t.start()
        _wait(lambda: fleet.stats()["completed"] >= 10, "traffic before the kill", 30)
        with fleet._lock:
            victim = fleet._replicas[0]["proc"]
        victim.send_signal(signal.SIGKILL)
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        s = fleet.stats()
        seen = [all(r == "replica_down" for r in errs),
                len(errs) <= fleet.router.inflight_cap + 1,
                s["requests"] == s["completed"] + s["errors"],
                s["completed"] == len(responses) and s["errors"] == len(errs),
                s["routed"].get(1, 0) > 0]
        _wait_event(fleet, "replica_dead")
        _wait_event(fleet, "replica_restarted")
        fleet.wait_healthy(timeout=BOOT_S)
        xv = np.ones((2, D_IN), "f4")
        (responses["after_restart"],) = fleet.infer("m", {"x": xv})
        np.testing.assert_allclose(responses["after_restart"], _expected(xv), rtol=1e-5)
        seen.append([(e["action"], e["rank"]) for e in _router_events(fleet)
                     if e["action"] in ("replica_dead", "replica_restarted")][:2])
    finally:
        fleet.stop()
    seen.append(_tools_pass(fleet.root))
    return seen, responses


def test_fleet_kill_replica_under_load(tmp_path, mon):
    got = _both(_case_kill_under_load, tmp_path)
    assert got["torch"][0] == got["jax"][0] == [
        True, True, True, True, True,
        [("replica_dead", 0), ("replica_restarted", 0)], (0, 0)]
    _same_responses({k: v[1] for k, v in got.items()})


def _case_roll_halts(P, tmp):
    v1 = _save_model(str(tmp / f"rh_v1_{P.name}"), 1.0)
    bad_rot = _save_model(str(tmp / f"rh_rot_{P.name}"), 3.0, poison_nan=True)
    bad_eio = _save_model(str(tmp / f"rh_eio_{P.name}"), 4.0)
    v2 = _save_model(str(tmp / f"rh_v2_{P.name}"), 2.0)
    # rank 1's reads of the eio snapshot fail persistently: each entry
    # fires on its Nth matching op, and each failed attempt aborts after one
    # matching read, so indices 0..N cover every retry the publish allows
    eio_spec = ";".join(f"eio@{i}:*rh_eio_{P.name}*"
                        for i in range(P.publisher.PUBLISH_IO_ATTEMPTS + 3))
    fleet = _fleet(P, {"m": v1}, tmp / f"rh_fleet_{P.name}", n_replicas=2,
                   per_rank_env={1: {"FLAGS_fault_spec": eio_spec}})
    seen, responses = [], {}
    xv = np.random.RandomState(5).rand(2, D_IN).astype("f4")
    try:
        fleet.wait_healthy(timeout=BOOT_S)
        # rotted content: halted on the NaN rung at the first replica
        with pytest.raises(P.ServingError) as ei:
            fleet.rolling_publish("m", bad_rot)
        seen += [ei.value.reason, ei.value.__cause__.reason,
                 os.path.exists(os.path.join(bad_rot, P.serving.QUARANTINE_MARKER))]
        # a fresh rank 0 (empty in-memory quarantine set) fast-rejects on
        # the persisted marker
        with fleet._lock:
            victim = fleet._replicas[0]["proc"]
        victim.send_signal(signal.SIGKILL)
        _wait_event(fleet, "replica_restarted")
        fleet.wait_healthy(timeout=BOOT_S)
        with pytest.raises(P.ServingError) as ei:
            fleet.rolling_publish("m", bad_rot)
        seen += [ei.value.reason, "persisted quarantine marker" in str(ei.value.__cause__)]
        # persistent EIO on rank 1: halts after rank 0 staged; converging
        # back discards rank 0's staged slot
        with pytest.raises(P.ServingError) as ei:
            fleet.rolling_publish("m", bad_eio)
        seen += [ei.value.reason, ei.value.__cause__.reason]
        actives = fleet.active_versions("m")
        seen.append(sorted((r, a["src"] == v1) for r, a in actives.items()))
        for i in range(6):  # zero requests ever served by a bad version
            (responses[f"v1_{i}"],) = fleet.infer("m", {"x": xv})
            np.testing.assert_allclose(responses[f"v1_{i}"], _expected(xv), rtol=1e-5)
        fleet.rolling_publish("m", v2)  # a clean roll still goes through
        (responses["v2"],) = fleet.infer("m", {"x": xv})
        np.testing.assert_allclose(responses["v2"], _expected(xv, 2.0), rtol=1e-5)
        seen.append(sorted((r, a["src"] == v2) for r, a in fleet.active_versions("m").items()))
        with open(os.path.join(fleet.root, "ACTIVE.json")) as f:
            seen.append(json.load(f)["models"]["m"]["src"] == v2)
        seen.append([e["action"] for e in _router_events(fleet) if e["action"].startswith("roll_")])
    finally:
        fleet.stop()
    seen.append(_tools_pass(fleet.root))
    return seen, responses


ROLL_EPISODES = ["roll_started", "roll_halted", "roll_rolled_back"] * 3 + [
    "roll_started", "roll_converged"]


def test_fleet_roll_halts_on_store_faults(tmp_path, mon):
    got = _both(_case_roll_halts, tmp_path)
    assert got["torch"][0] == got["jax"][0] == [
        "roll_halted", "publish_rejected", True,
        "roll_halted", True,
        "roll_halted", "publish_io",
        [(0, True), (1, True)], [(0, True), (1, True)], True, ROLL_EPISODES, (0, 0)]
    _same_responses({k: v[1] for k, v in got.items()})


def _drain(fleet, victim, rank, timeout=60.0):
    """SIGTERM a replica, again each second while its beat still says alive,
    until it exits; returns its exit code.  The JAX package's replica waits
    for the signal's handler without a timeout, so a SIGTERM that one of
    its side threads takes is acted on only at a later signal (ROADMAP C,
    the reference's timing flake); the port's replica acts on the first
    (`test_replica_acts_on_a_sigterm_that_a_side_thread_takes`)."""
    deadline = time.monotonic() + timeout
    sent = None
    while victim.poll() is None:
        assert time.monotonic() < deadline, f"replica {rank} did not drain in {timeout}s"
        if sent is None or (time.monotonic() - sent > 1.0
                            and fleet.health.poll()[rank]["status"] == "alive"):
            victim.send_signal(signal.SIGTERM)
            sent = time.monotonic()
        time.sleep(0.02)
    return victim.returncode


def _case_sigterm_drain(P, tmp):
    v1 = _save_model(str(tmp / f"sd_v1_{P.name}"), 1.0)
    fleet = _fleet(P, {"m": v1}, tmp / f"sd_fleet_{P.name}", n_replicas=2)
    failures, done, responses, lock = [], threading.Event(), {}, threading.Lock()
    try:
        fleet.wait_healthy(timeout=BOOT_S)

        def load(client):
            rng = np.random.RandomState(client)
            i = 0
            while not done.is_set():
                xv = rng.rand(2, D_IN).astype("f4")
                try:
                    (out,) = fleet.infer("m", {"x": xv})
                    np.testing.assert_allclose(out, _expected(xv), rtol=1e-5)
                    with lock:
                        responses[(client, i)] = out
                except P.ServingError as e:
                    failures.append(e.reason)
                i += 1
                time.sleep(0.01)

        threads = [threading.Thread(target=load, args=(c,)) for c in range(2)]
        for t in threads:
            t.start()
        _wait(lambda: fleet.stats()["completed"] >= 10, "traffic before the drain", 30)
        with fleet._lock:
            victim = fleet._replicas[0]["proc"]
        rc = _drain(fleet, victim, 0)
        after = fleet.stats()["completed"]  # more load on the shrunk fleet
        _wait(lambda: fleet.stats()["completed"] >= after + 10, "traffic after the drain", 30)
        done.set()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        s = fleet.stats()
        _wait_event(fleet, "replica_retired")
        seen = [rc, failures, s["requests"] == s["completed"], s["errors"],
                bool(_router_events(fleet, "replica_restarted"))]
    finally:
        done.set()
        fleet.stop()
    # the drained replica's own final on-disk ledger: nothing shed or dropped
    counters = {}
    for dirpath, _, names in os.walk(os.path.join(fleet.root, "telemetry")):
        if "metrics.p0.jsonl" in names:
            with open(os.path.join(dirpath, "metrics.p0.jsonl")) as f:
                for ln in f:
                    rec = json.loads(ln)
                    if rec.get("kind") == "snapshot":
                        counters = rec.get("counters", {})
    seen += [counters.get("serving.shed", 0), counters.get("serving.shutdowns", 0),
             counters.get("serving.completed", 0) > 0, serve_trace.fleet_check(fleet.root)]
    return seen, responses


def test_fleet_sigterm_drains_without_shedding(tmp_path, mon):
    got = _both(_case_sigterm_drain, tmp_path)
    assert got["torch"][0] == got["jax"][0] == [0, [], True, 0, False, 0, 0, True, 0]
    _same_responses({k: v[1] for k, v in got.items()})


def _case_roll_resume(P, tmp):
    v1 = _save_model(str(tmp / f"rr_v1_{P.name}"), 1.0)
    v2 = _save_model(str(tmp / f"rr_v2_{P.name}"), 2.0)
    fleet = _fleet(P, {"m": v1}, tmp / f"rr_fleet_{P.name}", n_replicas=1)
    try:
        fleet.wait_healthy(timeout=BOOT_S)
        # the stage phase ran, then the supervisor "crashed" before activate
        reply = fleet._control_rpc(0, {"op": "stage", "model": "m", "src": v2})
        fleet._persist_roll({"model": "m", "src": v2, "ctl": "roll-x", "phase": "activate",
                             "verified": [0], "acked": [], "last_good": v1})
        roll = fleet.resume_roll()
        xv = np.ones((2, D_IN), "f4")
        (out,) = fleet.infer("m", {"x": xv})
        np.testing.assert_allclose(out, _expected(xv, 2.0), rtol=1e-5)
        with open(os.path.join(fleet.root, "ACTIVE.json")) as f:
            active = json.load(f)["models"]["m"]["src"]
        seen = [reply.get("ok"), roll["phase"], roll["acked"], active == v2,
                [e["action"] for e in _router_events(fleet) if e["action"].startswith("roll")],
                fleet.resume_roll()]
    finally:
        fleet.stop()
    return seen, {"out": out}


def test_fleet_roll_resumes_from_persisted_state(tmp_path, mon):
    got = _both(_case_roll_resume, tmp_path)
    assert got["torch"][0] == got["jax"][0] == [
        True, "done", [0], True, ["roll_resumed", "roll_converged"], None]
    _same_responses({k: v[1] for k, v in got.items()})


def test_fleet_tools_pass_over_the_port_fleets_telemetry(tmp_path, mon):
    """The repository's stdlib-only tools, as commands, over a port fleet's
    telemetry after traffic, a halted roll and a converged one."""
    P = PKGS["torch"]
    v1 = _save_model(str(tmp_path / "t_v1"), 1.0)
    v2 = _save_model(str(tmp_path / "t_v2"), 2.0)
    bad = _save_model(str(tmp_path / "t_bad"), 3.0, poison_nan=True)
    fleet = _fleet(P, {"m": v1}, tmp_path / "t_fleet", n_replicas=2)
    try:
        fleet.wait_healthy(timeout=BOOT_S)
        xv = np.ones((2, D_IN), "f4")
        for _ in range(4):
            fleet.infer("m", {"x": xv})
        with pytest.raises(P.ServingError):
            fleet.rolling_publish("m", bad)
        fleet.rolling_publish("m", v2)
        (out,) = fleet.infer("m", {"x": xv})
        np.testing.assert_allclose(out, _expected(xv, 2.0), rtol=1e-5)
    finally:
        fleet.stop()
    for cmd in (["serve_trace.py", "--fleet", "--check", fleet.root],
                ["perf_report.py", "--check", os.path.join(fleet.root, "telemetry", "router.jsonl"),
                 "--min-healthy-replicas", "2", "--check-roll-convergence"]):
        r = subprocess.run([sys.executable, os.path.join(ROOT, "tools", cmd[0]), *cmd[1:]],
                           capture_output=True, text=True, timeout=60)
        assert r.returncode == 0, (cmd, r.stdout[-2000:], r.stderr[-2000:])
    # a router log whose halted roll never converged fails the gate
    broken = str(tmp_path / "broken.jsonl")
    with open(os.path.join(fleet.root, "telemetry", "router.jsonl")) as f, open(broken, "w") as g:
        g.writelines(ln for ln in f if '"roll_rolled_back"' not in ln)
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "perf_report.py"), "--check",
                        broken, "--check-roll-convergence"], capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 1, r.stdout[-2000:]


def test_launch_serve_on_the_cpu_serves_then_drains_on_sigterm(tmp_path):
    v1 = _save_model(str(tmp_path / "cli_v1"), 1.0)
    root = str(tmp_path / "cli_fleet")
    env = dict(os.environ, PYTHONPATH=ROOT, **REPLICA_ENV)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.launch", "--serve", "--device", "cpu",
         "--model", f"m={v1}", "--nproc", "2", "--fleet-root", root, "--buckets", "2,4",
         "--hb-interval", "0.15"], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        health = tfluid.dist_resilience.FleetHealth(os.path.join(root, "hb"), 2, interval_s=0.15,
                                                    miss_factor=4.0)

        def listening():
            table = health.poll()
            return all(i["status"] == "alive" and (i["tel"] or {}).get("port")
                       for i in table.values()) and table

        table = _wait(listening, "both replicas of the command's fleet listening", BOOT_S)
        xv = np.random.RandomState(7).rand(3, D_IN).astype("f4")
        router = tfluid.serving.router
        for info in table.values():  # each replica answers on its own port
            reply = router.rpc(info["tel"]["port"], {
                "op": "infer", "model": "m", "feeds": router.encode_feeds({"x": xv})})
            assert reply["ok"], reply
            np.testing.assert_allclose(router.decode_arrays(reply["outputs"])[0], _expected(xv),
                                       rtol=1e-5)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-2000:]
    assert "drained" in err
    with open(os.path.join(root, "telemetry", "router.jsonl")) as f:
        actions = [json.loads(ln).get("action") for ln in f if '"fleet_event"' in ln]
    assert actions[0] == "fleet_started" and actions[-1] == "fleet_stopped"
    assert "replica_dead" not in actions and "replica_restarted" not in actions
    drained = []
    for dirpath, _, names in os.walk(os.path.join(root, "telemetry")):
        for n in names:
            if n.startswith("metrics.p"):
                with open(os.path.join(dirpath, n)) as f:
                    drained += [json.loads(ln)["rank"] for ln in f
                                if '"replica_drained"' in ln]
    assert sorted(drained) == [0, 1]


def test_replica_that_cannot_reach_its_card_exits_nonzero(tmp_path):
    """A fleet made without `place` serves on the card: its replica, on a
    machine where no card is visible, exits non-zero with the error in its
    log, and does not carry on on the CPU."""
    v1 = _save_model(str(tmp_path / "nc_v1"), 1.0)
    root = tmp_path / "nc_fleet"
    root.mkdir()
    (root / "fleet.json").write_text(json.dumps({
        "n_replicas": 1, "buckets": [2], "hb_interval_s": 0.15, "place": "cuda:0",
        "models": {"m": {"src": v1}}}))
    env = dict(os.environ, PYTHONPATH=ROOT, PADDLE_FLEET_DIR=str(root), PADDLE_TRAINER_ID="0",
               PADDLE_REPLICA_PORT=str(tfluid.launch.allocate_port_block(1)),
               CUDA_VISIBLE_DEVICES="", **REPLICA_ENV)
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.serving.replica_main"],
                       env=env, capture_output=True, text=True, timeout=BOOT_S)
    assert r.returncode not in (0, 41), r.stderr[-2000:]
    assert "no CUDA device" in r.stderr
    assert not (root / "hb" / "hb-0").exists()  # it never beat, so it never served


def test_replica_acts_on_a_sigterm_that_a_side_thread_takes():
    """A process-directed signal may land on any thread; CPython then runs
    the handler only when the main thread next executes bytecode.  The
    replica's wait for its drain wakes to let it (an untimed wait hangs)."""
    code = (
        "import signal, threading, time\n"
        "from paddle_tpu_torch.serving.replica_main import _wait_for_drain\n"
        "done = threading.Event()\n"
        "signal.signal(signal.SIGTERM, lambda *_: done.set())\n"
        "side = threading.Thread(target=time.sleep, args=(60,), daemon=True)\n"
        "side.start()\n"
        "signal.pthread_kill(side.ident, signal.SIGTERM)\n"
        "_wait_for_drain(done, 0.05)\n"
        "print('drained')\n")
    r = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=BOOT_S)
    assert r.returncode == 0 and r.stdout.strip() == "drained", r.stderr[-2000:]


def test_launch_without_serve_names_data_parallelism():
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        tfluid.launch.main(["--nproc", "2", "worker.py"])


def test_worker_env_is_the_ports():
    env = tfluid.launch.worker_env(1, ["127.0.0.1:5000", "127.0.0.1:5001"],
                                   extra={"PADDLE_X": "y"})
    assert not [k for k in env if k.startswith(("JAX_", "XLA_"))]
    assert env["PYTHONPATH"] == ROOT
    assert (env["PADDLE_TRAINER_ID"], env["PADDLE_CURRENT_ENDPOINT"], env["PADDLE_X"]) == (
        "1", "127.0.0.1:5001", "y")
    jenv = jfluid.launch.worker_env(1, ["127.0.0.1:5000", "127.0.0.1:5001"])
    assert {k: env[k] for k in env if k.startswith("PADDLE_TRAINER")} == {
        k: jenv[k] for k in jenv if k.startswith("PADDLE_TRAINER")}


def test_wire_encoding_matches_the_jax_package():
    import ml_dtypes

    arrays = [np.arange(6, dtype="int64").reshape(2, 3), np.linspace(0, 1, 4, dtype="f4"),
              np.asarray([1.5, -2.25], dtype=ml_dtypes.bfloat16)]
    jdoc = jfluid.serving.router.encode_arrays(arrays)
    tdoc = tfluid.serving.router.encode_arrays(arrays)
    assert json.dumps(tdoc) == json.dumps(jdoc)
    for a, b in zip(tfluid.serving.router.decode_arrays(json.loads(json.dumps(jdoc))), arrays):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.astype("f8"), b.astype("f8"))


@pytest.mark.parametrize("freed_after_s", [0.5, None])
def test_a_restarted_replica_retries_its_bind(freed_after_s):
    """A restarted replica whose port is still held (a TIME_WAIT of the
    router's connections where the ephemeral range covers the fleet's
    ports: chip_smoke phase 63, every restart "Address already in use")
    retries the bind until the port is free, or raises EADDRINUSE at its
    deadline."""
    import errno
    import socket

    from paddle_tpu_torch.serving import replica_main

    port = tfluid.launch.allocate_port_block(1)
    holder = socket.socket()
    holder.bind(("127.0.0.1", port))
    holder.listen()
    if freed_after_s is None:
        with pytest.raises(OSError) as ei:
            replica_main._listen(port, replica_main._make_handler({}), retry_s=1.0)
        holder.close()
        assert ei.value.errno == errno.EADDRINUSE
        return
    timer = threading.Timer(freed_after_s, holder.close)
    timer.start()
    t0 = time.monotonic()
    listener = replica_main._listen(port, replica_main._make_handler({}), retry_s=30.0)
    try:
        assert listener.server_address == ("127.0.0.1", port)
        assert freed_after_s <= time.monotonic() - t0 < 30.0
    finally:
        listener.server_close()
        timer.join(5)


@pytest.mark.parametrize("eph", [32768, 40000, None])
def test_a_replica_port_block_lies_below_the_ephemeral_range(monkeypatch, eph):
    """The port keeps a fleet's ports out of the kernel's ephemeral range
    (the JAX package draws them from [20000, 50000) whatever the range):
    while a replica restarts, the router's outgoing connections could take
    its port and keep its successor from binding it.  Without a readable
    range the block is drawn from [20000, 50000) as in the JAX package."""
    monkeypatch.setattr(tfluid.launch, "_ephemeral_low", lambda: eph)
    bases = [tfluid.launch.allocate_port_block(2) for _ in range(20)]
    assert all(20000 <= b and b + 2 <= (eph or 50000) for b in bases), bases

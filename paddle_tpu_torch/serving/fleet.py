"""Serving fleet supervisor: N replica processes, health-routed, rolled
(counterpart of paddle_tpu/serving/fleet.py).

`ServingFleet` supervises SERVING processes with the gang launcher's
machinery (heartbeat liveness, restart with a budget, per-incarnation
telemetry dirs) — where a gang restarts as a unit because training steps
are collective, a fleet restarts replicas INDEPENDENTLY because requests
are not:

  * each replica is one `serving.replica_main` process (full Server +
    publisher ladder + monitor plane) beating `ReplicaBeat` files under
    `<root>/hb/`, serving on the fleet's place: the card (`CUDAPlace(0)`;
    every replica has its own CUDA context on it, and their kernels
    time-slice) unless the fleet is made with `place=CPUPlace()`;
  * the supervisor watches `FleetHealth` + process exit codes: exit 0
    (a completed drain) or death BY SIGTERM (the drain signal caught a
    replica mid-boot, before its handler existed) is deliberate
    retirement — never restarted; anything else is a death — restarted
    with a fresh telemetry incarnation until the per-replica restart
    budget is spent;
  * traffic rides `serving.router.Router` over the same health table:
    a dead replica loses only its own in-flight requests (classified
    `reason="replica_down"`), new traffic redistributes within one
    heartbeat miss window (sooner when a connect fails — see router
    suspicion);
  * `rolling_publish` is the zero-downtime reload: phase one stages the
    new snapshot through every replica ONE AT A TIME — each runs the
    full verification ladder (torn-commit, digest, NaN, golden smoke,
    quant parity, bucket warm) via `publish(stage_only=True)` while its
    old version keeps serving; phase two activates replica by replica.
    A rung failure anywhere HALTS the roll and converges the fleet back
    on the last good version (staged slots discarded everywhere, zero
    requests ever served by the bad version).  No split-brain: the
    fleet-active pointer (`ACTIVE.json`, what a restarted replica boots
    from) moves only after EVERY replica acked the activate AND a final
    reconcile pass re-verified each ack against the replica's live
    active version (an acked replica that died and rebooted on last
    good is re-staged + re-activated, not trusted).  The roll
    itself is crash-safe: progress persists in `ROLL.json` (io.py
    atomic write) and a replica death mid-roll is waited out — the
    restarted replica boots on last good and is re-staged.

Fleet telemetry: the supervisor appends monitor-shaped records to
`<root>/telemetry/router.jsonl` — `fleet_event` records (replica_dead /
replica_restarted / roll_started / replica_staged / roll_halted /
roll_converged / roll_rolled_back / ...) plus periodic snapshots whose
gauges carry `serving.fleet.healthy_replicas` / `.size` /
`.roll_active` and whose counters mirror the router ledger.
`tools/serve_trace.py --fleet` merges this with the per-replica
`metrics.p<rank>.jsonl` streams; `tools/perf_report.py --check` gates
on the gauges and on roll convergence.
"""
from __future__ import annotations

__all__ = ["ServingFleet"]

import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from .. import io as _io
from ..core import locks
from ..errors import ServingError
from ..core.executor import CUDAPlace
from ..launch import REPO_ROOT, allocate_port_block, worker_env
from ..monitor import MONITOR as _MON
from ..dist_resilience import FleetHealth
from .router import ConnectFailed, Router, rpc
from .tracing import control_trace_id

_ROLL_FILE = "ROLL.json"
_ACTIVE_FILE = "ACTIVE.json"


class ServingFleet:
    """Supervised fleet of replica servers behind a health-aware router.

        fleet = ServingFleet({"m": "/models/m"}, n_replicas=2,
                             root="/tmp/fleet")
        fleet.wait_healthy()
        out = fleet.infer("m", {"x": batch})
        fleet.rolling_publish("m", "/models/m_v2")   # zero-downtime
        fleet.stop()
    """

    def __init__(self, models: Dict[str, str], n_replicas: int = 2,
                 root: Optional[str] = None, buckets=(1, 4, 8),
                 hb_interval_s: float = 0.3, miss_factor: float = 4.0,
                 startup_grace_s: float = 60.0, inflight_cap: int = 8,
                 max_restarts: int = 3, drain_grace_s: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 rpc_timeout_s: float = 60.0,
                 extra_env: Optional[Dict[str, str]] = None,
                 per_rank_env: Optional[Dict[int, Dict[str, str]]] = None,
                 start: bool = True, place=None):
        """`place`: where the replicas serve, `CUDAPlace(0)` when None
        (which raises here on a machine without a card); `CPUPlace()`
        serves on the CPU.  It is written into fleet.json for the
        replicas."""
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        place = CUDAPlace(0) if place is None else place
        self.models = dict(models)
        self.n = int(n_replicas)
        self.root = root or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), f"paddle_fleet_{os.getpid()}")
        self.hb_interval_s = float(hb_interval_s)
        self.max_restarts = int(max_restarts)
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.extra_env = dict(extra_env or {})
        self.per_rank_env = {int(r): dict(e)
                             for r, e in (per_rank_env or {}).items()}
        os.makedirs(os.path.join(self.root, "hb"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "telemetry"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "logs"), exist_ok=True)
        self._router_log = os.path.join(self.root, "telemetry",
                                        "router.jsonl")
        self.config = {
            "n_replicas": self.n, "buckets": list(buckets),
            "hb_interval_s": self.hb_interval_s,
            "models": {n: {"src": src} for n, src in self.models.items()},
            "place": str(place.device),
            "max_queue": max_queue,
            "default_deadline_ms": default_deadline_ms,
            "drain_grace_s": (drain_grace_s if drain_grace_s is not None
                              else 4 * self.hb_interval_s),
        }
        _io.atomic_write(os.path.join(self.root, "fleet.json"),
                         json.dumps(self.config, indent=1))
        self.health = FleetHealth(os.path.join(self.root, "hb"), self.n,
                                  interval_s=self.hb_interval_s,
                                  miss_factor=miss_factor,
                                  startup_grace_s=startup_grace_s)
        self.router = Router(self.health, inflight_cap=inflight_cap,
                             rpc_timeout_s=rpc_timeout_s)
        base = allocate_port_block(self.n)
        self._ports = [base + i for i in range(self.n)]
        # replica table; every blocking op (spawn, wait, rpc) runs OUTSIDE
        # this lock — it guards only the table itself
        self._lock = locks.named_lock("serving.fleet", rank=4)
        self._replicas: Dict[int, dict] = {}
        self._incarnation = 0
        self._stopping = False
        self._roll_active = False
        self._sup_thread: Optional[threading.Thread] = None
        self._sup_stop = threading.Event()
        if start:
            self.start()

    # -- telemetry ----------------------------------------------------------
    def _event(self, action: str, **fields):
        from ..monitor import record_fleet_event

        self._append_log(record_fleet_event(action, **fields))

    def _append_log(self, rec: dict):
        line = json.dumps(rec, default=str) + "\n"
        try:
            with _io.fault_exempt(self.root):
                with open(self._router_log, "a") as f:
                    f.write(line)
                    f.flush()
        except OSError:
            _MON.counter("serving.fleet.log_errors").inc()

    def _snapshot(self):
        """One monitor-shaped snapshot line: router ledger as counters,
        fleet liveness as gauges (what `perf_report --check` gates on)."""
        table = self.health.poll()
        healthy = sum(1 for i in table.values() if i["status"] == "alive")
        with self._lock:
            roll = self._roll_active
        led = self.router.stats()
        counters = {"serving.fleet.requests": led["requests"],
                    "serving.fleet.completed": led["completed"],
                    "serving.fleet.errors": led["errors"],
                    "serving.fleet.retries": led["retries"]}
        for reason, n in led["by_reason"].items():
            counters[f"serving.fleet.errors[{reason}]"] = n
        for rank, n in led["routed"].items():
            counters[f"serving.fleet.routed[{rank}]"] = n
        gauges = {"serving.fleet.healthy_replicas": float(healthy),
                  "serving.fleet.size": float(self.n),
                  "serving.fleet.roll_active": 1.0 if roll else 0.0}
        _MON.gauge("serving.fleet.healthy_replicas").set(float(healthy))
        _MON.gauge("serving.fleet.size").set(float(self.n))
        _MON.gauge("serving.fleet.roll_active").set(1.0 if roll else 0.0)
        self._append_log({"kind": "snapshot", "ts": time.time(),
                          "lane": -1, "lane_name": "router",
                          "counters": counters, "gauges": gauges,
                          "replicas": {r: i["status"]
                                       for r, i in table.items()}})

    # -- lifecycle ----------------------------------------------------------
    def _spawn(self, rank: int, restarts: int) -> dict:
        with self._lock:
            self._incarnation += 1
            inc = self._incarnation
        tel_dir = os.path.join(self.root, "telemetry", f"i{inc}")
        os.makedirs(tel_dir, exist_ok=True)
        endpoints = [f"127.0.0.1:{p}" for p in self._ports]
        env = worker_env(rank, endpoints, 1, extra={
            "PADDLE_FLEET_DIR": self.root,
            "PADDLE_REPLICA_PORT": str(self._ports[rank]),
            "PADDLE_TELEMETRY_DIR": tel_dir,
            "PADDLE_RESTART_NUM": str(restarts),
        })
        env.update(self.extra_env)
        env.update(self.per_rank_env.get(rank, {}))
        out = open(os.path.join(self.root, "logs",
                                f"replica{rank}.i{inc}.out"), "wb")
        err = open(os.path.join(self.root, "logs",
                                f"replica{rank}.i{inc}.err"), "wb")
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.replica_main"],
            env=env, cwd=REPO_ROOT, stdout=out, stderr=err)
        return {"proc": proc, "port": self._ports[rank],
                "restarts": restarts, "retired": False,
                "spool": (out, err), "incarnation": inc}

    def start(self) -> "ServingFleet":
        with self._lock:
            if self._replicas:
                return self
        for rank in range(self.n):
            rep = self._spawn(rank, 0)
            with self._lock:
                self._replicas[rank] = rep
        self._event("fleet_started", n_replicas=self.n,
                    ports=self._ports,
                    models={n: s for n, s in self.models.items()})
        self._sup_thread = threading.Thread(
            target=self._supervise, name="fleet-supervisor", daemon=True)
        self._sup_thread.start()
        return self

    def _supervise(self):
        """Watch exits + health; restart non-retired deaths within budget.
        Also the fleet's snapshot heartbeat."""
        while not self._sup_stop.wait(self.hb_interval_s):
            with self._lock:
                if self._stopping:
                    return
                table = dict(self._replicas)
            for rank, rep in table.items():
                rc = rep["proc"].poll()
                if rc is None or rep["retired"]:
                    continue
                self._close_spool(rep)
                if rc == 0 or rc == -signal.SIGTERM:
                    # deliberate drain: exit 0 is the replica announcing
                    # its own retirement; -SIGTERM means the drain signal
                    # landed before the replica's handler was even
                    # installed (interpreter/package import is the slow
                    # part of boot) — the INTENT was still retirement, and
                    # restarting would undo an operator's scale-down
                    with self._lock:
                        rep["retired"] = True
                    self._event("replica_retired", rank=rank, exit_code=rc)
                    continue
                _MON.counter("serving.fleet.replica_deaths").inc()
                self._event("replica_dead", rank=rank, exit_code=rc,
                            restarts=rep["restarts"])
                if rep["restarts"] >= self.max_restarts:
                    with self._lock:
                        rep["retired"] = True
                    self._event("replica_abandoned", rank=rank,
                                restarts=rep["restarts"])
                    continue
                self.health.note_restart(rank)
                # router suspicion was pinned to the DEAD incarnation's
                # beat seq; the fresh process counts from 1 and would
                # otherwise stay benched until it outran the corpse
                self.router.note_restart(rank)
                fresh = self._spawn(rank, rep["restarts"] + 1)
                with self._lock:
                    self._replicas[rank] = fresh
                self._event("replica_restarted", rank=rank,
                            restarts=fresh["restarts"],
                            incarnation=fresh["incarnation"])
            self._snapshot()

    @staticmethod
    def _close_spool(rep: dict):
        for f in rep.get("spool") or ():
            try:
                f.close()
            except OSError:
                pass

    def wait_healthy(self, min_replicas: Optional[int] = None,
                     timeout: float = 120.0) -> List[int]:
        """Block until `min_replicas` (default: all) replicas are alive
        AND listening (their beat payload carries the serving port)."""
        need = self.n if min_replicas is None else int(min_replicas)
        deadline = time.monotonic() + timeout
        while True:
            table = self.health.poll()
            up = [r for r, i in table.items()
                  if i["status"] == "alive"
                  and (i.get("tel") or {}).get("port")]
            if len(up) >= need:
                return sorted(up)
            if time.monotonic() > deadline:
                raise ServingError(
                    f"fleet failed to reach {need} healthy replicas "
                    f"within {timeout:.0f}s (have {sorted(up)}; "
                    f"statuses {[i['status'] for i in table.values()]})",
                    reason="replica_down")
            time.sleep(self.hb_interval_s / 2)

    def stop(self, timeout: float = 30.0):
        """Drain and stop every replica (SIGTERM -> grace -> SIGKILL),
        stop supervision, write the final ledger snapshot."""
        with self._lock:
            if self._stopping:
                return
            self._stopping = True
        self._sup_stop.set()
        if self._sup_thread is not None:
            self._sup_thread.join(timeout=10.0)
            self._sup_thread = None
        # final gauge snapshot BEFORE the drain: `healthy_replicas` must
        # record the fleet as it served, not the deliberate teardown
        # (perf_report --min-healthy-replicas gates this snapshot)
        self._snapshot()
        with self._lock:
            table = dict(self._replicas)
        for rep in table.values():
            if rep["proc"].poll() is None:
                try:
                    rep["proc"].send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.monotonic() + timeout
        for rank, rep in table.items():
            left = max(deadline - time.monotonic(), 0.1)
            try:
                rep["proc"].wait(timeout=left)
            except subprocess.TimeoutExpired:
                rep["proc"].kill()
                rep["proc"].wait(timeout=10.0)
            self._close_spool(rep)
        self._event("fleet_stopped",
                    ledger=self.router.stats())

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- request plane ------------------------------------------------------
    def infer(self, model: str, feeds, deadline_ms=None):
        return self.router.infer(model, feeds, deadline_ms=deadline_ms)

    def stats(self) -> dict:
        return self.router.stats()

    def replica_stats(self, rank: int) -> dict:
        """One replica's own ledger (op=stats over the control plane)."""
        with self._lock:
            port = self._replicas[rank]["port"]
        return rpc(port, {"op": "stats"}, timeout_s=self.rpc_timeout_s)

    def active_versions(self, model: str) -> Dict[int, dict]:
        """Each LIVE replica's active {src, version} for `model` — the
        split-brain probe chaos tests assert on."""
        out = {}
        table = self.health.poll()
        for rank, info in table.items():
            if info["status"] not in ("alive", "draining"):
                continue
            with self._lock:
                port = self._replicas[rank]["port"]
            try:
                reply = rpc(port, {"op": "active_src", "model": model},
                            timeout_s=self.rpc_timeout_s)
            except OSError:
                continue
            if reply.get("ok"):
                out[rank] = {"src": reply.get("src"),
                             "version": reply.get("version")}
        return out

    # -- rolling publish ----------------------------------------------------
    def _persist_roll(self, roll: dict):
        _io.atomic_write(os.path.join(self.root, _ROLL_FILE),
                         json.dumps(roll, indent=1))

    def _load_roll(self) -> Optional[dict]:
        try:
            doc = _io.read_json(os.path.join(self.root, _ROLL_FILE))
            return doc if isinstance(doc, dict) else None
        except OSError:
            return None

    def _control_rpc(self, rank: int, msg: dict,
                     recover_timeout: float = 60.0) -> dict:
        """Roll-plane rpc with crash recovery: a replica that dies while
        verifying is waited out (the supervisor restarts it; the fresh
        incarnation boots on last good) and the op is retried there."""
        deadline = time.monotonic() + recover_timeout
        while True:
            with self._lock:
                rep = self._replicas[rank]
                port, retired = rep["port"], rep["retired"]
            if retired:
                raise ServingError(
                    f"replica rank {rank} is retired (restart budget "
                    f"spent or drained); the fleet cannot complete this "
                    f"roll step", reason="replica_down")
            try:
                return rpc(port, msg, timeout_s=self.rpc_timeout_s)
            except (ConnectFailed, OSError) as e:
                if time.monotonic() > deadline:
                    raise ServingError(
                        f"replica rank {rank} unreachable for "
                        f"{recover_timeout:.0f}s during a roll step: {e}",
                        reason="replica_down") from e
                time.sleep(self.hb_interval_s)

    def rolling_publish(self, name: str, src: str,
                        recover_timeout: float = 60.0):
        """Zero-downtime verified publish through every replica.

        Phase "verify": each replica (one at a time) runs the FULL
        publish ladder on `src` with `stage_only=True` — old version
        keeps serving throughout.  Phase "activate": each replica swaps
        its staged version in; `ACTIVE.json` (what replica restarts
        boot from) moves only after every replica acked.  Any rung
        failure halts the roll and converges the fleet back on the last
        good version; raises `ServingError(reason="roll_halted")` with
        the original failure chained."""
        roll = {"model": name, "src": src,
                "ctl": control_trace_id("roll"),
                "phase": "verify", "verified": [], "acked": [],
                "last_good": (self.config["models"].get(name) or {}
                              ).get("src"), "ts": time.time()}
        return self._run_roll(roll, recover_timeout)

    def resume_roll(self, recover_timeout: float = 60.0):
        """Finish (or converge) a roll interrupted by a supervisor crash,
        from the persisted `ROLL.json` state.  Returns None when there is
        nothing to resume."""
        roll = self._load_roll()
        if not roll or roll.get("phase") in ("done", "rolled_back", None):
            return None
        if roll["phase"] == "halted":
            try:
                self._converge_back(roll, ServingError(
                    "resuming a roll persisted as halted",
                    reason="roll_halted"))
            except ServingError:
                pass  # convergence done; the original roll already failed
            return self._load_roll()
        self._event("roll_resumed", ctl=roll.get("ctl"),
                    phase=roll.get("phase"), model=roll.get("model"))
        return self._run_roll(roll, recover_timeout, resumed=True)

    def _run_roll(self, roll: dict, recover_timeout: float,
                  resumed: bool = False):
        name, src, ctl = roll["model"], roll["src"], roll["ctl"]
        with self._lock:
            if self._roll_active:
                raise ServingError(
                    "another rolling publish is already in flight",
                    reason="publish_rejected", model=name)
            self._roll_active = True
        try:
            if not resumed:
                self._persist_roll(roll)
                self._event("roll_started", ctl=ctl, model=name, src=src,
                            last_good=roll["last_good"])
            if roll["phase"] == "verify":
                for rank in range(self.n):
                    if rank in roll["verified"]:
                        continue
                    try:
                        reply = self._control_rpc(
                            rank, {"op": "stage", "model": name,
                                   "src": src},
                            recover_timeout=recover_timeout)
                    except ServingError as e:
                        self._halt_roll(roll, rank, e)
                    if not reply.get("ok"):
                        self._halt_roll(roll, rank, ServingError(
                            reply.get("error") or "stage refused",
                            reason=reply.get("reason") or
                            "publish_rejected", model=name,
                            trace_id=reply.get("trace_id")))
                    roll["verified"].append(rank)
                    self._persist_roll(roll)
                    self._event("replica_staged", ctl=ctl, model=name,
                                rank=rank, version=reply.get("version"))
                roll["phase"] = "activate"
                self._persist_roll(roll)
            for rank in range(self.n):
                if rank in roll["acked"]:
                    continue
                reply = self._activate_one(roll, rank, recover_timeout)
                roll["acked"].append(rank)
                self._persist_roll(roll)
                self._event("replica_acked", ctl=ctl, model=name,
                            rank=rank, version=reply.get("version"))
            # every replica acked — but an ack is not proof the replica
            # is still serving the new version: one that died AFTER
            # acking was restarted from ACTIVE.json (still last good)
            # and the loop above skips acked ranks.  Re-verify before
            # the pointer moves, or that replica split-brains forever.
            self._reconcile_acked(roll, recover_timeout)
            # the version becomes FLEET-active — this pointer is what
            # replica restarts boot from
            self.config["models"][name] = {"src": src}
            _io.atomic_write(
                os.path.join(self.root, _ACTIVE_FILE),
                json.dumps({"models": self.config["models"],
                            "ctl": ctl, "ts": time.time()}, indent=1))
            roll["phase"] = "done"
            self._persist_roll(roll)
            self._event("roll_converged", ctl=ctl, model=name, src=src,
                        acked=roll["acked"])
            return roll
        finally:
            with self._lock:
                self._roll_active = False

    def _activate_one(self, roll: dict, rank: int,
                      recover_timeout: float) -> dict:
        """Activate on one replica; a replica that died between stage and
        activate lost its (in-memory) staged slot — re-stage it first."""
        name, src = roll["model"], roll["src"]
        for attempt in range(2):
            try:
                reply = self._control_rpc(
                    rank, {"op": "activate", "model": name},
                    recover_timeout=recover_timeout)
            except ServingError as e:
                self._halt_roll(roll, rank, e)
            if reply.get("ok"):
                return reply
            if reply.get("reason") == "model_missing" and attempt == 0:
                # restarted mid-roll: boots on last good, staged slot
                # empty — run the ladder again on the fresh incarnation
                restage = self._control_rpc(
                    rank, {"op": "stage", "model": name, "src": src},
                    recover_timeout=recover_timeout)
                if not restage.get("ok"):
                    self._halt_roll(roll, rank, ServingError(
                        restage.get("error") or "re-stage refused",
                        reason=restage.get("reason") or "publish_rejected",
                        model=name))
                self._event("replica_restaged", ctl=roll["ctl"],
                            model=name, rank=rank)
                continue
            self._halt_roll(roll, rank, ServingError(
                reply.get("error") or "activate refused",
                reason=reply.get("reason") or "publish_rejected",
                model=name))
        raise AssertionError("unreachable")  # _halt_roll always raises

    def _reconcile_acked(self, roll: dict, recover_timeout: float):
        """Close the ack-then-die window before the roll finalizes: ask
        every acked replica what it is ACTUALLY serving (op=active_src)
        and re-run stage+activate on any that silently reverted — a
        replica restarted after its ack boots from ACTIVE.json, which is
        still the last good version until this pass comes back clean.
        Repeats until one full pass verifies, so a death during the
        reconcile itself is caught by the next pass."""
        name, src, ctl = roll["model"], roll["src"], roll["ctl"]
        for _ in range(self.max_restarts + 2):
            reverted = []
            for rank in list(roll["acked"]):
                try:
                    reply = self._control_rpc(
                        rank, {"op": "active_src", "model": name},
                        recover_timeout=recover_timeout)
                except ServingError as e:
                    self._halt_roll(roll, rank, e)
                if not (reply.get("ok") and reply.get("src") == src):
                    reverted.append(rank)
            if not reverted:
                return
            for rank in reverted:
                # boots on last good with an empty staged slot, so
                # _activate_one's model_missing path re-runs the ladder
                reply = self._activate_one(roll, rank, recover_timeout)
                self._event("replica_reactivated", ctl=ctl, model=name,
                            rank=rank, version=reply.get("version"))
        self._halt_roll(roll, reverted[0], ServingError(
            f"replica rank {reverted[0]} kept reverting to the last "
            f"good version while finalizing the roll (restart loop?)",
            reason="publish_rejected", model=name))

    def _halt_roll(self, roll: dict, rank: int, cause: ServingError):
        """A rung failed: halt, converge the fleet back on last good,
        raise classified.  Never returns."""
        roll["phase"] = "halted"
        roll["failed_rank"] = rank
        roll["failure"] = {"reason": cause.reason, "error": str(cause)}
        self._persist_roll(roll)
        _MON.counter("serving.fleet.rolls_halted").inc()
        self._event("roll_halted", ctl=roll["ctl"], model=roll["model"],
                    rank=rank, reason=cause.reason, error=str(cause))
        self._converge_back(roll, cause)

    def _converge_back(self, roll: dict, cause: ServingError):
        """Discard every staged slot (and roll back any replica that
        already activated) so the whole fleet serves last good again."""
        name = roll["model"]
        for rank in roll.get("acked", []):
            try:
                self._control_rpc(rank, {"op": "rollback", "model": name},
                                  recover_timeout=10.0)
            except ServingError:
                pass  # a dead acked replica reboots on last good anyway
        for rank in roll.get("verified", []):
            if rank in roll.get("acked", []):
                continue
            try:
                self._control_rpc(rank, {"op": "discard", "model": name},
                                  recover_timeout=10.0)
            except ServingError:
                pass
        roll["phase"] = "rolled_back"
        self._persist_roll(roll)
        self._event("roll_rolled_back", ctl=roll["ctl"], model=name,
                    last_good=roll.get("last_good"))
        raise ServingError(
            f"rolling publish of {roll.get('src')!r} halted at replica "
            f"rank {roll.get('failed_rank')} and the fleet converged "
            f"back on the last good version: {cause}",
            reason="roll_halted", model=name) from cause

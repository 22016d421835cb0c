"""Serving-replica process entry: `python -m paddle_tpu_torch.serving.replica_main`
(counterpart of paddle_tpu/serving/replica_main.py).

One fleet replica = one process running a full `serving.Server` (its own
registry, publisher ladder, monitor plane) behind a line-JSON TCP
control/data socket, plus a `ReplicaBeat` whose payload carries the
serving vitals the router dispatches on.  The fleet supervisor
(`serving/fleet.py`) spawns N of these; nothing in here knows about its
siblings — membership, routing and the rolling-publish protocol live
entirely supervisor-side.

Environment contract (set by `ServingFleet._spawn`):

    PADDLE_FLEET_DIR      fleet root: fleet.json (config, the place
                          included), ACTIVE.json (what to serve at boot),
                          hb/ (beat files)
    PADDLE_TRAINER_ID     replica rank
    PADDLE_REPLICA_PORT   TCP port to serve on (127.0.0.1)
    PADDLE_TELEMETRY_DIR  per-incarnation monitor stream dir
                          (`metrics.p<rank>.jsonl`; `serve_trace --fleet`
                          merges them)
    FLAGS_fault_spec      optional: arms storage-fault injection in THIS
                          replica (chaos tests rot/eio the shared store
                          from inside the replica running the ladder)

The registry is built on the place fleet.json names ("cuda:0" unless the
fleet was made with `CPUPlace()`).  A replica that cannot reach its card
exits non-zero with the error in its log; it never carries on on the CPU.

Wire protocol (newline-delimited JSON, one request per connection —
see serving/router.py): ops `infer`, `stats`, `ping`, and the
supervisor-only roll plane `stage` / `activate` / `discard` /
`rollback` / `active_src`.  Every reply is `{"ok": true, ...}` or
`{"ok": false, "reason": <classified>, "error": <message>}`.

Shutdown: SIGTERM starts a drain (the handler is installed at the top
of main(), so a SIGTERM landing mid-model-load still drains and exits
0, and the main thread's wait for it wakes every beat interval, so a
SIGTERM that a side thread takes is acted on too; one landing even
earlier — during interpreter/package import — kills
the process with -SIGTERM, which the supervisor ALSO treats as
deliberate retirement, never a restartable death) — the beat payload
flips `draining=true` immediately (one `beat_now`, so the router stops
dispatching within one health poll), dispatched-but-unfinished requests
are served out, the final ledger snapshot is written, and the process
exits 0 (the supervisor's "deliberate drain, do not restart" code).
SIGKILL is the chaos case: the periodic in-loop snapshots are what
survives for `serve_trace --fleet` reconciliation.

The `replica_up` and `replica_drained` serving_event records carry
`launches`: the kernel wrappers' launch counts (`cuda_kernels.LAUNCHES`)
at that moment, so a caller can tell what the replica launched at boot
and whether its traffic launched anything (graph replays do not count).
"""
from __future__ import annotations

import errno
import json
import os
import signal
import socketserver
import sys
import threading
import time

REPLICA_EXIT_CONFIG = 41  # bad/missing env or fleet.json: not restartable


def _reply(wfile, doc: dict):
    wfile.write((json.dumps(doc, default=str) + "\n").encode("utf-8"))
    wfile.flush()


def _classified(exc) -> dict:
    reason = getattr(exc, "reason", None) or "error"
    return {"ok": False, "reason": reason, "error": str(exc),
            "trace_id": getattr(exc, "trace_id", None)}


def _make_handler(ctx):
    """Request handler bound to this replica's server/registry.  `ctx`
    carries srv, rank, buckets and the draining flag."""
    from . import publisher as _pub
    from .router import decode_feeds, encode_arrays

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            line = self.rfile.readline()
            if not line:
                return
            try:
                msg = json.loads(line.decode("utf-8"))
            except ValueError as e:
                _reply(self.wfile, {"ok": False, "reason": "bad_request",
                                    "error": f"undecodable request: {e}"})
                return
            op = msg.get("op")
            try:
                _reply(self.wfile, self._dispatch(op, msg))
            except Exception as e:  # noqa: BLE001 - classified or not, the wire answers
                try:
                    _reply(self.wfile, _classified(e))
                except OSError:
                    pass  # client hung up first

        def _dispatch(self, op, msg):
            srv = ctx["srv"]
            registry = srv.registry
            if op == "ping":
                return {"ok": True, "pid": os.getpid(),
                        "rank": ctx["rank"]}
            if op == "infer":
                out = srv.infer(msg["model"], decode_feeds(msg["feeds"]),
                                deadline_ms=msg.get("deadline_ms"))
                return {"ok": True, "outputs": encode_arrays(out)}
            if op == "stats":
                return {"ok": True, "stats": srv.stats(),
                        "draining": ctx["draining"].is_set(),
                        "pid": os.getpid()}
            if op == "stage":
                version = _pub.publish(
                    registry, msg["model"], msg["src"], stage_only=True,
                    warm_buckets=ctx["buckets"])
                return {"ok": True, "version": version.version,
                        "src": version.src}
            if op == "activate":
                registry.activate_staged(msg["model"])
                return {"ok": True,
                        "version": registry.models()[msg["model"]]["version"]}
            if op == "discard":
                return {"ok": True,
                        "discarded": registry.discard_staged(msg["model"])}
            if op == "rollback":
                registry.rollback(msg["model"])
                return {"ok": True}
            if op == "active_src":
                info = registry.models().get(msg["model"])
                if info is None:
                    return {"ok": False, "reason": "model_missing",
                            "error": f"no model {msg['model']!r} loaded"}
                return {"ok": True, "src": info.get("src"),
                        "version": info.get("version")}
            return {"ok": False, "reason": "bad_request",
                    "error": f"unknown op {op!r}"}

    return Handler


class _Listener(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


BIND_RETRY_S = 90.0  # outlasts a TIME_WAIT (60 s) on the port


def _listen(port: int, handler, retry_s: float = BIND_RETRY_S) -> _Listener:
    """The replica's listener on `port`, its bind retried on EADDRINUSE
    for up to `retry_s`.  A restarted replica rebinds its predecessor's
    port while the fleet's traffic goes on: where the kernel's ephemeral
    range covers the fleet's ports, a connection of the router's can hold
    that port as its local end (in TIME_WAIT for up to 60 s after it
    closes, which SO_REUSEADDR does not get past), and the bind fails
    until it goes."""
    deadline = time.monotonic() + retry_s
    while True:
        try:
            return _Listener(("127.0.0.1", port), handler)
        except OSError as e:
            if e.errno != errno.EADDRINUSE or time.monotonic() >= deadline:
                raise
            time.sleep(0.25)


def _place(name: str):
    """The place fleet.json names: "cpu" or "cuda:<id>"."""
    from ..core.executor import CPUPlace, CUDAPlace

    if name == "cpu":
        return CPUPlace()
    return CUDAPlace(int(name.partition(":")[2] or 0))


def _wait_for_drain(done, poll_s: float):
    """Block until the drain signal's handler has set `done`.  The wait
    wakes every `poll_s`: a signal that another thread of the process
    takes only flags CPython, and the main thread runs the handler at its
    next bytecode, which an untimed wait would never reach."""
    while not done.wait(poll_s):
        pass


def _launches() -> dict:
    from ..ops import cuda_kernels

    return dict(cuda_kernels.LAUNCHES)


def main() -> int:
    fleet_dir = os.environ.get("PADDLE_FLEET_DIR")
    port = os.environ.get("PADDLE_REPLICA_PORT")
    if not fleet_dir or not port:
        print("replica_main: PADDLE_FLEET_DIR and PADDLE_REPLICA_PORT "
              "are required", file=sys.stderr)
        return REPLICA_EXIT_CONFIG
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    port = int(port)

    # the drain handler goes in BEFORE the slow part of boot (model
    # load, bucket warm): a SIGTERM racing a booting replica must still
    # be a deliberate drain (exit 0), not the default handler's
    # non-zero death that the supervisor would dutifully restart —
    # undoing an operator scale-down or fleet.stop()
    draining = threading.Event()
    done = threading.Event()

    def _sigterm(_sig, _frm):
        draining.set()
        done.set()

    signal.signal(signal.SIGTERM, _sigterm)

    from .. import io as _io
    from .. import monitor
    from ..dist_resilience import ReplicaBeat
    from ..faults import FaultInjector
    from ..monitor.exporters import init_worker_telemetry
    from .registry import ModelRegistry
    from .server import Server

    try:
        cfg = _io.read_json(os.path.join(fleet_dir, "fleet.json"))
    except OSError as e:
        print(f"replica_main: unreadable fleet.json: {e}", file=sys.stderr)
        return REPLICA_EXIT_CONFIG

    monitor.enable()
    logger = init_worker_telemetry(rank=rank)

    injector = FaultInjector.from_flags()
    if injector is not None:
        injector.arm_io()

    buckets = tuple(cfg.get("buckets") or (1, 4, 8))
    hb_interval = float(cfg.get("hb_interval_s", 0.5))
    drain_grace = float(cfg.get("drain_grace_s", 4 * hb_interval))
    world = int(cfg.get("n_replicas", 1))

    # raises without the card fleet.json names: the process exits
    # non-zero with the traceback in its log, and never serves on the CPU
    registry = ModelRegistry(place=_place(cfg.get("place", "cuda:0")))
    srv = Server(registry, buckets=buckets,
                 max_queue=cfg.get("max_queue"),
                 default_deadline_ms=cfg.get("default_deadline_ms"),
                 workers=int(cfg.get("workers", 1)))

    # boot on the fleet-active versions (ACTIVE.json is only ever moved
    # forward AFTER every replica acked a roll, so a restart mid-roll
    # lands on the last good version and the supervisor re-stages)
    active = {}
    try:
        active = _io.read_json(os.path.join(fleet_dir, "ACTIVE.json"))
    except OSError:
        pass  # first boot before any roll: fleet.json names the models
    models = (active.get("models") if isinstance(active, dict) else None) \
        or cfg.get("models") or {}
    for name, spec in models.items():
        src = spec["src"] if isinstance(spec, dict) else spec
        srv.load_model(name, src)

    ctx = {"srv": srv, "rank": rank, "buckets": buckets,
           "draining": draining}

    listener = _listen(port, _make_handler(ctx))
    listen_thread = threading.Thread(target=listener.serve_forever,
                                     name="replica-listener", daemon=True)
    listen_thread.start()

    # beat payload: the vitals the router routes on.  Every Nth beat also
    # appends a monitor snapshot so a SIGKILLed replica still leaves an
    # (at most one beat stale) ledger for fleet reconciliation.
    snap_every = max(int(cfg.get("snapshot_every_beats", 2)), 1)
    beat_n = [0]

    def _payload():
        beat_n[0] += 1
        if logger is not None and beat_n[0] % snap_every == 0:
            try:
                logger.write_snapshot()
            except OSError:
                pass
        s = srv.stats()
        return {"port": port, "pid": os.getpid(),
                "q": s["queue_depth"],
                "p99": s.get("lat_p99_ms", 0.0),
                "shed": s["shed"] + s["rejected"],
                "completed": s["completed"],
                "draining": draining.is_set(),
                "active": {n: m["version"]
                           for n, m in s["models"].items()}}

    beat = ReplicaBeat(os.path.join(fleet_dir, "hb"), rank, world,
                       interval_s=hb_interval, payload_fn=_payload).start()

    monitor.record_step({"kind": "serving_event", "action": "replica_up",
                         "rank": rank, "port": port, "pid": os.getpid(),
                         "launches": _launches()})
    _wait_for_drain(done, hb_interval)

    # -- drain --------------------------------------------------------------
    beat.beat_now()          # draining=true reaches the router NOW
    time.sleep(drain_grace)  # let already-dispatched connections land
    listener.shutdown()      # stop accepting; in-flight handlers finish
    srv.stop(drain=True)     # serve out everything admitted
    listener.server_close()
    monitor.record_step({"kind": "serving_event", "action": "replica_drained",
                         "rank": rank, "pid": os.getpid(),
                         "launches": _launches()})
    if logger is not None:
        try:
            logger.write_snapshot()
        except OSError:
            pass
    beat.stop(mark_down=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

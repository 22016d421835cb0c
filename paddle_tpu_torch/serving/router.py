"""Health- and queue-depth-aware request routing for the serving fleet
(counterpart of paddle_tpu/serving/router.py).

The router is the client-facing half of `paddle_tpu_torch.serving.fleet`: it
holds no model and serves no traffic itself — it picks which replica
gets each request and keeps the exact fleet-side ledger the replicas'
own ledgers are reconciled against (`serve_trace --fleet --check`).

Dispatch policy:

  * candidates = replicas whose `FleetHealth` status is "alive" (a
    "draining" replica still finishes its in-flight work but takes no
    NEW traffic), that are not locally *suspect* (see below), and whose
    router-side inflight count is under `inflight_cap`;
  * among candidates, least-loaded wins: fewest router-side inflight,
    then the shallowest queue / lowest p99 from the replica's own beat
    telemetry (the monitor stream riding `ReplicaBeat` payloads);
  * no candidate at all is classified, not an exception soup:
    every candidate at its inflight cap -> `reason="overload"`
    (backpressure, retry later); no live replica -> `reason="replica_down"`.

Suspicion closes the heartbeat-staleness window: a TCP connect/request
failure marks the replica suspect IMMEDIATELY (with the beat seq it was
suspected at), so new traffic redistributes on the very next request
instead of waiting out `interval * miss_factor`.  The mark clears when
the beat sequence moves off the suspicion point — ADVANCED past it (a
live replica that dropped one connection gets traffic back within one
beat) or restarted BELOW it (a supervisor relaunch begins a fresh seq
space at 1; the dead incarnation's high-water mark must not bench the
new process).  The supervisor also clears the mark explicitly via
`note_restart` the moment it relaunches a rank.

Failure semantics per request:

  * connect refused/timed out BEFORE the request was written: nothing
    reached the replica, so the router retries the next candidate
    transparently (at most one pass over the fleet);
  * socket death AFTER the request was written (the replica died with
    this request in flight): the request fails classified
    `ServingError(reason="replica_down")` — the router cannot know
    whether it executed, so it never blind-retries it;
  * a classified refusal from the replica (overload/timeout/shutdown/..)
    is re-raised verbatim — backpressure must reach the client.

Wire protocol: one JSON object per line over a fresh TCP connection per
request (newline-delimited both ways; `replica_main.py` is the server
end), the JAX package's format: an array is its dtype's name, its shape
and its values as a list of numbers.  A bfloat16 array travels under the
name "bfloat16" and decodes to an ml_dtypes array (`core.dtypes`).
Per-request connections keep the router lock-free around sockets — every
blocking call here runs outside the ledger lock.
"""
from __future__ import annotations

__all__ = ["Router", "rpc", "ConnectFailed",
           "encode_feeds", "decode_feeds",
           "encode_arrays", "decode_arrays"]

import copy
import json
import socket
import time
from typing import Dict, List, Optional

import numpy as np

from ..core import locks
from ..core.dtypes import _numpy_bfloat16
from ..errors import ServingError
from ..monitor import MONITOR as _MON

# One pass over the fleet: a refused connect burns one retry, so the
# worst case (every replica died since the last beat) stays bounded.
_CONNECT_TIMEOUT_S = 5.0


# ---- wire encoding ----------------------------------------------------------

def _encode_array(a) -> dict:
    a = np.asarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": a.ravel().tolist()}


def _decode_array(d: dict) -> np.ndarray:
    # numpy knows "bfloat16" only by ml_dtypes' type
    dtype = _numpy_bfloat16() if d["dtype"] == "bfloat16" else d["dtype"]
    return np.asarray(d["data"], dtype=dtype).reshape(d["shape"])


def encode_feeds(feeds: Dict[str, np.ndarray]) -> Dict[str, dict]:
    return {k: _encode_array(v) for k, v in feeds.items()}


def decode_feeds(doc: Dict[str, dict]) -> Dict[str, np.ndarray]:
    return {k: _decode_array(v) for k, v in doc.items()}


def encode_arrays(arrays) -> List[dict]:
    return [_encode_array(a) for a in arrays]


def decode_arrays(docs) -> List[np.ndarray]:
    return [_decode_array(d) for d in docs]


# ---- transport --------------------------------------------------------------

class ConnectFailed(ConnectionError):
    """The transport failed BEFORE the request reached the replica —
    the one transport failure a router may retry on another replica."""


def rpc(port: int, msg: dict, timeout_s: float = 30.0,
        host: str = "127.0.0.1") -> dict:
    """One request/reply over a fresh connection.  Raises ConnectFailed
    when the failure provably precedes delivery (safe to retry
    elsewhere) and plain OSError once the request may have executed."""
    payload = (json.dumps(msg) + "\n").encode("utf-8")
    try:
        s = socket.create_connection((host, port),
                                     timeout=_CONNECT_TIMEOUT_S)
    except OSError as e:
        raise ConnectFailed(f"connect to replica at :{port}: {e}") from e
    with s:
        s.settimeout(timeout_s)
        s.sendall(payload)
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                raise ConnectionError(
                    f"replica at :{port} closed the connection mid-reply")
            buf += chunk
    return json.loads(buf.decode("utf-8"))


class Router:
    """Dispatches requests across the fleet's live replicas.

        router = Router(health)          # a dist_resilience.FleetHealth
        out = router.infer("m", {"x": batch}, deadline_ms=50)
        router.stats()                   # the fleet-side exact ledger
    """

    def __init__(self, health, inflight_cap: int = 8,
                 rpc_timeout_s: float = 60.0):
        self.health = health
        self.inflight_cap = max(int(inflight_cap), 1)
        self.rpc_timeout_s = float(rpc_timeout_s)
        # ledger + dispatch state; every socket op runs OUTSIDE this lock
        self._lock = locks.named_lock("serving.router", rank=6)
        self._inflight: Dict[int, int] = {}
        self._suspect: Dict[int, Optional[int]] = {}  # rank -> seq@suspicion
        self._stats = {"requests": 0, "completed": 0, "errors": 0,
                       "retries": 0,
                       "by_reason": {}, "routed": {}}

    # -- candidate selection ------------------------------------------------
    def _mark_suspect(self, rank: int, seq: Optional[int]):
        with self._lock:
            self._suspect[rank] = seq
        _MON.counter("serving.fleet.suspects").inc()

    def note_restart(self, rank: int):
        """The supervisor relaunched this rank: suspicion was held
        against the DEAD incarnation's beat seq and does not transfer
        to the fresh process (whose seq space restarts at 1)."""
        with self._lock:
            self._suspect.pop(rank, None)

    def _pick(self, table: Dict[int, dict]) -> Optional[dict]:
        """Least-loaded live candidate, or a classified refusal.  `table`
        is a FleetHealth.poll() result (polled OUTSIDE the lock)."""
        with self._lock:
            candidates = []
            capped = 0
            for r, info in table.items():
                if info["status"] != "alive":
                    continue
                seq = info["seq"]
                if r in self._suspect:
                    at = self._suspect[r]
                    # forgiven when the beats advanced past the suspicion
                    # point — OR restarted BELOW it: a seq lower than the
                    # one we suspected at can only be a fresh incarnation
                    # (note_restart wiped the corpse's hb file and the
                    # new process counts from 1 again)
                    if seq is not None and (at is None or seq != at):
                        del self._suspect[r]
                    else:
                        continue
                tel = info.get("tel") or {}
                if "port" not in tel:
                    continue  # beating but not yet listening
                inflight = self._inflight.get(r, 0)
                if inflight >= self.inflight_cap:
                    capped += 1
                    continue
                candidates.append((inflight, tel.get("q", 0),
                                   tel.get("p99", 0.0), r, tel))
            if not candidates:
                if capped:
                    raise ServingError(
                        f"all {capped} healthy replicas are at their "
                        f"inflight cap ({self.inflight_cap})",
                        reason="overload")
                raise ServingError(
                    "no healthy replica remains to dispatch to",
                    reason="replica_down")
            candidates.sort(key=lambda c: c[:3])
            _infl, _q, _p99, rank, tel = candidates[0]
            self._inflight[rank] = self._inflight.get(rank, 0) + 1
            self._stats["routed"][rank] = \
                self._stats["routed"].get(rank, 0) + 1
            return {"rank": rank, "port": int(tel["port"]),
                    "seq": table[rank]["seq"]}

    # -- request path -------------------------------------------------------
    def infer(self, model: str, feeds: Dict[str, np.ndarray],
              deadline_ms: Optional[float] = None) -> List[np.ndarray]:
        """Route one inference to the least-loaded healthy replica."""
        with self._lock:
            self._stats["requests"] += 1
        _MON.counter("serving.fleet.requests").inc()
        msg = {"op": "infer", "model": model,
               "feeds": encode_feeds(feeds), "deadline_ms": deadline_ms}
        tried = 0
        world = getattr(self.health, "world", 1)
        while True:
            table = self.health.poll()
            try:
                pick = self._pick(table)
            except ServingError as e:
                self._account_error(e.reason)
                raise
            rank, port, seq = pick["rank"], pick["port"], pick["seq"]
            try:
                try:
                    reply = rpc(port, msg, timeout_s=self.rpc_timeout_s)
                except ConnectFailed as e:
                    # nothing was accepted: safe to retry elsewhere
                    self._mark_suspect(rank, seq)
                    tried += 1
                    if tried >= max(world, 1):
                        err = ServingError(
                            f"every replica refused the connection "
                            f"(last: rank {rank}: {e})",
                            reason="replica_down", model=model)
                        self._account_error("replica_down")
                        raise err from e
                    with self._lock:
                        self._stats["retries"] += 1
                    continue
                except OSError as e:
                    # the connection died with the request possibly
                    # executing: classified loss, never blind-retried
                    self._mark_suspect(rank, seq)
                    err = ServingError(
                        f"replica rank {rank} died with this request "
                        f"in flight: {e}",
                        reason="replica_down", model=model)
                    self._account_error("replica_down")
                    raise err from e
            finally:
                with self._lock:
                    n = self._inflight.get(rank, 1)
                    self._inflight[rank] = max(n - 1, 0)
            if reply.get("ok"):
                with self._lock:
                    self._stats["completed"] += 1
                _MON.counter("serving.fleet.completed").inc()
                return decode_arrays(reply["outputs"])
            reason = reply.get("reason") or "error"
            self._account_error(reason)
            raise ServingError(
                reply.get("error") or f"replica rank {rank} refused",
                reason=reason, model=model,
                trace_id=reply.get("trace_id"))

    def _account_error(self, reason: Optional[str]):
        reason = reason or "error"
        with self._lock:
            self._stats["errors"] += 1
            self._stats["by_reason"][reason] = \
                self._stats["by_reason"].get(reason, 0) + 1
        _MON.counter("serving.fleet.errors").inc()
        _MON.counter(f"serving.fleet.errors[{reason}]").inc()

    # -- introspection ------------------------------------------------------
    def inflight(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._inflight)

    def stats(self) -> dict:
        with self._lock:
            s = copy.deepcopy(self._stats)
        table = self.health.poll()
        s["replicas"] = {r: info["status"] for r, info in table.items()}
        s["healthy"] = sorted(r for r, info in table.items()
                              if info["status"] == "alive")
        s["ts"] = time.time()
        return s

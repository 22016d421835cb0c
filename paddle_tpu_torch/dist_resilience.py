"""Replica liveness for the serving fleet (counterpart of the serving part of
paddle_tpu/dist_resilience.py).

Beats are files under a shared directory: each replica process atomically
replaces `hb-<rank>` with a sequence number that grows by one a beat, plus
a payload of serving vitals (queue depth, p99, the draining flag, the
serving port, the active versions).  One observer, the fleet supervisor,
which also feeds the router, reads them.  Staleness is measured on the
OBSERVER's monotonic clock from when it last saw the sequence advance,
never from the writer's clock.

    beat = ReplicaBeat(hb_dir, rank, world, interval_s=0.3,
                       payload_fn=lambda: {"port": port, "q": 0}).start()
    health = FleetHealth(hb_dir, world, interval_s=0.3, miss_factor=4.0)
    health.poll()   # {rank: {"status": "alive" | "booting" | ...}}

The gang half of the JAX module (`Heartbeat`, the UDP transport, the
collective watchdog, `init_health`) comes with data parallelism, ROADMAP
A10.
"""
from __future__ import annotations

__all__ = ["ReplicaBeat", "FleetHealth"]

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from .core import locks
from .monitor import MONITOR as _MON


class _FileTransport:
    """Beats as files under a shared directory.  `hb-<rank>` is atomically
    replaced each beat with a monotonically increasing sequence number;
    observation staleness is measured from when THIS process last saw the
    sequence advance, never from the writer's clock."""

    def __init__(self, root: str, rank: int, world: int):
        self.root = root
        self.rank = rank
        self.world = world
        os.makedirs(root, exist_ok=True)

    def _path(self, rank: int) -> str:
        return os.path.join(self.root, f"hb-{rank}")

    def send(self, seq: int, payload: Optional[dict] = None):
        # through the io.py storage choke point: a full disk under the
        # heartbeat dir raises OSError to the beat loop, which counts it
        # and keeps beating.  fsync=False: a beat is worthless the moment
        # the next one lands.  fault_exempt: INJECTED storage faults must
        # not hit beats -- the beat thread writes on its own clock, so an
        # op-indexed spec would count a timing-dependent stream, and a
        # step-window ro_fs would fake the replica's death.  Real OSErrors
        # still reach the loud path.
        from . import io as _io

        body = json.dumps({"seq": seq, "tel": payload}) if payload \
            else str(seq)
        with _io.fault_exempt(self.root):
            _io.atomic_write(self._path(self.rank), body, fsync=False)

    def poll(self) -> Dict[int, tuple]:
        """{peer rank: (latest sequence seen, telemetry payload or None)}
        for every peer with a beat on disk.  A DOWN-<rank> tombstone
        reports as seq -1 (explicitly dead, no staleness wait needed).
        Plain-integer beat files still parse."""
        out = {}
        for r in range(self.world):
            if r == self.rank:
                continue
            if os.path.exists(os.path.join(self.root, f"DOWN-{r}")):
                out[r] = (-1, None)
                continue
            try:
                with open(self._path(r)) as f:
                    raw = f.read().strip() or "0"
            except OSError:
                continue
            try:
                if raw.startswith("{"):
                    doc = json.loads(raw)
                    out[r] = (int(doc["seq"]), doc.get("tel"))
                else:
                    out[r] = (int(raw), None)
            except (ValueError, KeyError, TypeError):
                continue
        return out

    def mark_down(self):
        """Tombstone: a replica leaving through its drain tells the
        observer at once instead of making it wait out staleness.
        (SIGKILL leaves no tombstone: that is what staleness is for.)"""
        try:
            with open(os.path.join(self.root, f"DOWN-{self.rank}"), "w") as f:
                f.write(str(os.getpid()))
        except OSError:
            # best effort (the observer falls back to staleness), but
            # counted: a full disk eating tombstones is the same storage
            # failure the beat loop counts
            _MON.counter("dist.heartbeat.send_errors").inc()

    def close(self):
        pass


class ReplicaBeat:
    """One daemon thread writing `hb-<rank>` beats whose payload carries a
    serving replica's vitals (`payload_fn` provides the dict).  The router
    dispatches on this payload; the supervisor's FleetHealth reads liveness
    from the sequence advancing.  `beat_now()` pushes an out-of-band beat
    so a state flip (draining on SIGTERM) reaches the router within one
    health poll instead of one beat interval.  Beats ride the io.py atomic
    choke point and are exempt from INJECTED storage faults."""

    def __init__(self, hb_dir: str, rank: int, world: int,
                 interval_s: float = 0.5,
                 payload_fn: Optional[Callable[[], dict]] = None):
        self.rank = rank
        self.interval_s = float(interval_s)
        self.transport = _FileTransport(hb_dir, rank, world)
        self.payload_fn = payload_fn
        # seq is advanced by the beat thread AND beat_now callers (the
        # drain): a lost update would stall the observed sequence and fake
        # this replica's death
        self._lock = locks.named_lock("dist.replica_beat", rank=38)
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _beat(self):
        with self._lock:
            self._seq += 1
            seq = self._seq
        try:
            payload = self.payload_fn() if self.payload_fn else None
        except Exception:  # noqa: BLE001 - a beat without vitals still proves liveness
            payload = None
        try:
            self.transport.send(seq, payload)
        except OSError:
            _MON.counter("dist.heartbeat.send_errors").inc()  # loud, never fatal
            return
        _MON.counter("dist.heartbeat.sent").inc()

    def start(self) -> "ReplicaBeat":
        if self._thread is not None:
            return self
        self._beat()  # beat 1 lands before the model load blocks
        self._thread = threading.Thread(target=self._loop,
                                        name="ptt-replica-beat", daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self._beat()

    def beat_now(self):
        """Out-of-band beat carrying the CURRENT payload immediately."""
        self._beat()

    def stop(self, mark_down: bool = False):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s * 4)
            self._thread = None
        if mark_down:
            self.transport.mark_down()
        self.transport.close()


class FleetHealth:
    """Observe-only replica liveness for the fleet supervisor and router.

    Polls every replica's `hb-<rank>` file and classifies each rank:

        "booting"   never observed, within `startup_grace_s` (absence at
                    t=0 is not death: a replica pays imports and its model
                    load before beat 1 in degenerate cases)
        "alive"     sequence advanced within `deadline_s` of LOCAL
                    monotonic time (never the writer's clock)
        "draining"  alive AND its payload carries draining=True: the router
                    stops dispatching to it while it serves out its
                    in-flight requests
        "dead"      stale past deadline_s, never seen past the grace, or an
                    explicit DOWN tombstone

    `poll()` returns the full table; `alive()` and `dispatchable()` are the
    supervisor's and the router's views of it."""

    def __init__(self, hb_dir: str, world: int, interval_s: float = 0.5,
                 miss_factor: float = 5.0, startup_grace_s: float = 60.0):
        self.world = world
        self.deadline_s = float(interval_s) * float(miss_factor)
        self.startup_grace_s = float(startup_grace_s)
        # rank -1: a pure observer is nobody's peer, so poll() reads every
        # replica's file and send() is never called
        self.transport = _FileTransport(hb_dir, -1, world)
        self._start_mono = time.monotonic()
        # rank -> (last seq, monotonic time the seq last ADVANCED, tel)
        self._observed: Dict[int, tuple] = {}
        self._restart_at: Dict[int, float] = {}
        self._lock = locks.named_lock("dist.fleet_health", rank=39)

    def note_restart(self, rank: int):
        """Forget a rank's observation history (the supervisor just
        relaunched it): the fresh process gets the full startup grace again
        instead of inheriting the corpse's staleness, and a DOWN tombstone
        left by a draining predecessor is cleared.  The corpse's hb file
        goes too: its sequence is higher than the fresh incarnation's first
        beats, which would otherwise never register as advances."""
        for stale in (f"DOWN-{rank}", f"hb-{rank}"):
            try:
                os.remove(os.path.join(self.transport.root, stale))
            except OSError:
                pass
        with self._lock:
            self._observed.pop(rank, None)
            self._restart_at[rank] = time.monotonic()

    def poll(self) -> Dict[int, dict]:
        read_at = time.monotonic()
        polled = self.transport.poll()
        now = time.monotonic()
        out = {}
        with self._lock:
            for r, (seq, tel) in polled.items():
                if self._restart_at.get(r, read_at) > read_at:
                    # read before a concurrent note_restart removed the
                    # corpse's file: its beat must not register again
                    continue
                prev = self._observed.get(r)
                if seq == -1:
                    self._observed[r] = (-1, now, None)
                elif prev is None or seq > prev[0]:
                    self._observed[r] = (seq, now, tel if isinstance(tel, dict)
                                         else (prev[2] if prev else None))
            for r in range(self.world):
                obs = self._observed.get(r)
                born = self._restart_at.get(r, self._start_mono)
                if obs is None:
                    grace = now - born <= self.startup_grace_s
                    out[r] = {"rank": r, "seq": None, "age_s": None,
                              "status": "booting" if grace else "dead",
                              "tel": None}
                    continue
                seq, at, tel = obs
                age = now - at
                if seq == -1 or age > self.deadline_s:
                    status = "dead"
                elif isinstance(tel, dict) and tel.get("draining"):
                    status = "draining"
                else:
                    status = "alive"
                out[r] = {"rank": r, "seq": seq, "age_s": round(age, 3),
                          "status": status, "tel": tel}
        return out

    def alive(self) -> List[int]:
        """Ranks serving OR draining (their process is live)."""
        return [r for r, info in self.poll().items()
                if info["status"] in ("alive", "draining")]

    def dispatchable(self) -> List[int]:
        """Ranks the router may send NEW traffic to."""
        return [r for r, info in self.poll().items()
                if info["status"] == "alive"]

"""Host parameter service for out-of-HBM embedding tables (counterpart of
paddle_tpu/param_server.py, with its wire bytes, names and signatures).

Reference: the pserver stack -- listen_and_serv_op.cc (RunSyncLoop:109),
RPCClient/RPCServer + VariableMessage wire form (operators/distributed/),
parameter_prefetch.cc (sparse rows pulled on demand), and the transpiler's
distributed lookup table (distribute_transpiler.py:1428-1583).

Dense parameters never touch this tier.  What it carries is the capability
the pserver carried: embedding tables too big for the card, kept on the
HOST, with rows pulled before a step and sparse row gradients pushed after.
The tables are numpy arrays in the server process; no torch tensor crosses
the wire.  The wire is a length-prefixed binary protocol over TCP sockets,
byte for byte the JAX package's, so a client of either package talks to a
server of the other; the server applies the optimizer's row update itself
(SGD or Adagrad), the listen_and_serv optimize-block role.

The tier is supervised, survivable and integrity-checked:

  * every socket carries a deadline (`FLAGS_ps_timeout_s`) and every
    failure classifies onto `errors.ParamServerError` with the
    transient/terminal split `StorageError` has;
  * `KVClient` retries transient failures with reconnect and seeded
    backoff (`FLAGS_ps_retries`); a push carries a per-client sequence
    number the server dedups, so a retried push -- the reply was lost, not
    the apply -- lands exactly once;
  * frames are capped (`FLAGS_ps_max_frame_mb`): a corrupt length prefix
    raises terminal instead of allocating unbounded;
  * with a `snapshot_dir` the server is durable: every mutating op is
    write-ahead journaled (`io.append_record`, fsynced before it applies)
    and the tables snapshot through the io.py atomic choke point every
    `FLAGS_ps_snapshot_every_ops` ops; a restarted server recovers tables,
    accumulators and the dedup map bit for bit, and a directory written by
    either package's server recovers in the other's;
  * `PServerSupervisor` crash-restarts the server process
    (`python -m paddle_tpu_torch.param_server`, which never opens the card)
    under a restart budget, reading its liveness off `ReplicaBeat` files
    through `FleetHealth`: a SIGKILLed or wedged pserver comes back inside
    one health deadline on the same endpoint, and the client's retry loop
    rides it out.

Use with the SelectedRows machinery: run the device program with the
pulled rows as a feed, read the gradient of that feed (`calc_gradient`),
push it.  `HostTableEmbedding` packages that loop with its bounded degraded
mode while the tier is down; `parallel.TieredEmbedding` puts a hot head of
the table beside it.
"""
from __future__ import annotations

import hashlib
import json
import os
import signal
import socket
import socketserver
import struct
import subprocess
import sys
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from .core import locks
from .errors import (ParamServerError, StorageError, attach_context,
                     classify)
from .flags import flag as _flag
from .monitor import MONITOR as _MON, record_fleet_event

__all__ = ["ParameterServer", "KVClient", "PServerSupervisor",
           "HostTableEmbedding", "AsyncCommunicator"]

_MAGIC = b"PTPS"

# snapshot/journal layout inside a server's snapshot_dir
PS_MANIFEST = "__ps_manifest__.json"
PS_COMMITTED = "PS_COMMITTED"


def _max_frame_bytes() -> int:
    mb = _flag("FLAGS_ps_max_frame_mb")
    return int(float(mb or 256) * (1 << 20))


def _timeout_s() -> Optional[float]:
    t = float(_flag("FLAGS_ps_timeout_s") or 0.0)
    return t if t > 0 else None


def _merge_rows(ids: np.ndarray, grads: np.ndarray):
    """MergeAdd (reference selected_rows_functor): sum duplicate rows."""
    uniq, inv = np.unique(np.asarray(ids, np.int64).reshape(-1),
                          return_inverse=True)
    merged = np.zeros((uniq.size,) + grads.shape[1:], grads.dtype)
    np.add.at(merged, inv, grads)
    return uniq, merged


def _send_msg(sock, op: bytes, payload: bytes):
    cap = _max_frame_bytes()
    if len(payload) > cap:
        raise ParamServerError(
            f"refusing to send a {len(payload)}-byte frame past the "
            f"FLAGS_ps_max_frame_mb cap ({cap} bytes) — split the push "
            f"or raise the cap", transient=False)
    sock.sendall(_MAGIC + op + struct.pack("<Q", len(payload)) + payload)


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("parameter server connection closed")
        got += k
    return bytes(buf)


def _recv_msg(sock) -> Tuple[bytes, bytes]:
    head = _recv_exact(sock, 13)
    if head[:4] != _MAGIC:
        raise ParamServerError(
            "parameter server: bad magic — the stream is corrupt or "
            "something other than a pserver peer wrote to this socket",
            transient=False)
    op = head[4:5]
    (n,) = struct.unpack("<Q", head[5:13])
    cap = _max_frame_bytes()
    if n > cap:
        # a corrupt length prefix must never allocate unbounded; past this
        # point the stream is unsynchronized, so the connection dies too
        raise ParamServerError(
            f"parameter server: frame length {n} exceeds the "
            f"FLAGS_ps_max_frame_mb cap ({cap} bytes) — corrupt length "
            f"prefix", transient=False)
    return op, _recv_exact(sock, n)


def _pack_arr(a: np.ndarray) -> bytes:
    a = np.ascontiguousarray(a)
    dt = a.dtype.str.encode()
    return (struct.pack("<I", len(dt)) + dt + struct.pack("<I", a.ndim)
            + struct.pack(f"<{a.ndim}q", *a.shape) + a.tobytes())


def _unpack_arr(b: bytes, off: int = 0):
    (dl,) = struct.unpack_from("<I", b, off)
    off += 4
    dt = np.dtype(b[off:off + dl].decode())
    off += dl
    (nd,) = struct.unpack_from("<I", b, off)
    off += 4
    shape = struct.unpack_from(f"<{nd}q", b, off)
    off += 8 * nd
    size = int(np.prod(shape)) if nd else 1
    arr = np.frombuffer(b, dt, count=size, offset=off).reshape(shape)
    end = off + arr.nbytes
    if not arr.flags.aligned:
        # frames pack arrays back to back, so a view is mostly misaligned
        # for its dtype, and numpy's misaligned loops (the merge's
        # np.add.at above all) run several times slower than a copy costs
        arr = arr.copy()
    return arr, end


class ParameterServer:
    """Row-sharded host table server (one shard per server process/port).

    Protocol ops: b"P" pull(name, ids) -> rows; b"G" push(name, ids,
    grads) applying the configured row update; b"S" sequenced push
    (client id + seq prefix, deduped server-side for exactly-once);
    b"C" create(name, array); b"F" fetch full table (checkpointing);
    b"D" content digest of a table (+ accumulator); b"Q" shutdown.

    With `snapshot_dir`, mutating ops (C/G/S) are write-ahead journaled
    and the tables snapshot every `snapshot_every_ops` mutations; a
    fresh server over the same dir recovers bit-identical state."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 optimizer: str = "sgd", lr: float = 0.1,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every_ops: Optional[int] = None):
        self.tables: Dict[str, np.ndarray] = {}
        self.accums: Dict[str, np.ndarray] = {}
        self.optimizer = optimizer
        self.lr = lr
        self._lock = locks.named_lock("ps.tables", rank=34)
        # durability state (all mutated under ps.tables): the journal the
        # choke point fsyncs before each apply, the count of mutating ops
        # (snapshot cadence and journal file names), and the per-client
        # last-applied sequence map (exactly-once)
        self.snapshot_dir = snapshot_dir
        self._snap_every = (int(_flag("FLAGS_ps_snapshot_every_ops") or 0)
                            if snapshot_every_ops is None
                            else int(snapshot_every_ops))
        self.op_count = 0
        self.snapshots = 0  # committed by this process (the child's beat reports it)
        self.applied: Dict[str, int] = {}
        self._journal_path: Optional[str] = None
        if snapshot_dir:
            os.makedirs(snapshot_dir, exist_ok=True)
            self._recover()
            if self._journal_path is None:
                self._journal_path = os.path.join(
                    snapshot_dir, f"journal-{self.op_count}.log")
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        try:
                            op, payload = _recv_msg(self.request)
                        except ParamServerError as e:
                            # protocol violation: the stream is
                            # unsynchronized -- reply best-effort and drop
                            # the connection (never allocate the frame)
                            _MON.counter("ps.frame_rejects").inc()
                            try:
                                _send_msg(self.request, b"e",
                                          f"{type(e).__name__}: {e}"
                                          .encode())
                            except OSError:
                                pass
                            return
                        if op == b"Q":
                            _send_msg(self.request, b"q", b"")
                            outer._srv.shutdown()
                            return
                        try:
                            resp = outer._dispatch(op, payload)
                        except Exception as e:  # an error REPLY, not a dead socket
                            _send_msg(self.request, b"e",
                                      f"{type(e).__name__}: {e}".encode())
                            continue
                        _send_msg(self.request, op.lower(), resp)
                except (ConnectionError, OSError):
                    return

        class Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = Srv((host, port), Handler)
        self.endpoint = f"{self._srv.server_address[0]}:{self._srv.server_address[1]}"
        self._thread: Optional[threading.Thread] = None

    # -- durability --------------------------------------------------------
    def _journal(self, op: bytes, payload: bytes):
        """Write-ahead: the op is durable BEFORE it applies, so a replay
        after a crash reproduces exactly the applies that happened (plus at
        most the one the crash interrupted, whose client got no reply and
        retries, deduped by its sequence number).  A failing journal write
        (injected ENOSPC, a full disk) degrades durability, never
        availability: counted and recorded, the op still applies."""
        if self._journal_path is None:
            return
        from . import io as _io

        try:
            _io.append_record(self._journal_path, op + payload)
        except (OSError, StorageError) as e:
            _MON.counter("ps.journal_errors").inc()
            _MON.record_step({"kind": "sparse_event",
                              "action": "ps_journal_degraded",
                              "detail": f"{type(e).__name__}: {e}"})

    def _snapshot_locked(self):
        """Commit a full table snapshot through the io.py atomic choke
        point: per-table .npy payloads, a digest-stamped manifest, and a
        COMMITTED marker last -- a torn snapshot is invisible to recovery.
        Older snapshots and journals are pruned after the commit."""
        import glob as _glob
        import shutil

        from . import integrity as _integrity
        from . import io as _io

        snap = os.path.join(self.snapshot_dir, f"snap-{self.op_count}")
        os.makedirs(snap, exist_ok=True)
        entries = []
        for name in sorted(self.tables):
            safe = name.replace("/", "%2F")
            tf, af = f"{safe}.table.npy", f"{safe}.accum.npy"
            _io.save_array(os.path.join(snap, tf), self.tables[name])
            _io.save_array(os.path.join(snap, af), self.accums[name])
            entries.append({
                "name": name, "table_file": tf, "accum_file": af,
                "table_stamp": _integrity.stamp_file(os.path.join(snap, tf)),
                "accum_stamp": _integrity.stamp_file(os.path.join(snap, af)),
            })
        _io.atomic_write(os.path.join(snap, PS_MANIFEST), json.dumps({
            "op_count": self.op_count, "optimizer": self.optimizer,
            "lr": self.lr, "applied": dict(self.applied),
            "tables": entries}, indent=1))
        _io.atomic_write(os.path.join(snap, PS_COMMITTED), "")
        _MON.counter("ps.snapshots").inc()
        self.snapshots += 1
        # prune: everything older than the snapshot just committed derives
        # from it (best effort: a failed unlink costs disk, not correctness)
        self._journal_path = os.path.join(
            self.snapshot_dir, f"journal-{self.op_count}.log")
        for jp in _glob.glob(os.path.join(self.snapshot_dir, "journal-*.log")):
            try:
                if int(os.path.basename(jp)[8:-4]) < self.op_count:
                    os.remove(jp)
            except (ValueError, OSError):
                pass
        for sp in _glob.glob(os.path.join(self.snapshot_dir, "snap-*")):
            try:
                if int(os.path.basename(sp)[5:]) < self.op_count:
                    shutil.rmtree(sp, ignore_errors=True)
            except ValueError:
                pass

    def _snapshot_failed(self, e: BaseException):
        _MON.counter("ps.snapshot_errors").inc()
        _MON.record_step({"kind": "sparse_event",
                          "action": "ps_snapshot_failed",
                          "detail": f"{type(e).__name__}: {e}"})

    def snapshot(self):
        """Force a snapshot commit now (stop() does this; tests too)."""
        if not self.snapshot_dir:
            return
        with self._lock:  # lock-ok: the stop-the-world snapshot IS the consistency cut
            try:
                self._snapshot_locked()
            except (OSError, StorageError) as e:
                self._snapshot_failed(e)

    def _recover(self):
        """Rebuild tables, accumulators and the dedup map from the newest
        COMMITTED snapshot plus every journaled op after it: bit for bit
        the state the dead server had applied."""
        import glob as _glob

        from . import integrity as _integrity
        from . import io as _io

        snaps = []
        for sp in _glob.glob(os.path.join(self.snapshot_dir, "snap-*")):
            if os.path.exists(os.path.join(sp, PS_COMMITTED)):
                try:
                    snaps.append((int(os.path.basename(sp)[5:]), sp))
                except ValueError:
                    pass
        base = 0
        if snaps:
            base, snap = max(snaps)
            man = _io.read_json(os.path.join(snap, PS_MANIFEST))
            for e in man["tables"]:
                # a flipped byte in a host table at rest fails the
                # recovery, never serves: the stamps are verified first
                _integrity.verify_file_entry(
                    snap, e["table_file"], e["table_stamp"]["sha256"],
                    e["table_stamp"]["bytes"])
                _integrity.verify_file_entry(
                    snap, e["accum_file"], e["accum_stamp"]["sha256"],
                    e["accum_stamp"]["bytes"])
                self.tables[e["name"]] = np.array(
                    _io.load_array(os.path.join(snap, e["table_file"])))
                self.accums[e["name"]] = np.array(
                    _io.load_array(os.path.join(snap, e["accum_file"])))
            self.applied = {str(k): int(v)
                            for k, v in man.get("applied", {}).items()}
            self.op_count = int(man["op_count"])
        journals = []
        for jp in _glob.glob(os.path.join(self.snapshot_dir, "journal-*.log")):
            try:
                start = int(os.path.basename(jp)[8:-4])
            except ValueError:
                continue
            if start >= base:
                journals.append((start, jp))
        replayed = 0
        for _start, jp in sorted(journals):
            self._journal_path = jp
            for rec in _io.read_journal(jp):
                self._apply(rec[:1], rec[1:], journal=False)
                replayed += 1
        if snaps or replayed:
            _MON.counter("ps.recoveries").inc()
            _MON.record_step({"kind": "sparse_event",
                              "action": "ps_recovered",
                              "snapshot_ops": base, "replayed": replayed,
                              "op_count": self.op_count})

    def table_digest(self, name: str) -> str:
        """sha256 over the table and accumulator bytes (with shape and
        dtype): the host tier's content digest, compared across a
        crash-restart or against a snapshot."""
        with self._lock:
            t, a = self.tables[name], self.accums[name]
            h = hashlib.sha256()
            for arr in (t, a):
                h.update(str(arr.dtype).encode())
                h.update(str(arr.shape).encode())
                h.update(np.ascontiguousarray(arr).tobytes())
            return h.hexdigest()

    # -- server-side ops ---------------------------------------------------
    def _apply(self, op: bytes, payload: bytes, journal: bool = True) -> bytes:
        """One mutating op, under ps.tables: journal (write-ahead), then
        apply, then bump the op count and the dedup map.  `journal=False`
        is the recovery replay (the record is already durable)."""
        (nl,) = struct.unpack_from("<I", payload, 0)
        name = payload[4:4 + nl].decode()
        off = 4 + nl
        cid = seq = None
        if op == b"S":
            cid_raw, seq = struct.unpack_from("<QQ", payload, off)
            cid = f"{cid_raw:016x}"
            off += 16
            if seq <= self.applied.get(cid, -1):
                # the apply happened; the REPLY died with the old socket.
                # Exactly-once is this branch
                _MON.counter("ps.push_dedup").inc()
                return b""
        if journal:
            self._journal(op, payload)
        if op == b"C":
            arr, _ = _unpack_arr(payload, off)
            self.tables[name] = np.array(arr)
            self.accums[name] = np.zeros_like(self.tables[name])
        else:  # b"G" / b"S": a sparse row-gradient push
            ids, off2 = _unpack_arr(payload, off)
            grads, _ = _unpack_arr(payload, off2)
            t = self.tables[name]
            # MergeAdd first: duplicate rows sum BEFORE the accumulator
            # update, or adagrad drifts
            uniq, merged = _merge_rows(ids, grads)
            if self.optimizer == "adagrad":
                acc = self.accums[name]
                acc[uniq] += merged * merged
                t[uniq] += -self.lr * merged / (np.sqrt(acc[uniq]) + 1e-6)
            else:  # sgd
                t[uniq] += -self.lr * merged
        if cid is not None:
            self.applied[cid] = int(seq)
        self.op_count += 1
        if (journal and self.snapshot_dir and self._snap_every
                and self.op_count % self._snap_every == 0):
            try:
                self._snapshot_locked()
            except (OSError, StorageError) as e:
                self._snapshot_failed(e)
        return b""

    def _dispatch(self, op: bytes, payload: bytes) -> bytes:
        (nl,) = struct.unpack_from("<I", payload, 0)
        name = payload[4:4 + nl].decode()
        off = 4 + nl
        if op in (b"C", b"G", b"S"):
            with self._lock:  # lock-ok: the op-cadence snapshot inside _apply commits AT the op_count it names
                return self._apply(op, payload)
        if op == b"P":
            ids, _ = _unpack_arr(payload, off)
            with self._lock:
                rows = self.tables[name][ids.astype(np.int64)]
            return _pack_arr(rows)
        if op == b"F":
            with self._lock:
                return _pack_arr(self.tables[name])
        if op == b"D":
            return self.table_digest(name).encode()
        raise ValueError(f"parameter server: unknown op {op!r}")

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()
        self.snapshot()


class KVClient:
    """Pserver RPC client with fault tolerance: socket deadlines
    (`FLAGS_ps_timeout_s`), transparent reconnect and seeded-backoff retry
    of transient failures (`FLAGS_ps_retries`), classified
    `ParamServerError`s, and exactly-once pushes -- every push carries this
    client's id and a growing sequence number the server dedups, so a retry
    whose original APPLY landed (only the reply died) is a no-op there."""

    def __init__(self, endpoint: str, timeout_s: Optional[float] = None,
                 retries: Optional[int] = None,
                 backoff_base_s: float = 0.05, seed: int = 0):
        host, port = endpoint.rsplit(":", 1)
        self.endpoint = endpoint
        self._addr = (host, int(port))
        self._timeout = _timeout_s() if timeout_s is None else (
            timeout_s if timeout_s > 0 else None)
        self._retries = max(1, int(_flag("FLAGS_ps_retries") or 1)
                            if retries is None else int(retries))
        self._backoff = float(backoff_base_s)
        self._rng = np.random.RandomState(seed)
        # exactly-once identity: survives reconnects (the same client object
        # is the same dedup stream); a NEW client is a new stream by design
        self.client_id = int.from_bytes(os.urandom(8), "little")
        self._seq = 0
        self._lock = locks.named_lock("ps.client", rank=36)
        self._sock: Optional[socket.socket] = None
        with self._lock:  # lock-ok: connect is part of the serialized framed exchange; FLAGS_ps_timeout_s bounds the hold
            self._connect_locked()

    # -- wiring ------------------------------------------------------------
    def _connect_locked(self):
        self._sock = socket.create_connection(self._addr,
                                              timeout=self._timeout)

    def _close_locked(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _ps_error(self, exc: BaseException, op: str,
                  attempts: int) -> ParamServerError:
        attach_context(exc, phase="pserver")
        e = classify(exc)
        if not isinstance(e, ParamServerError):
            e = ParamServerError(f"{type(exc).__name__}: {exc}")
            e.__cause__ = exc
        e.op = op
        e.endpoint = self.endpoint
        if attempts > 1 and e.transient:
            e.args = (f"{e.args[0]} (after {attempts} attempts — is the "
                      f"pserver's supervisor out of restart budget?)",)
        return e

    def _call(self, op: bytes, name: str, *arrays,
              seq_prefix: bytes = b"") -> bytes:
        opname = {b"P": "pull", b"G": "push", b"S": "push", b"C": "create",
                  b"F": "fetch", b"D": "digest", b"Q": "shutdown"}.get(
                      op, op.decode(errors="replace"))
        payload = struct.pack("<I", len(name)) + name.encode() + seq_prefix
        for a in arrays:
            payload += _pack_arr(np.asarray(a))
        attempt = 0
        while True:
            attempt += 1
            try:
                with self._lock:  # lock-ok: one request/response exchange on one shared socket
                    if self._sock is None:
                        self._connect_locked()
                    _send_msg(self._sock, op, payload)
                    rop, resp = _recv_msg(self._sock)
                break
            except ParamServerError as e:
                # protocol violation (bad magic, oversized frame): the
                # stream is unsynchronized -- terminal, the connection dies
                with self._lock:
                    self._close_locked()
                e.op, e.endpoint = opname, self.endpoint
                raise
            except (OSError, TimeoutError) as e:
                with self._lock:
                    self._close_locked()
                pe = self._ps_error(e, opname, attempt)
                if not pe.transient or attempt >= self._retries:
                    raise pe from e
                _MON.counter("ps.retries").inc()
                # seeded exponential backoff with jitter: the supervisor
                # needs a beat or two to notice the corpse and respawn it
                time.sleep(self._backoff * (2 ** (attempt - 1))
                           * (0.5 + self._rng.rand()))
        if rop == b"e":
            raise ParamServerError(
                f"parameter server error: {resp.decode()}", op=opname,
                endpoint=self.endpoint, transient=False)
        return resp

    # -- ops ---------------------------------------------------------------
    def create(self, name: str, array: np.ndarray):
        self._call(b"C", name, array)

    def pull(self, name: str, ids: np.ndarray) -> np.ndarray:
        resp = self._call(b"P", name, np.asarray(ids, np.int64))
        return _unpack_arr(resp)[0]

    def push(self, name: str, ids: np.ndarray, grads: np.ndarray):
        """Sequenced push: the sequence number is allocated ONCE per
        logical push, before any wire attempt, so every retry of this push
        carries the same one and the server applies it exactly once however
        many replies are lost."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        self._call(b"S", name, np.asarray(ids, np.int64), grads,
                   seq_prefix=struct.pack("<QQ", self.client_id, seq))

    def fetch_table(self, name: str) -> np.ndarray:
        return _unpack_arr(self._call(b"F", name))[0]

    def table_digest(self, name: str) -> str:
        """The server's content digest of table + accumulator: the
        comparison point across a restart or a snapshot."""
        return self._call(b"D", name).decode()

    def close(self):
        with self._lock:
            self._close_locked()


# ---- the supervised pserver process ------------------------------------------

class PServerSupervisor:
    """Crash-restart supervision of a pserver PROCESS, the serving fleet's
    replica supervision applied to the host tier: the server runs as a
    child process (so a SIGKILL is survivable), writes `ReplicaBeat`
    beats, and this supervisor's watch thread classifies it with
    `FleetHealth` -- a dead OR wedged (beats stopped: SIGSTOP, a hard hang)
    child is killed and respawned under `max_restarts`, recovering its
    tables from the journal.  The endpoint is FIXED across incarnations,
    so `KVClient`'s reconnect-retry loop rides a restart out without any
    coordination.  Past the budget the supervisor gives up loudly
    (`pserver_give_up` fleet event) and clients fail into the embedding
    tier's bounded degraded mode.  The child is `python -m
    paddle_tpu_torch.param_server` with `CUDA_VISIBLE_DEVICES` empty: a
    host service never opens a CUDA context on the card."""

    def __init__(self, snapshot_dir: str, host: str = "127.0.0.1",
                 port: int = 0, optimizer: str = "sgd", lr: float = 0.1,
                 max_restarts: int = 3, poll_interval_s: float = 0.1,
                 beat_interval_s: float = 0.2, miss_factor: float = 6.0,
                 startup_grace_s: float = 60.0,
                 snapshot_every_ops: Optional[int] = None):
        from .dist_resilience import FleetHealth
        from .launch import allocate_port_block

        self.snapshot_dir = snapshot_dir
        os.makedirs(snapshot_dir, exist_ok=True)
        self.host = host
        # a free port below the kernel's ephemeral range: the endpoint is
        # kept across restarts, and a port in that range could be taken by an
        # outgoing connection's local end while the child restarts
        self.port = port or allocate_port_block(1)
        self.endpoint = f"{host}:{self.port}"
        self.optimizer, self.lr = optimizer, lr
        self.max_restarts = int(max_restarts)
        self.restarts = 0
        self.failed = False
        self._poll = float(poll_interval_s)
        self._snap_every = snapshot_every_ops
        self.hb_dir = os.path.join(snapshot_dir, "hb")
        os.makedirs(self.hb_dir, exist_ok=True)
        self._health = FleetHealth(self.hb_dir, world=1,
                                   interval_s=beat_interval_s,
                                   miss_factor=miss_factor,
                                   startup_grace_s=startup_grace_s)
        self._beat_interval = beat_interval_s
        self._proc: Optional[subprocess.Popen] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = locks.named_lock("ps.supervisor", rank=28)

    # -- child lifecycle ---------------------------------------------------
    def _spawn_locked(self):
        from .launch import REPO_ROOT

        # -W: the package imports this module before runpy executes it
        argv = [sys.executable, "-W", "ignore::RuntimeWarning:runpy",
                "-m", "paddle_tpu_torch.param_server",
                "--host", self.host, "--port", str(self.port),
                "--optimizer", self.optimizer, "--lr", str(self.lr),
                "--snapshot-dir", self.snapshot_dir,
                "--hb-dir", self.hb_dir,
                "--beat-interval-s", str(self._beat_interval)]
        if self._snap_every is not None:
            argv += ["--snapshot-every-ops", str(self._snap_every)]
        env = dict(os.environ)
        # the child is a host service: it never takes the card, and a fault
        # spec aimed at the TRAINING process stays out of it
        env["CUDA_VISIBLE_DEVICES"] = ""
        env.pop("FLAGS_fault_spec", None)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (REPO_ROOT, env.get("PYTHONPATH")) if p)
        self._health.note_restart(0)
        self._proc = subprocess.Popen(argv, env=env)
        _MON.gauge("ps.supervisor_restarts").set(self.restarts)

    def start(self) -> "PServerSupervisor":
        with self._lock:  # lock-ok: child lifecycle transitions (spawn/kill/respawn) serialize here
            if self._proc is None:
                self._spawn_locked()
                record_fleet_event("pserver_started", endpoint=self.endpoint,
                                   pid=self._proc.pid)
        if self._thread is None:
            self._thread = threading.Thread(target=self._watch,
                                            name="ptt-ps-supervisor",
                                            daemon=True)
            self._thread.start()
        return self

    def wait_ready(self, timeout_s: float = 60.0):
        """Block until the child's first beat lands (the server binds before
        it beats, so it accepts connections by then)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._health.poll()[0]["status"] in ("alive", "draining"):
                return self
            if self.failed:
                break
            time.sleep(self._poll)
        raise ParamServerError(
            f"pserver at {self.endpoint} never became ready within "
            f"{timeout_s}s", endpoint=self.endpoint, transient=False)

    def _watch(self):
        while not self._stop.wait(self._poll):
            with self._lock:  # lock-ok: the death verdict and the respawn are atomic against kill()/stop(); proc.wait is bounded
                proc = self._proc
                if proc is None or self.failed:
                    continue
                dead = proc.poll() is not None
                stalled = (not dead
                           and self._health.poll()[0]["status"] == "dead")
                if not dead and not stalled:
                    continue
                reason = "exit" if dead else "stalled"
                if stalled:
                    # a wedged child (SIGSTOP, a hard hang) is as gone as a
                    # dead one: make the verdict physical, then respawn
                    _MON.counter("ps.stall_kills").inc()
                    try:
                        proc.kill()
                        proc.wait(timeout=10)
                    except (OSError, subprocess.TimeoutExpired):
                        pass
                record_fleet_event("pserver_dead", endpoint=self.endpoint,
                                   reason=reason, pid=proc.pid,
                                   returncode=proc.returncode)
                if self.restarts >= self.max_restarts:
                    self.failed = True
                    record_fleet_event("pserver_give_up",
                                       endpoint=self.endpoint,
                                       restarts=self.restarts)
                    continue
                self.restarts += 1
                self._spawn_locked()
                record_fleet_event("pserver_restarted",
                                   endpoint=self.endpoint,
                                   restarts=self.restarts,
                                   pid=self._proc.pid)

    # -- chaos hooks (faults.py kill_pserver / stall_pserver) -------------
    def kill(self, sig: int = signal.SIGKILL):
        """SIGKILL the child (the kill_pserver chaos arm): the watch thread
        notices the corpse within one poll and respawns it."""
        with self._lock:
            if self._proc is not None and self._proc.poll() is None:
                try:
                    os.kill(self._proc.pid, sig)
                except OSError:
                    pass

    def stall(self, seconds: float):
        """SIGSTOP the child for `seconds` (the stall_pserver chaos arm):
        its beats stop, FleetHealth calls it dead past the deadline, and the
        watch thread kills and respawns it -- a wedged pserver is a dead one
        that still holds a port."""
        with self._lock:
            proc = self._proc
        if proc is None or proc.poll() is not None:
            return
        try:
            os.kill(proc.pid, signal.SIGSTOP)
        except OSError:
            return

        def _resume():
            try:
                os.kill(proc.pid, signal.SIGCONT)
            except OSError:
                pass

        t = threading.Timer(seconds, _resume)
        t.daemon = True
        t.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            proc, self._proc = self._proc, None
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)


def _serve_main(argv=None) -> int:
    """`python -m paddle_tpu_torch.param_server`: the supervised child.
    Runs a ParameterServer (recovering from --snapshot-dir) plus a
    ReplicaBeat the supervisor's FleetHealth watches; SIGTERM snapshots and
    exits."""
    import argparse

    ap = argparse.ArgumentParser(prog="paddle_tpu_torch.param_server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--snapshot-dir", default=None)
    ap.add_argument("--snapshot-every-ops", type=int, default=None)
    ap.add_argument("--hb-dir", default=None)
    ap.add_argument("--beat-interval-s", type=float, default=0.2)
    args = ap.parse_args(argv)
    srv = ParameterServer(args.host, args.port, args.optimizer, args.lr,
                          snapshot_dir=args.snapshot_dir,
                          snapshot_every_ops=args.snapshot_every_ops)
    beat = None
    if args.hb_dir:
        from .dist_resilience import ReplicaBeat

        beat = ReplicaBeat(
            args.hb_dir, rank=0, world=1, interval_s=args.beat_interval_s,
            payload_fn=lambda: {"ops": srv.op_count, "snapshots": srv.snapshots,
                                "tables": sorted(srv.tables),
                                "endpoint": srv.endpoint}).start()
    done = threading.Event()

    def _term(_sig, _frm):
        done.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    srv.start()
    done.wait()
    if beat is not None:
        beat.stop(mark_down=True)
    srv.stop()
    return 0


class HostTableEmbedding:
    """Out-of-HBM embedding: the device program sees only the pulled rows
    (a [B*, D] dense feed whose lookup ids are batch-local positions); the
    V x D table lives on the parameter server (reference
    parameter_prefetch.cc flow).

    Per step: (unique_ids, local_ids) <- batch ids; rows <- pull; run the
    program with rows + local ids; push the rows' gradient back.

    Degraded mode: with `degraded_ok=True`, a TRANSIENT pserver failure (its
    supervisor is mid-restart, or out of budget) does not wedge the step --
    `prepare_batch` serves ZERO rows for the cold tail and `push_grad`
    drops the slab (counted), while the `sparse.host_lag_steps` gauge
    counts the consecutive degraded steps.  Past `FLAGS_max_host_lag_steps`
    (when set) the next failure raises TERMINAL: online learning must not
    silently diverge from its cold tail forever."""

    def __init__(self, client: KVClient, name: str, dim: int,
                 degraded_ok: bool = False):
        self.client = client
        self.name = name
        self.dim = dim
        self.degraded_ok = bool(degraded_ok)
        self.host_lag_steps = 0

    def _degrade(self, e: ParamServerError, action: str):
        if not (self.degraded_ok and e.transient):
            raise e
        self.host_lag_steps += 1
        _MON.gauge("sparse.host_lag_steps").set(self.host_lag_steps)
        _MON.counter("sparse.degraded_steps").inc()
        _MON.record_step({"kind": "sparse_event",
                          "action": "host_tier_degraded", "table": self.name,
                          "during": action, "lag_steps": self.host_lag_steps,
                          "detail": str(e)})
        bound = int(_flag("FLAGS_max_host_lag_steps") or 0)
        if bound and self.host_lag_steps > bound:
            raise ParamServerError(
                f"host table tier down for {self.host_lag_steps} "
                f"consecutive degraded steps, past "
                f"FLAGS_max_host_lag_steps={bound} — the cold tail of "
                f"{self.name!r} has diverged too far to keep training",
                op=action, endpoint=self.client.endpoint,
                transient=False) from e

    def _recovered(self):
        if self.host_lag_steps:
            _MON.record_step({"kind": "sparse_event",
                              "action": "host_tier_recovered",
                              "table": self.name,
                              "lag_steps": self.host_lag_steps})
        self.host_lag_steps = 0
        _MON.gauge("sparse.host_lag_steps").set(0)

    def prepare_batch(self, ids: np.ndarray):
        uniq, local = np.unique(ids.reshape(-1), return_inverse=True)
        try:
            rows = self.client.pull(self.name, uniq)
            self._recovered()
        except ParamServerError as e:
            self._degrade(e, "pull")
            rows = np.zeros((uniq.size, self.dim), np.float32)
        return uniq, local.reshape(ids.shape).astype(np.int64), rows

    def push_grad(self, uniq: np.ndarray, grad_rows: np.ndarray):
        try:
            self.client.push(self.name, uniq, np.asarray(grad_rows))
        except ParamServerError as e:
            # a degraded step trains hot-shard-only: this slab is DROPPED,
            # never queued -- queueing would reorder it against the
            # sequenced stream and break exactly-once
            self._degrade(e, "push")
            _MON.counter("sparse.dropped_pushes").inc()


class AsyncCommunicator:
    """Asynchronous push/pull for host tables (reference
    operators/distributed/communicator.cc -- SendThread:104 batches and
    merges queued grads, RecvThread:200 refreshes params periodically;
    async-PS semantics: no barriers, bounded staleness).

    push_async() enqueues and returns at once; a background thread merges
    the queued slabs of each table (MergeAdd) and pushes them.  pull()
    reads through to the server (rows may be stale by whatever is still
    queued: that staleness IS the async contract)."""

    def __init__(self, client: KVClient, send_interval_s: float = 0.01):
        self._client = client
        self._interval = send_interval_s
        self._queues: Dict[str, list] = {}
        self._lock = locks.named_lock("ps.queue", rank=32)
        # serializes in-flight drains (rank 30: held ACROSS ps.queue and the
        # ps.client push -- that span is the flush() barrier contract)
        self._drain_lock = locks.named_lock("ps.drain", rank=30)
        self._stop = threading.Event()
        self._woke = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._send_loop, daemon=True)
        self._thread.start()
        return self

    def push_async(self, name: str, ids: np.ndarray, grads: np.ndarray):
        if self._error is not None:
            raise RuntimeError("AsyncCommunicator sender died") from self._error
        with self._lock:
            self._queues.setdefault(name, []).append(
                (np.asarray(ids, np.int64).reshape(-1), np.asarray(grads)))
        self._woke.set()

    def pull(self, name: str, ids: np.ndarray) -> np.ndarray:
        return self._client.pull(name, ids)

    def _drain_one(self):
        # drains are mutually exclusive, so flush() returns only after any
        # in-flight send completes (the barrier contract)
        with self._drain_lock:  # lock-ok: the flush() barrier holds this across the merge and push; push_async never takes it
            with self._lock:
                items = {n: q for n, q in self._queues.items() if q}
                self._queues = {}
            for name, slabs in items.items():
                ids = np.concatenate([i for i, _ in slabs])
                grads = np.concatenate([g for _, g in slabs])
                uniq, merged = _merge_rows(ids, grads)
                self._client.push(name, uniq, merged)

    def _send_loop(self):
        while not self._stop.is_set():
            self._woke.wait(timeout=self._interval)
            self._woke.clear()
            try:
                self._drain_one()
            except BaseException as e:  # surfaces on the next push/flush
                self._error = e
                return

    def flush(self):
        """Synchronize: drain everything queued AND wait out any in-flight
        send (the barrier before an eval or a save)."""
        if self._error is not None:
            raise RuntimeError("AsyncCommunicator sender died") from self._error
        self._drain_one()

    def stop(self):
        self._stop.set()
        self._woke.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._drain_one()
        if self._error is not None:
            raise RuntimeError("AsyncCommunicator sender died") from self._error


if __name__ == "__main__":
    sys.exit(_serve_main())

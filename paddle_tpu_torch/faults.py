"""Deterministic fault injection (counterpart of paddle_tpu/faults.py): the
chaos harness that proves the resilience layer survives what it claims
to survive, with the JAX package's whole grammar.

Every recovery path that is not tested is broken; this module makes the
failure classes of errors.py reproducible, on the CPU and on the card.
Single-process and host-tier entries fire as in the JAX package.  Every
entry parses; a `FaultInjector` given an entry that targets a worker rank
of a gang (kill_worker, stall_worker, flip_bit:RANK, enospc:RANK,
ro_fs:RANK) raises NotImplementedError naming ROADMAP A10.  A
`FaultInjector` is driven by a
schedule string (`FLAGS_fault_spec` or the constructor), every entry
fires exactly once, and nothing here depends on wall time or real
hardware — the same spec injects the same faults at the same points on
every run.

Spec grammar (entries separated by ';', whitespace ignored):

    bad_batch@B           raw loader batch B raises DataError when pulled
    nan@S                 the feed of train step S gets a planted NaN (in
                          its first floating-point array, numpy or tensor), so
                          the real computation produces NaN and the
                          FLAGS_check_nan_inf guard trips at resolution
    device@S[:CODE]       dispatch of train step S raises
                          TransientDeviceError (CODE defaults to
                          UNAVAILABLE; RESOURCE_EXHAUSTED exercises the
                          max_inflight degradation path)
    preempt@S             dispatch of train step S delivers SIGTERM to
                          this process (the real preemption notice, so
                          the loop's deferred-flush handler is what gets
                          tested)

data-layer entries mutate RecordIO files ON DISK via the
`on_files` hook (called by tests/bench with the pipeline's file list
before the loader opens them), so the corruption exercises the real
native scanner + CRC + FLAGS_data_corrupt_budget machinery:

    corrupt_chunk@N       flip a payload byte of global chunk N (counted
                          across the file list) — the CRC catches it and
                          the budget decides skip vs abort
    truncated_file@N      cut the file mid-payload of global chunk N (the
                          torn-write / partial-copy failure mode)

distributed entries target a specific worker RANK of a gang (they parse;
the gang that fires them, and its once-per-gang ledger, come with A10):

    kill_worker@S:RANK        worker RANK dies with SIGKILL at dispatch
                              of train step S — no cleanup, no tombstone:
                              the hard death peers must detect by
                              heartbeat staleness
    stall_worker@S:RANK:SECS  worker RANK sleeps SECS at dispatch of
                              step S (the straggler that trips the
                              collective watchdog when SECS exceeds its
                              deadline)

silent-corruption entries plant wrong-but-FINITE state — the
class every NaN guard, CRC, and structure check waves through, which
only the integrity sentinel (integrity.py) can catch:

    flip_bit@S[:RANK]     at the dispatch boundary of train step S (the
                          feed/snapshot boundary — `on_state`, called by
                          resilient_train_loop with the scope), flip one
                          exponent-region bit of one element of the
                          LARGEST float state var: the value stays finite
                          but wildly implausible, and only a content
                          digest can see it.  The :RANK form (the gang's
                          divergence vote must name RANK) is A10's
    rot_shard@N           flip a payload byte of one shard file of the
                          Nth COMMITTED checkpoint (0-based commit
                          ordinal; `on_commit`, called post-COMMIT) —
                          restore's walk-back must reject the rotted
                          checkpoint by digest and the publish ladder
                          must quarantine it

storage entries fire inside the I/O choke point every
checkpoint/manifest/sidecar/model-store byte routes through
(`io.atomic_write` / `io.open_for_read`; `arm_io()` registers this
injector as the hook, `disarm_io()` removes it —
`resilient_train_loop` arms automatically).  Step-window kinds track
the current train step via `on_dispatch`/`set_step`; op-indexed kinds
count choke-point operations.  Two exemptions keep injection
deterministic: paths under `FLAGS_ckpt_fallback_dir` (the fallback dir
models a different device, so a full primary disk must not also break
it) and the prefixes io.py marks exempt:

    enospc@S[:RANK]       every WRITE during train step S raises
                          OSError(ENOSPC) — the save at step S fails
                          all its retries, the next period's succeeds
                          (the transient-full-disk window).  The :RANK
                          form (one worker's writes) is A10's
    ro_fs@S[:RANK]        every WRITE from step S ONWARD raises
                          OSError(EROFS) — the terminal read-only-mount
                          class that must skip retries and go straight
                          to the fallback dir / degraded mode (:RANK as
                          for enospc)
    eio@N[:PATH_GLOB]     the Nth (0-based) choke-point operation (read
                          or write) whose path fnmatches PATH_GLOB
                          (default *) raises OSError(EIO), exactly once
                          — the one-shot flaky read a retry survives
    slow_io@N:MS          the Nth choke-point operation sleeps MS
                          milliseconds first (storage latency spike),
                          then proceeds

host-tier entries target the supervised parameter server of an
online-learning run (`set_pserver(supervisor)` registers the live handle;
entries stay pending without one):

    kill_pserver@S        SIGKILL the pserver CHILD PROCESS at dispatch
                          of train step S — the supervisor must respawn
                          it (journal recovery, bit-identical) and
                          KVClient's retry loop must ride out the gap
    stall_pserver@S:SECS  SIGSTOP the pserver child for SECS at dispatch
                          of step S: beats stop, FleetHealth declares it
                          dead past the deadline, the supervisor
                          kill+respawns (the wedged-not-dead mode)
    rot_row@N             flip a payload byte of a SelectedRows VALUES
                          shard of the Nth COMMITTED snapshot
                          (`on_commit`, like rot_shard) — the flipped
                          row is finite and silent; the publish ladder's
                          sparse digest rung must quarantine it

    e.g.  FLAGS_fault_spec="bad_batch@2;nan@5;device@7:RESOURCE_EXHAUSTED;preempt@11"
          FLAGS_fault_spec="kill_worker@3:1;stall_worker@6:0:0.2"
          FLAGS_fault_spec="flip_bit@5:1;rot_shard@0"
          FLAGS_fault_spec="enospc@4:1;eio@0:*__manifest__*;slow_io@2:250"

`seed` only feeds the poison-value RNG; firing points are exact indices.
The hooks (`on_batch`, `on_feed`, `on_dispatch`) are called by
`resilient_train_loop`'s feed path and dispatch callback; they are cheap
no-ops once every entry has fired.

Compound schedules: `KIND_INFO` publishes per-kind
compatibility metadata (what the index counts, which runtime hooks the
kind needs, whether the JAX package's gang ledger keeps its firing
across gang restarts), the same table as the JAX package's;
`validate_schedule` rejects specs with exact-duplicate entries,
capability mismatches, or unreachable pairings (an enospc window
shadowed by an earlier ro_fs).
"""
from __future__ import annotations

__all__ = ["Fault", "FaultInjector", "parse_fault_spec", "KIND_INFO",
           "validate_schedule"]

import errno as _errno
import fnmatch
import os
import random
import signal
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .errors import DataError, TransientDeviceError
from .monitor import MONITOR as _MON

_KINDS = ("bad_batch", "nan", "device", "preempt",
          "kill_worker", "stall_worker",
          "corrupt_chunk", "truncated_file",
          "flip_bit", "rot_shard",
          "enospc", "eio", "slow_io", "ro_fs",
          "kill_pserver", "stall_pserver", "rot_row")
# entries that always target a worker rank (flip_bit, enospc and ro_fs
# take one optionally: target_rank answers None for their rankless form)
_RANKED_KINDS = ("kill_worker", "stall_worker")
# storage faults: fire inside the io.py choke point via the
# on_io hook.  enospc/ro_fs are step-WINDOW kinds (active while the
# tracked train step is at/past their index — a save's whole retry
# sequence at step S fails, the next period's save succeeds); eio/
# slow_io are op-INDEXED one-shots (the Nth matching choke-point
# operation)
_STORAGE_KINDS = ("enospc", "eio", "slow_io", "ro_fs")
_STORAGE_ERRNO = {"enospc": _errno.ENOSPC, "eio": _errno.EIO,
                  "ro_fs": _errno.EROFS}
# on-disk data faults: mutate RecordIO files handed to
# `on_files` — corrupt_chunk@N flips a payload byte of the Nth chunk
# (CRC catches it), truncated_file@N cuts the file mid-payload of the
# Nth chunk.  Both exercise the recordio corrupt-budget path
_FILE_KINDS = ("corrupt_chunk", "truncated_file")
# entries the JAX package's gang ledger keeps across gang restarts (a
# restarted gang replays the failed step; KIND_INFO's `ledgered`)
_LEDGER_KINDS = _RANKED_KINDS + _FILE_KINDS \
    + ("flip_bit", "rot_shard", "rot_row",
       "kill_pserver", "stall_pserver") + _STORAGE_KINDS

# Per-kind compatibility metadata.  A chaos campaign
# generator draws schedules from this table; scenarios declare the
# capabilities they provide and only kinds whose `needs` are covered are
# eligible.  Fields:
#   grammar  — the spec-grammar line, verbatim from the docstring table
#              (the self-consistency test asserts it appears there)
#   scope    — what the entry's index counts: "batch" (raw loader
#              batch), "step" (train step), "chunk" (global RecordIO
#              chunk), "commit" (committed checkpoint ordinal), "op"
#              (choke-point I/O operation)
#   needs    — runtime hooks/capabilities the kind requires to fire:
#              "loader" (on_batch), "feed" (on_feed), "dispatch"
#              (on_dispatch), "scope" (on_state with a live scope),
#              "commit" (on_commit), "files" (on_files with RecordIO
#              paths), "io" (arm_io around real io.py traffic), "gang"
#              (a multi-worker gang whose supervisor restarts the
#              victim), "pserver" (a registered PServerSupervisor)
#   ledgered — the JAX package's gang ledger keeps the firing across
#              gang restarts
#   example  — one valid spec entry (parse_fault_spec must accept it)
KIND_INFO = {
    "bad_batch": dict(grammar="bad_batch@B", scope="batch",
                      needs=("loader",), example="bad_batch@2"),
    "nan": dict(grammar="nan@S", scope="step",
                needs=("feed",), example="nan@3"),
    "device": dict(grammar="device@S[:CODE]", scope="step",
                   needs=("dispatch",), example="device@4:UNAVAILABLE"),
    "preempt": dict(grammar="preempt@S", scope="step",
                    needs=("dispatch",), example="preempt@5"),
    "kill_worker": dict(grammar="kill_worker@S:RANK", scope="step",
                        needs=("dispatch", "gang"),
                        example="kill_worker@3:1"),
    "stall_worker": dict(grammar="stall_worker@S:RANK:SECS", scope="step",
                         needs=("dispatch", "gang"),
                         example="stall_worker@6:0:0.2"),
    "corrupt_chunk": dict(grammar="corrupt_chunk@N", scope="chunk",
                          needs=("files",), example="corrupt_chunk@1"),
    "truncated_file": dict(grammar="truncated_file@N", scope="chunk",
                           needs=("files",), example="truncated_file@1"),
    "flip_bit": dict(grammar="flip_bit@S[:RANK]", scope="step",
                     needs=("scope",), example="flip_bit@5:1"),
    "rot_shard": dict(grammar="rot_shard@N", scope="commit",
                      needs=("commit",), example="rot_shard@0"),
    "enospc": dict(grammar="enospc@S[:RANK]", scope="step",
                   needs=("io",), example="enospc@4"),
    "ro_fs": dict(grammar="ro_fs@S[:RANK]", scope="step",
                  needs=("io",), example="ro_fs@6"),
    "eio": dict(grammar="eio@N[:PATH_GLOB]", scope="op",
                needs=("io",), example="eio@0"),
    "slow_io": dict(grammar="slow_io@N:MS", scope="op",
                    needs=("io",), example="slow_io@2:250"),
    "kill_pserver": dict(grammar="kill_pserver@S", scope="step",
                         needs=("dispatch", "pserver"),
                         example="kill_pserver@3"),
    "stall_pserver": dict(grammar="stall_pserver@S:SECS", scope="step",
                          needs=("dispatch", "pserver"),
                          example="stall_pserver@3:0.5"),
    "rot_row": dict(grammar="rot_row@N", scope="commit",
                    needs=("commit", "pserver"), example="rot_row@0"),
}
for _k, _info in KIND_INFO.items():
    _info["ledgered"] = _k in _LEDGER_KINDS


@dataclass
class Fault:
    kind: str
    at: int
    arg: Optional[str] = None
    fired: bool = False
    # op-indexed storage entries count their matching choke-point
    # operations here
    seen: int = 0

    def __str__(self):
        s = f"{self.kind}@{self.at}"
        return f"{s}:{self.arg}" if self.arg else s

    @property
    def target_rank(self) -> Optional[int]:
        """Worker rank a ranked entry targets (None for per-process kinds
        and for the rankless flip_bit@S / enospc@S / ro_fs@S forms)."""
        if self.kind in ("flip_bit", "enospc", "ro_fs"):
            return int(self.arg) if self.arg else None
        if self.kind not in _RANKED_KINDS or not self.arg:
            return None
        return int(self.arg.split(":", 1)[0])

    @property
    def slow_ms(self) -> float:
        assert self.kind == "slow_io"
        return float(self.arg)

    @property
    def pserver_stall_s(self) -> float:
        assert self.kind == "stall_pserver"
        return float(self.arg)


def parse_fault_spec(spec: str) -> List[Fault]:
    faults = []
    for raw in (spec or "").split(";"):
        entry = raw.strip()
        if not entry:
            continue
        kind, sep, rest = entry.partition("@")
        kind = kind.strip()
        if not sep or kind not in _KINDS:
            raise ValueError(
                f"fault spec entry {entry!r}: want kind@N[:arg] with kind in "
                f"{_KINDS} (full spec {spec!r})")
        at_s, _, arg = rest.partition(":")
        try:
            at = int(at_s)
        except ValueError:
            raise ValueError(f"fault spec entry {entry!r}: {at_s!r} is not "
                             f"an integer index")
        arg = arg.strip() or None
        f = Fault(kind, at, arg)
        if kind == "kill_worker":
            if arg is None or not arg.isdigit():
                raise ValueError(f"fault spec entry {entry!r}: want "
                                 f"kill_worker@STEP:RANK")
        elif kind == "stall_worker":
            parts = (arg or "").split(":")
            ok = len(parts) == 2 and parts[0].isdigit()
            if ok:
                try:
                    float(parts[1])
                except ValueError:
                    ok = False
            if not ok:
                raise ValueError(f"fault spec entry {entry!r}: want "
                                 f"stall_worker@STEP:RANK:SECONDS")
        elif kind == "flip_bit":
            if arg is not None and not arg.isdigit():
                raise ValueError(f"fault spec entry {entry!r}: want "
                                 f"flip_bit@STEP or flip_bit@STEP:RANK")
        elif kind == "rot_shard":
            if arg is not None:
                raise ValueError(f"fault spec entry {entry!r}: want "
                                 f"rot_shard@COMMIT_INDEX (no extra arg)")
        elif kind in ("enospc", "ro_fs"):
            if arg is not None and not arg.isdigit():
                raise ValueError(f"fault spec entry {entry!r}: want "
                                 f"{kind}@STEP or {kind}@STEP:RANK")
        elif kind == "slow_io":
            try:
                ok = arg is not None and float(arg) >= 0
            except ValueError:
                ok = False
            if not ok:
                raise ValueError(f"fault spec entry {entry!r}: want "
                                 f"slow_io@OP_INDEX:MILLISECONDS")
        elif kind in ("kill_pserver", "rot_row"):
            if arg is not None:
                raise ValueError(f"fault spec entry {entry!r}: want "
                                 f"{kind}@{'STEP' if kind == 'kill_pserver' else 'COMMIT_INDEX'} (no extra arg)")
        elif kind == "stall_pserver":
            try:
                ok = arg is not None and float(arg) > 0
            except ValueError:
                ok = False
            if not ok:
                raise ValueError(f"fault spec entry {entry!r}: want "
                                 f"stall_pserver@STEP:SECONDS")
        faults.append(f)
    return faults


def validate_schedule(spec, capabilities=None) -> List[Fault]:
    """Compound-schedule validation: parse `spec` (a
    FLAGS_fault_spec string or an already-parsed fault list) and reject
    schedules that cannot behave deterministically as a compound:

      * exact-duplicate entries — the second copy could never fire (the
        ledger marker or the one-shot latch suppresses it), so the spec
        would silently mean less than it says;
      * entries whose `needs` (KIND_INFO) exceed `capabilities` — when a
        capability set is given, every entry must be able to fire in the
        scenario providing it;
      * an enospc window at/after a ro_fs window targeting the same rank
        — ro_fs fails every later write first, so the enospc entry is
        unreachable dead weight.

    Returns the parsed fault list on success; raises ValueError naming
    the offending entries otherwise."""
    faults = parse_fault_spec(spec) if isinstance(spec, str) else list(spec)
    seen: set = set()
    for f in faults:
        key = (f.kind, f.at, f.arg)
        if key in seen:
            raise ValueError(
                f"fault schedule {spec!r}: duplicate entry {f} — the "
                f"second copy can never fire (one-shot latch / ledger "
                f"marker suppresses it)")
        seen.add(key)
    if capabilities is not None:
        caps = frozenset(capabilities)
        for f in faults:
            missing = [n for n in KIND_INFO[f.kind]["needs"]
                       if n not in caps]
            if missing:
                raise ValueError(
                    f"fault schedule {spec!r}: entry {f} needs "
                    f"{missing} but the scenario only provides "
                    f"{sorted(caps)}")
    ro = [f for f in faults if f.kind == "ro_fs"]
    for f in faults:
        if f.kind != "enospc":
            continue
        for r in ro:
            same_rank = (r.target_rank is None
                         or f.target_rank is None
                         or r.target_rank == f.target_rank)
            if same_rank and f.at >= r.at:
                raise ValueError(
                    f"fault schedule {spec!r}: {f} is unreachable — "
                    f"{r} already fails every write from step {r.at} "
                    f"onward")
    return faults


def _mutate_chunk(paths, chunk_at: int, truncate: bool) -> bool:
    """Apply one on-disk data fault: locate global chunk `chunk_at` across
    the RecordIO `paths` (frames counted in list order) and either flip a
    payload byte (CRC mismatch) or truncate the file mid-payload.  Returns
    False when the chunk does not exist (entry stays pending — same
    contract as a step index never reached)."""
    import struct

    seen = 0
    for path in paths:
        with open(path, "rb") as fh:
            data = bytearray(fh.read())
        off = 0
        while off + 20 <= len(data):
            magic, nrecs = struct.unpack_from("<II", data, off)
            (plen,) = struct.unpack_from("<Q", data, off + 8)
            if magic != 0x01020304 or off + 20 + plen > len(data):
                break  # already-broken tail; stop framing this file
            if seen == chunk_at:
                if plen == 0:
                    return False  # nothing to corrupt in an empty chunk
                if truncate:
                    # keep the header + half the payload: the scanner sees
                    # a valid header whose payload read comes up short
                    data = data[:off + 20 + max(1, int(plen) // 2)]
                else:
                    data[off + 20 + int(plen) // 2] ^= 0xFF
                with open(path, "wb") as fh:
                    fh.write(bytes(data))
                return True
            seen += 1
            off += 20 + int(plen)
    return False


class FaultInjector:
    """Seeded, schedule-driven fault source.  One instance = one schedule;
    construct fresh (or `reset()`) per run.  The port runs one training
    process: an entry aimed at a gang's worker rank raises
    NotImplementedError naming ROADMAP A10."""

    def __init__(self, spec: str = "", seed: int = 0):
        self.spec = spec
        self.seed = seed
        self.faults = parse_fault_spec(spec)
        for f in self.faults:
            if f.target_rank is not None:
                raise NotImplementedError(
                    f"FaultInjector: {f} targets worker rank {f.target_rank} of a "
                    f"gang; gang faults come with data parallelism (ROADMAP A10)")
        self._rng = random.Random(seed)
        # rot_shard@N / rot_row@N count COMMITTED checkpoints/snapshots
        # this injector observed
        self._commits = 0
        # kill_pserver/stall_pserver need a live supervisor handle
        # (set_pserver); entries stay pending until one is registered
        self._pserver = None
        # storage faults: the train step the loop is currently inside
        # (on_dispatch/set_step maintain it; -1 = no step dispatched yet,
        # so step-window entries stay dormant outside a training loop
        # until a test pins the step explicitly) and the io.py hook state
        self._step = -1
        self._io_prev_hook = None
        self._io_armed = False
        # serializes Fault.seen/fired mutation: the hook can fire from
        # more than one thread (a training save, a loader's read) and an
        # unsynchronized read-modify-write could double-fire or skip a
        # one-shot op-indexed entry.  Claim-only critical section — the
        # prints, sleeps and the raise happen after release
        from .core import locks as _locks

        self._io_lock = _locks.named_lock("faults.io", rank=48)
        self._storage = [f for f in self.faults if f.kind in _STORAGE_KINDS]

    @staticmethod
    def from_flags() -> Optional["FaultInjector"]:
        """Build the injector `FLAGS_fault_spec` asks for (None when the
        flag is empty — the production default)."""
        from .flags import flag

        spec = flag("FLAGS_fault_spec")
        return FaultInjector(spec) if spec else None

    def reset(self):
        for f in self.faults:
            f.fired = False
            f.seen = 0
        self._rng = random.Random(self.seed)
        self._step = -1
        return self

    def pending(self) -> List[Fault]:
        return [f for f in self.faults if not f.fired]

    def fired(self) -> List[Fault]:
        return [f for f in self.faults if f.fired]

    def summary(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.faults:
            if f.fired:
                out[f.kind] = out.get(f.kind, 0) + 1
        return out

    # -- hooks -------------------------------------------------------------
    def _take(self, kind: str, at: int) -> Optional[Fault]:
        for f in self.faults:
            if f.kind == kind and f.at == at and not f.fired:
                f.fired = True
                _MON.counter(f"faults.{kind}").inc()
                return f
        return None

    def on_files(self, paths):
        """Called with the RecordIO file list a data pipeline is about to
        open (tests/bench call it explicitly before building the loader);
        applies any pending corrupt_chunk@N / truncated_file@N entries by
        mutating the files ON DISK — the corruption then flows through the
        real native scanner + CRC + budget machinery, not a mock.  Chunk
        index N counts frames across the concatenated file list.  Fires
        once.  Returns `paths` for chaining."""
        for kind in _FILE_KINDS:
            for f in self.faults:
                if f.kind != kind or f.fired:
                    continue
                if _mutate_chunk(paths, f.at, truncate=(kind == "truncated_file")):
                    f.fired = True
                    _MON.counter(f"faults.{kind}").inc()
        return paths

    def on_batch(self, batch_index: int, feed):
        """Called with every raw batch pulled from the loader; raises
        DataError for a scheduled bad batch (simulating a record the
        parser rejects)."""
        if self._take("bad_batch", batch_index) is not None:
            raise DataError(f"injected bad batch {batch_index}",
                            batch_index=batch_index, phase="loader")
        return feed

    def on_feed(self, step: int, feed: dict) -> dict:
        """Called with the feed about to become train step `step`; plants
        a NaN in the first floating-point array (a numpy array or a
        tensor, on the card or not) so the NaN reaches the loss through the
        real computation (not a mocked check).  The feed the caller passed
        is not modified: the poisoned array is a copy."""
        if self._take("nan", step) is None:
            return feed
        feed = dict(feed)
        for name in sorted(feed):
            v = feed[name]
            if isinstance(v, torch.Tensor):
                if v.is_floating_point() and v.numel():
                    v = v.clone()
                    v.view(-1)[self._rng.randrange(v.numel())] = float("nan")
                    feed[name] = v
                    break
                continue
            a = np.asarray(v)
            if np.issubdtype(a.dtype, np.floating) and a.size:
                a = a.copy()
                a.flat[self._rng.randrange(a.size)] = np.nan
                feed[name] = a
                break
        else:
            raise ValueError(f"nan@{step}: feed has no floating-point array "
                             f"to poison (names: {sorted(feed)})")
        return feed

    def on_state(self, step: int, scope):
        """Called at the dispatch boundary of train step `step` with the
        live scope (resilient_train_loop's feed/snapshot boundary — the
        same consistent cut the state snapshots and integrity digests
        use); applies a scheduled flip_bit by XOR-ing one exponent-region
        bit of one seeded element of the LARGEST float state var.  The
        result is deliberately finite — the point is a value every
        NaN/Inf guard waves through and only a content digest can see."""
        if self._take("flip_bit", step) is None:
            return
        # deterministic victim: the LARGEST float var (big tensors are
        # where real SDC lands, and a zero-initialized bias would make a
        # fault too quiet to attribute), name-ordered tiebreak
        from .integrity import _host

        floats = []
        for name in sorted(scope.local_var_names()):
            v = scope.find_var(name)
            if isinstance(v, torch.Generator):
                continue
            try:
                a = _host(v)
            except Exception:
                continue
            if a.dtype.kind == "f" and a.size \
                    and a.dtype.itemsize in (2, 4, 8):
                floats.append((-a.size, name, a))
        floats.sort(key=lambda t: (t[0], t[1]))
        for _neg, name, a in floats:
            a = a.copy()
            flat = a.reshape(-1)
            idx = self._rng.randrange(flat.size)
            bits = flat.view({2: np.uint16, 4: np.uint32,
                              8: np.uint64}[a.dtype.itemsize])
            width = a.dtype.itemsize * 8
            # top exponent bit first (0.02 -> ~1e36: finite, loud for the
            # plausibility tiebreak); walk down if a flip would produce
            # NaN/Inf — the fault must stay FINITE or the NaN guard would
            # catch it and the test would prove nothing
            for b in range(width - 2, width - 8, -1):
                old = bits[idx]
                bits[idx] = old ^ type(bits[idx])(1 << b)
                if np.isfinite(flat[idx]):
                    break
                bits[idx] = old
            else:
                flat[idx] = flat.dtype.type(
                    {16: 6e4, 32: 3e38, 64: 1e300}[width])
            print(f"faults: flip_bit@{step} firing on {name!r}[{idx}]",
                  file=sys.stderr, flush=True)
            v = scope.find_var(name)
            if isinstance(v, torch.Tensor):
                # into the tensor the scope holds: a captured CUDA graph
                # reads the flipped value too
                from .core.dtypes import to_tensor

                v.copy_(to_tensor(a, None, v.device))
            else:
                scope.set_var(name, a)
            return
        raise ValueError(f"flip_bit@{step}: scope has no float state var "
                         f"to corrupt")

    def on_commit(self, ckpt_dir: Optional[str]):
        """Called with each checkpoint directory the moment its COMMIT
        lands (resilient_train_loop's flush path; tests/bench call it
        directly); applies a pending rot_shard@N or rot_row@N when this is
        the Nth commit this injector observed: one payload byte of the
        first shard file (sorted order) is flipped -- any .npy for
        rot_shard, a SelectedRows VALUES shard (`*.vals.*.npy`, the rows of
        the sparse tier) for rot_row.  A commit whose directory is None or
        not (yet) a directory is counted and mutates nothing.  Returns
        `ckpt_dir` for chaining."""
        idx = self._commits
        self._commits += 1
        for f in self.faults:
            if f.kind not in ("rot_shard", "rot_row") or f.at != idx or f.fired:
                continue
            if ckpt_dir is None or not os.path.isdir(ckpt_dir):
                continue
            shards = sorted(n for n in os.listdir(ckpt_dir)
                            if n.endswith(".npy")
                            and (f.kind != "rot_row" or ".vals." in n))
            path = os.path.join(ckpt_dir, shards[0]) if shards else None
            size = os.path.getsize(path) if path else 0
            if not size:
                continue
            with open(path, "r+b") as fh:
                fh.seek(size // 2)
                b = fh.read(1)
                fh.seek(size // 2)
                fh.write(bytes([b[0] ^ 0xFF]))
            print(f"faults: rot_shard@{f.at} firing on {path} "
                  f"(byte {size // 2} flipped post-COMMIT)",
                  file=sys.stderr, flush=True)
            f.fired = True
            _MON.counter(f"faults.{f.kind}").inc()
        return ckpt_dir

    # -- storage faults ----------------------------------------------------
    def arm_io(self) -> "FaultInjector":
        """Register this injector as the io.py choke-point fault hook so
        enospc/eio/slow_io/ro_fs entries can fire on real checkpoint/
        manifest/model-store I/O.  Idempotent; `disarm_io` restores the
        previous hook.  `resilient_train_loop` arms/disarms automatically
        around its run."""
        if not self._io_armed:
            from . import io as _io

            self._io_prev_hook = _io.set_io_fault_hook(self.on_io)
            self._io_armed = True
        return self

    def disarm_io(self):
        if self._io_armed:
            from . import io as _io

            _io.set_io_fault_hook(self._io_prev_hook)
            self._io_prev_hook = None
            self._io_armed = False

    def set_step(self, step: int):
        """Pin the train step the step-window storage entries compare
        against (`on_dispatch` calls this; tests driving CheckpointManager
        directly call it by hand)."""
        self._step = int(step)

    def on_io(self, op: str, path: str):
        """The io.py choke-point hook: applies any armed storage fault to
        this operation.  `op` is "read" or "write".  Raises plain OSError
        with the real errno — the io layer stamps phase="storage" and
        errors.classify maps it onto StorageError, exactly the path a real
        disk failure takes.  Paths under FLAGS_ckpt_fallback_dir are
        exempt (the fallback models a different device)."""
        if not self._storage:
            return
        from . import io as _io
        from .flags import flag as _flag

        exempt = list(_io.fault_exempt_prefixes())
        fb = _flag("FLAGS_ckpt_fallback_dir")
        if fb:
            exempt.append(os.path.abspath(fb))
        if exempt:
            ap = os.path.abspath(path)
            for pfx in exempt:
                if ap == pfx or ap.startswith(pfx + os.sep):
                    return
        # CLAIM under the lock (pure bookkeeping: op-index counters and
        # the first-fire latch, so concurrent threads can never double-
        # fire or skip a one-shot), then FIRE outside it — the stderr
        # print, the slow_io sleep and the raise are blocking work that
        # must not serialize other threads' I/O through a held lock.
        hits = []  # (fault, first_fire)
        with self._io_lock:
            for f in self._storage:
                if f.kind in ("slow_io", "eio"):
                    if f.kind == "eio" and \
                            not fnmatch.fnmatch(path, f.arg or "*"):
                        continue
                    idx, f.seen = f.seen, f.seen + 1
                    if idx == f.at:
                        f.fired = True
                        hits.append((f, True))  # op index unique: one claimant
                    continue
                # step-window kinds: enospc (step == at), ro_fs (step >= at)
                if op != "write":
                    continue
                if self._step < 0:
                    continue
                active = (self._step == f.at if f.kind == "enospc"
                          else self._step >= f.at)
                if active:
                    first, f.fired = not f.fired, True
                    hits.append((f, first))
        sleep_ms = 0.0
        err = None
        for f, first in hits:
            if f.kind == "slow_io":
                _MON.counter("faults.slow_io").inc()
                print(f"faults: slow_io@{f.at} firing on {path} "
                      f"({f.slow_ms}ms)", file=sys.stderr, flush=True)
                sleep_ms += f.slow_ms
                continue
            if first:
                _MON.counter(f"faults.{f.kind}").inc()
                at = (f"op {f.at}" if f.kind == "eio"
                      else f"step {self._step}")
                print(f"faults: {f} firing at {at} on {path}",
                      file=sys.stderr, flush=True)
            err = OSError(_STORAGE_ERRNO[f.kind],
                          f"injected {f.kind.upper().replace('_', '-')} "
                          f"(fault {f})", path)
        if sleep_ms:
            time.sleep(sleep_ms / 1e3)
        if err is not None:
            raise err

    def on_dispatch(self, step: int):
        """Called just before train step `step` is dispatched; raises the
        scheduled transient device error or delivers a real SIGTERM (the
        preemption notice).  Also advances the storage faults' step
        tracker (enospc/ro_fs windows follow the train step)."""
        self.set_step(step)
        f = self._take("device", step)
        if f is not None:
            code = f.arg or "UNAVAILABLE"
            raise TransientDeviceError(
                f"injected device failure ({code}) at dispatch {step}",
                code=code, step=step, phase="device")
        if self._take("preempt", step) is not None:
            os.kill(os.getpid(), signal.SIGTERM)
        # host-tier chaos: claimable only once a supervisor is registered;
        # without one the entries stay pending, as a step never reached
        if self._pserver is not None:
            f = self._take("kill_pserver", step)
            if f is not None:
                print(f"faults: kill_pserver@{step} firing (SIGKILL on the "
                      f"pserver child)", file=sys.stderr, flush=True)
                self._pserver.kill()
            f = self._take("stall_pserver", step)
            if f is not None:
                print(f"faults: stall_pserver@{step} firing (SIGSTOP "
                      f"{f.pserver_stall_s}s)", file=sys.stderr, flush=True)
                self._pserver.stall(f.pserver_stall_s)

    def set_pserver(self, supervisor) -> "FaultInjector":
        """Register the PServerSupervisor the kill_pserver/stall_pserver
        entries act on (anything with .kill() / .stall(seconds) works).
        Returns self for chaining."""
        self._pserver = supervisor
        return self

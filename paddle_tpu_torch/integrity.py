"""Silent-corruption sentinel: wrong-but-finite state made loud
(counterpart of paddle_tpu/integrity.py).

  * At-rest integrity: `io.save_vars` / `save_sharded` stamp each file's
    sha256 and byte length into their manifests; `verify_file_entry` /
    `verify_manifest_digests` / `scan_snapshot_dir` check them (io's
    loaders under FLAGS_integrity_verify_load, `CheckpointManager.restore`'s
    walk-back).
  * Content digests of the training state: `state_digest` /
    `sparse_state_digest` hash every var's name, dtype, shape and bytes
    (a bf16 tensor by its bits, as an ml_dtypes array; a torch generator
    by its state, uint8), so the same state gives the same hex digest in
    both packages.  `StateDigester` amortizes them under
    FLAGS_integrity_check_period (step `s` hashes chunk `s % period`).
  * Cross-rank divergence: `_vote` and `observe_gang` compare the epoch
    digests replicated ranks publish and name the corrupt rank; the gang
    whose heartbeats carry them comes with ROADMAP A10, so in the port
    they run when a caller feeds them the payloads (`flag_divergence`
    latches a verdict the training thread raises as IntegrityError).

A digest reads every tensor back to the host, which waits for the work
already enqueued on the card: a digest at a dispatch boundary is exactly
"the state after the steps dispatched so far".  The first divergence
`observe_gang` records also dumps the monitor's flight recorder, where one
is armed (reason "integrity_divergence").

Monitor surface: `integrity.digests / digest_bytes / files_verified /
file_mismatches / divergences / ckpt_rejected / rollbacks` counters,
`integrity.corrupt_rank` gauge, `kind="integrity_event"` records.
"""
from __future__ import annotations

__all__ = ["StateDigester", "state_digest", "sparse_state_digest",
           "check_selected_rows", "file_sha256",
           "verify_file_entry", "verify_manifest_digests",
           "scan_snapshot_dir", "observe_gang", "current_payload",
           "flag_divergence", "arm_live_digests", "disarm_live_digests",
           "PLAUSIBILITY_RATIO"]

import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .core import locks
from .errors import IntegrityError
from .monitor import MONITOR as _MON

# A tied divergence vote (even split — the 2-rank gang) falls back to
# value plausibility: the rank whose divergent chunk's max |value| exceeds
# every other rank's by at least this ratio is voted corrupt (an exponent
# bit flip inflates a weight by ~2^64 in f32; healthy replicas differ by
# 0).  Below the ratio the divergence stays unattributed — detection and
# rollback still fire, only the naming degrades.
PLAUSIBILITY_RATIO = 1e6

# Beat payloads are compared by (generation, epoch); keep a short history
# per rank so beat-interval skew between ranks cannot drop a comparison.
_EPOCH_HISTORY = 8
# Each beat carries the last K completed epoch payloads, not just the
# newest: epochs can complete faster than beats sample (period steps may
# take less than one beat interval), and the FIRST divergent epoch is the
# only one whose amax still separates the corrupt rank from the healthy
# one — once the poisoned mean gradient propagates, every rank's
# magnitudes blow up together.  A sliding window of K keeps that epoch
# exchangeable for K*period steps.
_PUBLISH_WINDOW = 8
# Per-chunk detail (short digests + amax) is included in the beat
# payload only up to this many chunks: beats ride single UDP datagrams
# (~64 KB), and a large period over a large model would otherwise grow
# the payload without bound — send() swallows EMSGSIZE, so an oversized
# beat would silently read as the rank going stale.  Past the cap, the
# payload still carries the overall digest + overall amax: divergence
# detection and the plausibility tiebreak keep working, only the
# divergent-CHUNK attribution (and safe_step's chunk offset, which
# degrades to the epoch start — strictly more conservative) is lost.
_DETAIL_CHUNK_CAP = 64


# ---- file / manifest digests (at-rest integrity) ---------------------------

def file_sha256(path: str, chunk: int = 1 << 20):
    """(hex sha256, byte length) of a file, streamed.  Reads through the
    io.py storage choke point, so a flaky store fails digest
    verification with a classified transient StorageError — walked past
    by restore — instead of masquerading as
    rot."""
    from . import io as _io

    h = hashlib.sha256()
    n = 0
    with _io.open_for_read(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
            n += len(b)
    return h.hexdigest(), n


def stamp_file(path: str) -> dict:
    """The manifest stamp for one just-written file."""
    sha, n = file_sha256(path)
    return {"sha256": sha, "bytes": n}


def verify_file_entry(dirname: str, fname: str,
                      expected_sha: Optional[str],
                      expected_bytes: Optional[int]):
    """Verify one manifest-named file against its recorded digest.
    Entries without a recorded sha256 (pre-digest manifests) pass
    unchecked; a mismatch raises IntegrityError naming the file."""
    if not expected_sha:
        return

    def _mismatch(detail):
        # one PRIMARY detection = one counter tick + one event; the
        # walk-back's ckpt_rejected is the downstream consequence and is
        # deliberately NOT a second "mismatch" (perf_report's
        # --max-integrity-mismatches counts detections, not echoes)
        _MON.counter("integrity.file_mismatches").inc()
        _MON.record_step({"kind": "integrity_event",
                          "action": "file_mismatch", "dir": dirname,
                          "file": fname, "detail": detail})

    path = os.path.join(dirname, fname)
    try:
        sha, n = file_sha256(path)
    except OSError as e:
        from .errors import (TERMINAL_STORAGE_ERRNOS,
                             TRANSIENT_STORAGE_ERRNOS)

        eno = getattr(e, "errno", None)
        if eno in TRANSIENT_STORAGE_ERRNOS or eno in TERMINAL_STORAGE_ERRNOS:
            # a failing READ (EIO, timeout, permission flap) is a STORAGE
            # verdict, not evidence of rot: no mismatch counter, no
            # IntegrityError — re-raise as-is (phase="storage" already
            # attached by the io choke point) so the publisher
            # retries/classifies without quarantining and restore's
            # walk-back treats it like any other unreadable checkpoint
            raise
        _mismatch(f"unreadable: {type(e).__name__}")
        raise IntegrityError(
            f"manifest names {fname!r} but it cannot be read "
            f"({type(e).__name__}: {e})", file=fname) from e
    if expected_bytes is not None and n != int(expected_bytes):
        _mismatch(f"{n} bytes != recorded {expected_bytes}")
        raise IntegrityError(
            f"{fname!r} is {n} bytes but the manifest recorded "
            f"{expected_bytes} — truncated or grown since save",
            file=fname, expected=str(expected_bytes), actual=str(n))
    if sha != expected_sha:
        _mismatch(f"sha256 {sha[:12]} != recorded {expected_sha[:12]}")
        raise IntegrityError(
            f"{fname!r} content digest mismatch: manifest recorded "
            f"sha256 {expected_sha[:16]}…, file hashes to {sha[:16]}… — "
            f"the bytes rotted since save",
            file=fname, expected=expected_sha, actual=sha)
    _MON.counter("integrity.files_verified").inc()


def _manifest_file_entries(dirname: str):
    """Yield (fname, sha256-or-None, bytes-or-None, manifest) for every
    file any manifest in `dirname` names (plain, quant, and all per-
    process sharded manifests).  Unreadable manifests raise (OSError /
    json.JSONDecodeError) — the caller decides what that means."""
    import glob as _glob
    from . import io as _io

    plain = os.path.join(dirname, _io.MANIFEST)
    if os.path.exists(plain):
        with open(plain) as f:
            man = json.load(f)
        for e in man.get("vars", []):
            yield e["file"], e.get("sha256"), e.get("bytes"), _io.MANIFEST
    for mpath in sorted(
            _glob.glob(os.path.join(dirname, "__sharded_manifest__*.json"))):
        with open(mpath) as f:
            man = json.load(f)
        mname = os.path.basename(mpath)
        for e in man.get("vars", []):
            for sh in e.get("shards", []):
                if e.get("selected_rows"):
                    yield (sh["rows_file"], sh.get("rows_sha256"),
                           sh.get("rows_bytes"), mname)
                    yield (sh["values_file"], sh.get("values_sha256"),
                           sh.get("values_bytes"), mname)
                else:
                    yield (sh["file"], sh.get("sha256"), sh.get("bytes"),
                           mname)


def verify_manifest_digests(dirname: str) -> int:
    """Verify every digest-stamped file each manifest under `dirname`
    names; returns the number verified.  Raises IntegrityError on the
    first mismatch/unreadable file, OSError/ValueError on an unreadable
    manifest.  This is the publish fast-reject: hashing a snapshot is
    milliseconds next to the golden-smoke/compile ladder behind it."""
    n = 0
    for fname, sha, nbytes, _src in _manifest_file_entries(dirname):
        if sha:
            verify_file_entry(dirname, fname, sha, nbytes)
            n += 1
    return n


def scan_snapshot_dir(dirname: str) -> List[dict]:
    """Non-raising audit of one checkpoint / model directory: every
    finding as {"file", "class", "detail"}.  Classes: digest_mismatch,
    bytes_mismatch, missing_file, unreadable_file, manifest_error
    (errors) and undigested (warning — a pre-digest manifest entry
    nothing can verify).  The scrub tool and tests share this walk with
    the raising loaders."""
    findings = []
    try:
        entries = list(_manifest_file_entries(dirname))
    except Exception as e:
        return [{"file": dirname, "class": "manifest_error",
                 "detail": f"{type(e).__name__}: {e}"}]
    for fname, sha, nbytes, src in entries:
        path = os.path.join(dirname, fname)
        if not os.path.exists(path):
            findings.append({"file": fname, "class": "missing_file",
                             "detail": f"named by {src} but absent"})
            continue
        if not sha:
            findings.append({"file": fname, "class": "undigested",
                             "detail": f"{src} carries no sha256 "
                                       f"(pre-digest manifest)"})
            continue
        try:
            got_sha, got_n = file_sha256(path)
        except OSError as e:
            # EACCES/EIO mid-scan is a FINDING, not a crash: one
            # unreadable file must never mask every other root's verdict
            # (tools/scrub.py gates on the unreadable_file class)
            findings.append({"file": fname, "class": "unreadable_file",
                             "detail": f"{type(e).__name__}: {e}"})
            continue
        if nbytes is not None and got_n != int(nbytes):
            findings.append({"file": fname, "class": "bytes_mismatch",
                             "detail": f"{got_n} bytes, manifest says "
                                       f"{nbytes}"})
        elif got_sha != sha:
            findings.append({"file": fname, "class": "digest_mismatch",
                             "detail": f"sha256 {got_sha[:16]}… != "
                                       f"recorded {sha[:16]}…"})
    return findings


# ---- live state digests ----------------------------------------------------

def _host(v) -> np.ndarray:
    """A scope value as numpy: a tensor's host copy (bf16 as ml_dtypes
    bfloat16, its bits), a torch generator's state."""
    from .core.dtypes import to_numpy

    if isinstance(v, torch.Generator):
        return v.get_state().numpy()
    if isinstance(v, torch.Tensor):
        return to_numpy(v)
    return np.asarray(v)


def _digest_var(h: "hashlib._Hash", name: str, v) -> tuple:
    """Fold one scope var into a running hash; returns (nbytes, amax)."""
    from .core.selected_rows import SelectedRows

    if isinstance(v, SelectedRows):
        arrays = [("rows", _host(v.rows)), ("values", _host(v.values))]
    else:
        try:
            arrays = [("", _host(v))]
        except Exception:
            return 0, 0.0
    nbytes = 0
    amax = 0.0
    for tag, a in arrays:
        h.update(name.encode())
        h.update(tag.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        # hash the buffer in place — tobytes() would materialize a full
        # copy of every tensor on the exact hot path the amortization
        # exists to keep cheap (uint8 view: ml_dtypes like bfloat16
        # don't export a buffer directly; byte identity is what a
        # content digest wants anyway)
        ac = np.ascontiguousarray(a)
        try:
            h.update(ac.view(np.uint8).reshape(-1).data)
        except (TypeError, ValueError):
            h.update(ac.tobytes())
        nbytes += a.nbytes
        if a.dtype.kind == "f" and a.size:
            # copy-free amax over the finite values (a fancy-index
            # `a[isfinite]` would allocate a compressed copy)
            m = float(np.max(np.abs(a), initial=0.0,
                             where=np.isfinite(a)))
            amax = max(amax, m)
    return nbytes, amax


def state_digest(scope, var_names: Optional[Sequence[str]] = None) -> str:
    """One-shot full-state content digest (the unamortized reference the
    amortized path and the tests compare against)."""
    names = sorted(var_names if var_names is not None
                   else scope.local_var_names())
    h = hashlib.sha256()
    for name in names:
        v = scope.find_var(name)
        if v is not None:
            _digest_var(h, name, v)
    return h.hexdigest()


def sparse_state_digest(scope, var_names: Optional[Sequence[str]] = None):
    """Content digest over ONLY the SelectedRows vars of a scope (name
    order), or None when it holds no sparse state.  This is the sparse
    tier's identity across a publish/load boundary: a torn or rotted
    sparse snapshot shows up as two sides disagreeing about a digest."""
    from .core.selected_rows import SelectedRows

    names = sorted(var_names if var_names is not None
                   else scope.local_var_names())
    h = hashlib.sha256()
    found = False
    for name in names:
        v = scope.find_var(name)
        if isinstance(v, SelectedRows):
            found = True
            _digest_var(h, name, v)
    return h.hexdigest() if found else None


def check_selected_rows(name: str, sr) -> Optional[str]:
    """Structural + numeric validation of one SelectedRows (the JAX
    package's publish ladder runs it on sparse tables).  Returns a human-readable defect
    description, or None when the shard is sound: row ids must be
    integral, strictly increasing (the consolidated-snapshot invariant
    `consolidate_selected_rows` establishes — a duplicate or disordered
    id means a torn merge), in [0, height), and every value finite."""
    rows = _host(sr.rows)
    values = _host(sr.values)
    if rows.dtype.kind not in "iu":
        return f"{name}: row ids have non-integer dtype {rows.dtype}"
    if rows.ndim != 1 or rows.shape[0] != values.shape[0]:
        return (f"{name}: {rows.shape[0] if rows.ndim == 1 else rows.shape} "
                f"row ids for {values.shape[0]} value rows")
    if rows.size:
        if int(rows.min()) < 0 or int(rows.max()) >= int(sr.height):
            return (f"{name}: row id range [{rows.min()}, {rows.max()}] "
                    f"outside [0, {sr.height})")
        if rows.size > 1 and not bool(np.all(np.diff(rows) > 0)):
            return f"{name}: row ids not strictly increasing (torn merge?)"
    if values.dtype.kind == "f" and values.size \
            and not bool(np.isfinite(np.asarray(values, np.float64)).all()):
        bad = int(np.size(values) - np.isfinite(
            np.asarray(values, np.float64)).sum())
        return f"{name}: {bad} non-finite value element(s)"
    return None


class StateDigester:
    """Amortized streaming digests over parameters + optimizer state.

    The tracked names (persistables, sorted) are dealt round-robin into
    `min(period, len(names))` chunks; `on_step(s, scope)` digests chunk
    `s % period` at the dispatch boundary of step `s`, so one full
    content cut completes every `period` steps and each step hashes only
    its share of the bytes.  When the last chunk of an epoch lands, the
    epoch payload (overall digest, per-chunk digests, per-chunk max
    |value| for the tie-break) is published for the heartbeat to carry.

    A host copy of a scope var waits for the card's in-flight work, so a
    chunk digest is exactly "state after the steps dispatched so far" —
    the same consistent cut the resilience snapshots use, and the reason
    digests on different ranks of a lock-step dp gang are comparable.

    `reset()` (after a rollback) bumps the generation: payloads are only
    ever compared within one generation, so every rank that rolled back
    re-aligns and anything stale dies quietly."""

    def __init__(self, scope, var_names: Optional[Sequence[str]] = None,
                 period: int = 1, rank: int = 0):
        self.scope = scope
        # var_names=None tracks the whole scope, re-snapshotted at each
        # epoch START: optimizer accumulators are created lazily by the
        # first step, and every rank of a lock-step gang creates them at
        # the same step, so the refreshed chunking stays rank-aligned
        self._fixed_names = sorted(var_names) if var_names is not None \
            else None
        self.period = max(1, int(period))
        self.rank = int(rank)
        self.gen = 0
        self.last_payload: Optional[dict] = None
        self._acc: Optional[dict] = None  # {"e": epoch, "d": {c: hex}, ...}
        self._rechunk()

    def _rechunk(self):
        names = (self._fixed_names if self._fixed_names is not None
                 else sorted(self.scope.local_var_names()))
        self.names = names
        self.n_chunks = min(self.period, max(1, len(names)))
        self.chunks = [names[c::self.n_chunks]
                       for c in range(self.n_chunks)]

    def reset(self):
        """Drop any partial epoch and start a new generation (called
        after a rollback rewound state: old epochs describe a discarded
        timeline).  Clears the published payload and any stale verdict."""
        self.gen += 1
        self._acc = None
        self.last_payload = None
        _clear_live(self)
        return self

    def max_step_digest_bytes(self) -> int:
        """Upper bound on bytes hashed in any single step — the overhead
        contract the amortization exists for (roughly state_bytes /
        period; exact per the chunk deal)."""
        worst = 0
        for chunk in self.chunks:
            total = 0
            for name in chunk:
                v = self.scope.find_var(name)
                if v is None:
                    continue
                from .core.selected_rows import SelectedRows

                if isinstance(v, SelectedRows):
                    total += v.rows.nbytes + v.values.nbytes
                elif isinstance(v, torch.Tensor):
                    total += v.nbytes
                else:
                    try:
                        total += _host(v).nbytes
                    except Exception:
                        pass
            worst = max(worst, total)
        return worst

    def _chunk_digest(self, c: int) -> tuple:
        h = hashlib.sha256()
        nbytes = 0
        amax = 0.0
        for name in self.chunks[c]:
            v = self.scope.find_var(name)
            if v is None:
                continue
            nb, am = _digest_var(h, name, v)
            nbytes += nb
            amax = max(amax, am)
        return h.hexdigest(), nbytes, amax

    def on_step(self, step: int):
        """Dispatch-boundary hook: raise a latched divergence verdict as
        IntegrityError, then digest the chunk due at `step`.  Returns the
        epoch payload when this step completed an epoch, else None."""
        self.check_verdict(step)
        e, c = divmod(int(step), self.period)
        if c == 0:
            self._rechunk()
            self._acc = {"e": e, "d": {}, "amax": {}}
        acc = self._acc
        if acc is None or acc["e"] != e:
            return None  # joined mid-window (arm/restore): wait for e+1
        if c < self.n_chunks:
            with _MON.span("integrity.digest", step=step, chunk=c):
                dig, nbytes, amax = self._chunk_digest(c)
            acc["d"][c] = dig
            acc["amax"][c] = amax
            _MON.counter("integrity.digest_bytes").inc(nbytes)
        if c == self.n_chunks - 1 and len(acc["d"]) == self.n_chunks:
            h = hashlib.sha256()
            for i in range(self.n_chunks):
                h.update(acc["d"][i].encode())
            payload = {
                "g": self.gen, "e": e, "step": step,
                "p": self.period, "n": self.n_chunks,
                "d": h.hexdigest()[:16],
                "amax_all": max(acc["amax"].values(), default=0.0),
            }
            if self.n_chunks <= _DETAIL_CHUNK_CAP:
                payload["c"] = [acc["d"][i][:12]
                                for i in range(self.n_chunks)]
                payload["amax"] = [acc["amax"][i]
                                   for i in range(self.n_chunks)]
            self.last_payload = payload
            self._acc = None
            _publish(self, payload)
            _MON.counter("integrity.digests").inc()
            return payload
        return None

    def check_verdict(self, step: Optional[int] = None):
        """Raise the divergence verdict the beat thread latched for this
        generation (consumed on raise); stale-generation latches are
        discarded."""
        v = _consume_verdict(self)
        if v is None:
            return
        raise IntegrityError(
            f"cross-rank state digest divergence at epoch {v['e']} "
            f"(digests {v['digests']}): replicated dp state stopped "
            f"agreeing bit-exactly — rank(s) {v['corrupt_ranks']} voted "
            f"corrupt"
            + ("" if v["attributed"] else " (vote tied, unattributed)")
            + f"; rolling back to a checkpoint at or before step "
              f"{v['safe_step']}",
            corrupt_ranks=v["corrupt_ranks"], attributed=v["attributed"],
            safe_step=v["safe_step"], step=step)


# ---- process-global live state (train thread <-> beat thread) --------------

_STATE_LOCK = locks.named_lock("integrity.state", rank=46)
# the armed digester's recent published payloads + any latched verdict;
# `observe_gang`'s per-epoch bookkeeping lives beside them.  All mutated
# under _STATE_LOCK: the beat thread and the training thread share these.
_LIVE: Dict[str, object] = {"digester": None, "payloads": [],
                            "verdict": None}
_GANG: Dict[str, object] = {"hist": {}, "compared": set(),
                            "agreed": {}, "reported": set()}


def arm_live_digests(scope, var_names: Optional[Sequence[str]] = None,
                     period: int = 1, rank: int = 0) -> StateDigester:
    """Build + register the process's live digester (what
    `resilient_train_loop` does when FLAGS_integrity_check_period > 0);
    `current_payload()` hands out its published payloads."""
    d = StateDigester(scope, var_names, period, rank=rank)
    with _STATE_LOCK:
        _LIVE["digester"] = d
        _LIVE["payloads"] = []
        _LIVE["verdict"] = None
        _GANG["hist"].clear()
        _GANG["compared"].clear()
        _GANG["agreed"].clear()
        _GANG["reported"].clear()
    return d


def disarm_live_digests(digester: Optional[StateDigester] = None):
    with _STATE_LOCK:
        if digester is None or _LIVE["digester"] is digester:
            _LIVE["digester"] = None
            _LIVE["payloads"] = []
            _LIVE["verdict"] = None
            _GANG["hist"].clear()
            _GANG["compared"].clear()
            _GANG["agreed"].clear()
            _GANG["reported"].clear()


def current_payload() -> Optional[list]:
    """The sliding window of recently published epoch payloads (the
    heartbeat's "dig" field); None when no digester is armed or no epoch
    has completed yet."""
    with _STATE_LOCK:
        p = _LIVE["payloads"]
        return [dict(x) for x in p] if p else None


def _publish(digester: StateDigester, payload: dict):
    with _STATE_LOCK:
        if _LIVE["digester"] is digester:
            _LIVE["payloads"].append(payload)
            del _LIVE["payloads"][:-_PUBLISH_WINDOW]


def _clear_live(digester: StateDigester):
    with _STATE_LOCK:
        if _LIVE["digester"] is digester:
            _LIVE["payloads"] = []
            _LIVE["verdict"] = None


def flag_divergence(verdict: dict):
    """Latch a divergence verdict for the training thread (first one per
    generation wins; the training thread raises at its next dispatch
    boundary).  Public so tests can drive the rollback path without a
    real gang."""
    with _STATE_LOCK:
        if _LIVE["verdict"] is None:
            _LIVE["verdict"] = dict(verdict)


def _consume_verdict(digester: StateDigester) -> Optional[dict]:
    with _STATE_LOCK:
        v = _LIVE["verdict"]
        if v is None:
            return None
        if v.get("g") != digester.gen:
            _LIVE["verdict"] = None  # stale: predates a reset
            return None
        _LIVE["verdict"] = None
        return v


# ---- cross-rank divergence detection (beat thread) -------------------------

def _vote(payloads: Dict[int, dict], baseline_amax: Optional[dict] = None):
    """(corrupt_ranks, attributed, divergent_chunk) for one epoch's
    payloads, or None when all agree.  Majority first; an even split
    (the 2-rank gang) falls back to value plausibility on the first
    divergent chunk: the corrupt rank's max |value| JUMPED by at least
    PLAUSIBILITY_RATIO against the last bit-exact-agreed epoch's
    baseline (an exponent-bit flip inflates a weight by many decades)
    while the healthy rank's stayed put.  The baseline — shared history
    both sides signed off on — is what keeps the tiebreak honest once
    corruption has propagated through the mean gradient and EVERY rank's
    magnitudes explode: only the first divergent epoch separates them,
    and only against the agreed past."""
    groups: Dict[str, List[int]] = {}
    for r, p in payloads.items():
        groups.setdefault(p["d"], []).append(r)
    if len(groups) == 1:
        return None
    # first chunk whose short digests disagree (for reporting + tiebreak;
    # None when the payloads are past _DETAIL_CHUNK_CAP and carry no
    # per-chunk detail — the tiebreak then uses the overall amax)
    chunk = None
    n_chunks = min(len(p.get("c", [])) for p in payloads.values())
    for i in range(n_chunks):
        if len({p["c"][i] for p in payloads.values()}) > 1:
            chunk = i
            break
    majority_needed = len(payloads) // 2 + 1
    winners = [d for d, ranks in groups.items()
               if len(ranks) >= majority_needed]
    if winners:
        corrupt = sorted(r for d, ranks in groups.items()
                         if d != winners[0] for r in ranks)
        return corrupt, True, chunk
    baseline = baseline_amax or {}
    if chunk is not None:
        amaxes = {r: float(p["amax"][chunk]) for r, p in payloads.items()
                  if chunk < len(p.get("amax", []))}
        blist = baseline.get("amax") or []
        base = float(blist[chunk]) if chunk < len(blist) else None
    else:
        amaxes = {r: float(p["amax_all"]) for r, p in payloads.items()
                  if "amax_all" in p}
        base = baseline.get("amax_all")
        base = None if base is None else float(base)
    if len(amaxes) == len(payloads):
        floor = max(base if base is not None
                    else min(amaxes.values()), 1e-30)
        jumped = [r for r, v in amaxes.items()
                  if v > PLAUSIBILITY_RATIO * floor]
        if len(jumped) == 1:
            return jumped, True, chunk
    return sorted(payloads), False, chunk


def observe_gang(tel: Dict[int, dict], world: int,
                 observer_rank: int = 0) -> Optional[dict]:
    """Fold one heartbeat telemetry table ({rank: beat payload}) into the
    per-epoch digest history and compare every epoch all `world` ranks
    have reported; on the first divergence of a generation, record it
    (counter + integrity_event + flight recorder) and latch the verdict
    for the training thread.  Returns the fresh verdict, else None.
    Called from the beat thread — cheap, and never raises into it."""
    digs: Dict[int, list] = {}
    for r, t in tel.items():
        d = t.get("dig") if isinstance(t, dict) else None
        if isinstance(d, dict):
            d = [d]  # single-payload form (tests, legacy beats)
        if isinstance(d, list):
            good = [p for p in d if isinstance(p, dict)
                    and "g" in p and "e" in p and "d" in p]
            if good:
                digs[int(r)] = good
    if not digs:
        return None
    verdict = None
    with _STATE_LOCK:
        hist: Dict[tuple, Dict[int, dict]] = _GANG["hist"]
        for r, plist in digs.items():
            for d in plist:
                hist.setdefault((d["g"], d["e"]), {})[r] = d
        if len(hist) > _EPOCH_HISTORY * max(2, world):
            for key in sorted(hist)[:-_EPOCH_HISTORY]:
                hist.pop(key, None)
                _GANG["compared"].discard(key)
        complete = sorted(k for k, v in hist.items()
                          if len(v) >= world and k not in _GANG["compared"])
        for key in complete:
            g, e = key
            payloads = hist[key]
            _GANG["compared"].add(key)
            agreed = _GANG["agreed"].get(g)
            res = _vote(payloads, baseline_amax=agreed)
            if res is None:
                # bit-exact agreement: the newest PROVEN-clean boundary
                prev = _GANG["agreed"].get(g)
                if prev is None or e > prev["e"]:
                    any_p = next(iter(payloads.values()))
                    _GANG["agreed"][g] = {
                        "e": e, "p": any_p["p"],
                        "amax": list(any_p.get("amax", [])),
                        "amax_all": any_p.get("amax_all")}
                continue
            if g in _GANG["reported"]:
                continue
            _GANG["reported"].add(g)
            corrupt, attributed, chunk = res
            # the newest step the digests prove clean: the divergent
            # chunk's digest point in the last agreed epoch (corruption
            # struck strictly after it) — None when nothing ever agreed
            safe_step = (agreed["e"] * agreed["p"] + (chunk or 0)
                         if agreed is not None else None)
            verdict = {
                "g": g, "e": e,
                "step": max(p["step"] for p in payloads.values()),
                "corrupt_ranks": corrupt, "attributed": attributed,
                "chunk": chunk, "safe_step": safe_step,
                "digests": {r: p["d"] for r, p in payloads.items()},
            }
            if _LIVE["verdict"] is None:
                _LIVE["verdict"] = dict(verdict)
            break
    if verdict is not None:
        # side effects outside the lock: counters and records take the
        # monitor's locks
        _MON.counter("integrity.divergences").inc()
        _MON.gauge("integrity.corrupt_rank").set(
            verdict["corrupt_ranks"][0] if verdict["attributed"]
            and verdict["corrupt_ranks"] else -1)
        _MON.record_step({
            "kind": "integrity_event", "action": "divergence",
            "observer": observer_rank, "epoch": verdict["e"],
            "corrupt_ranks": verdict["corrupt_ranks"],
            "attributed": verdict["attributed"],
            "chunk": verdict["chunk"], "safe_step": verdict["safe_step"],
            "digests": verdict["digests"]})
        _MON.dump_blackbox("integrity_divergence")
    return verdict

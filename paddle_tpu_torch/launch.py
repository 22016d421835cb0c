"""Gang launcher with restart, and the serving fleet's command line
(counterpart of paddle_tpu/launch.py): port allocation, the
`PADDLE_TRAINER_*` environment of a worker process, `Gang`, `run_gang`.

    python -m paddle_tpu_torch.launch --nproc 2 [--max-restarts 2] \\
        [--checkpoint-root DIR] [--timeout S] [--metrics gang.jsonl] \\
        worker.py [args...]

runs `--nproc` copies of the worker script as one gang: each gets the
PADDLE_TRAINER_* contract (parallel.init_distributed reads it; endpoint 0
is the rendezvous) and a fresh block of ports below the ephemeral range.
`Gang` always kills and reaps every worker on the way out; `run_gang`
relaunches the whole gang on a fresh port block, `PADDLE_RESTART_NUM`
bumped and uncommitted checkpoint debris (`*.tmp` under the checkpoint
root) cleared, when a worker exits non-zero, up to `max_restarts` times,
then hands back each rank's (returncode, stdout, stderr).  A death is
seen by the worker's exit; heartbeats, telemetry merging, ranked faults,
coordinated checkpoint commits and elastic resizing come with the gang's
health and resilience layer (ROADMAP A10.2) and raise where they are
asked for.

    python -m paddle_tpu_torch.launch --serve --model bert=/models/bert \\
        [--nproc 2] [--fleet-root DIR] [--buckets 1,8,32] [--device gpu|cpu]

runs `--nproc` replica processes behind the router until SIGTERM or
SIGINT, then drains them.  The replicas serve on the card (`CUDAPlace(0)`,
all of them on the one card `CUDA_VISIBLE_DEVICES` leaves first);
`--device cpu` is the only way to serve on the CPU.
"""
from __future__ import annotations

__all__ = ["allocate_port_block", "worker_env", "Gang", "GangResult",
           "run_gang", "run_serving_fleet", "main"]

import argparse
import errno
import os
import random
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .monitor import MONITOR as _MON

_A10_2 = "the gang's health and resilience layer (ROADMAP A10.2)"

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ephemeral_low() -> Optional[int]:
    """The first port the kernel hands to outgoing connections, or None."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None


def allocate_port_block(n: int, tries: int = 64,
                        low: int = 20000, high: int = 50000) -> int:
    """Base port of `n` CONSECUTIVE free TCP ports, verified by binding
    all of them simultaneously (close-then-reuse races shrink to the
    spawn window instead of `n` independent guesses).  The block lies below
    the kernel's ephemeral range where [low, high) reaches into it: while a
    replica restarts, the router's outgoing connections (one a request)
    could otherwise take its port as their local one and keep its
    successor from binding it (EADDRINUSE, SO_REUSEADDR notwithstanding)."""
    eph = _ephemeral_low()
    if eph is not None and low + n < eph < high:
        high = eph
    rng = random.Random(os.getpid() * 7919 + int(time.time() * 1e3) % 65536)
    last_err: Optional[OSError] = None
    for _ in range(tries):
        base = rng.randrange(low, high - n)
        socks = []
        try:
            for i in range(n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", base + i))
            return base
        except OSError as e:
            if e.errno not in (errno.EADDRINUSE, errno.EACCES):
                raise
            last_err = e
        finally:
            for s in socks:
                s.close()
    raise OSError(
        f"allocate_port_block: no free block of {n} consecutive ports in "
        f"[{low}, {high}) after {tries} tries (last: {last_err})")


def worker_env(rank: int, endpoints: Sequence[str],
               devices_per_proc: int = 1,
               extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Environment of one worker under the PADDLE_TRAINER_* contract:
    this process's environment (`CUDA_VISIBLE_DEVICES` passed through) with
    `PYTHONPATH` rooted at the repository and no `JAX_*` or `XLA_*`
    variable.  `devices_per_proc` keeps the JAX package's signature: a
    worker of the port sees the cards `CUDA_VISIBLE_DEVICES` lists (rank r
    takes card r % their count, parallel/distributed.py)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO_ROOT
    env["PADDLE_TRAINER_ID"] = str(rank)
    env["PADDLE_TRAINER_ENDPOINTS"] = ",".join(endpoints)
    env["PADDLE_CURRENT_ENDPOINT"] = endpoints[rank]
    env.update(extra or {})
    return env


class Gang:
    """Spawn-and-always-reap context manager around one gang incarnation.

        with Gang([sys.executable, worker_py], n_procs=2) as gang:
            results = gang.communicate(timeout=600)

    On exit -- success, failure, or mid-spawn exception -- every live
    worker is killed (SIGTERM, then SIGKILL after `grace_s`) and reaped
    with a bounded join, so no orphan sits blocked in the rendezvous
    holding its port."""

    def __init__(self, argv: Sequence[str], n_procs: int,
                 devices_per_proc: int = 1,
                 extra_env: Optional[Dict[str, str]] = None,
                 per_rank_env: Optional[Dict[int, Dict[str, str]]] = None,
                 grace_s: float = 3.0):
        self.argv = list(argv)
        self.n_procs = n_procs
        self.devices_per_proc = devices_per_proc
        self.extra_env = dict(extra_env or {})
        self.per_rank_env = {r: dict(e) for r, e in (per_rank_env or {}).items()}
        self.grace_s = grace_s
        self.procs: List[subprocess.Popen] = []
        self._files: List[tuple] = []  # (stdout, stderr) spool per worker
        self.base_port: Optional[int] = None
        self.endpoints: List[str] = []

    def __enter__(self) -> "Gang":
        self.base_port = allocate_port_block(self.n_procs)
        self.endpoints = [f"127.0.0.1:{self.base_port + i}"
                          for i in range(self.n_procs)]
        try:
            for rank in range(self.n_procs):
                extra = dict(self.extra_env)
                extra.update(self.per_rank_env.get(rank, {}))
                env = worker_env(rank, self.endpoints,
                                 self.devices_per_proc, extra)
                # worker output goes to spooled temp files, not pipes: a pipe
                # fills at ~64KB and a chatty worker would block in write()
                # while the supervisor reads it as alive
                out_f = tempfile.TemporaryFile(mode="w+t")
                err_f = tempfile.TemporaryFile(mode="w+t")
                self._files.append((out_f, err_f))
                self.procs.append(subprocess.Popen(
                    self.argv, stdout=out_f, stderr=err_f, env=env,
                    text=True))
        except BaseException:
            self._reap()
            raise
        return self

    def __exit__(self, *exc):
        self._reap()
        return False

    def _reap(self):
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + self.grace_s
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=self.grace_s)
                except subprocess.TimeoutExpired:
                    pass  # unkillable (D-state); nothing more a user can do
        for of, ef in self._files:
            for f in (of, ef):
                try:
                    f.close()
                except OSError:
                    pass
        self._files = []

    def communicate(self, timeout: float = 600):
        """Wait for every worker and read its spooled output; returns
        [(returncode, stdout, stderr)].  Re-callable: the spools are
        seeked, not drained."""
        out = []
        for p, (of, ef) in zip(self.procs, self._files):
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                try:
                    p.wait(timeout=self.grace_s)
                except subprocess.TimeoutExpired:
                    pass
            texts = []
            for f in (of, ef):
                try:
                    f.seek(0)
                    texts.append(f.read())
                except (OSError, ValueError):
                    texts.append("")
            out.append((p.returncode, texts[0], texts[1]))
        return out

    def wait_any_death_or_exit(self, poll_s: float = 0.1,
                               timeout: float = 600):
        """Block until every worker exited cleanly, or any worker died
        (non-zero / signaled) -- whichever first.  Returns (ok, codes)
        where ok=False names a failed incarnation."""
        t0 = time.monotonic()
        while True:
            codes = [p.poll() for p in self.procs]
            if any(c not in (None, 0) for c in codes):
                return False, codes
            if all(c == 0 for c in codes):
                return True, codes
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"gang did not finish within {timeout}s (exit codes so "
                    f"far: {codes})")
            time.sleep(poll_s)


@dataclass
class GangResult:
    """What `run_gang` hands back."""

    ok: bool = False
    restarts: int = 0
    incarnations: int = 0
    # last incarnation's per-rank (returncode, stdout, stderr)
    workers: List[tuple] = field(default_factory=list)
    # one dict per death the supervisor observed across all incarnations
    incidents: List[dict] = field(default_factory=list)
    # the telemetry root (ROADMAP A10.2): None in the port so far
    telemetry_dir: Optional[str] = None
    # elastic supervision (ROADMAP A10.2): the size never changes here
    resizes: int = 0
    resize_events: List[dict] = field(default_factory=list)
    size_history: List[int] = field(default_factory=list)
    final_nprocs: int = 0
    # every incarnation's per-rank (returncode, stdout, stderr); the last
    # entry is `workers`
    history: List[List[tuple]] = field(default_factory=list)


def _clear_uncommitted(checkpoint_root: str):
    """Drop half-written checkpoint debris (`*.tmp` dirs of the dead
    incarnation) so the restarted gang's saves never meet a ghost's."""
    if not checkpoint_root or not os.path.isdir(checkpoint_root):
        return
    for name in os.listdir(checkpoint_root):
        if name.endswith(".tmp"):
            shutil.rmtree(os.path.join(checkpoint_root, name),
                          ignore_errors=True)


def run_gang(argv: Sequence[str], n_procs: int, *,
             devices_per_proc: int = 1,
             extra_env: Optional[Dict[str, str]] = None,
             max_restarts: int = 2,
             checkpoint_root: Optional[str] = None,
             heartbeat_dir: Optional[str] = None,
             telemetry_root: Optional[str] = None,
             timeout: float = 600,
             grace_s: float = 3.0,
             peer_grace_s: float = 15.0,
             elastic: bool = False,
             min_procs: int = 1,
             capacity_fn=None,
             log: bool = True) -> GangResult:
    """Supervise `n_procs` copies of `argv` with gang-restart semantics.

    Each incarnation gets a fresh port block and `PADDLE_RESTART_NUM=<k>`
    (and `PADDLE_CHECKPOINT_ROOT` when `checkpoint_root` is given).  When
    any worker exits non-zero (or the incarnation outlives `timeout`), the
    survivors get `peer_grace_s` to exit on their own, every straggler is
    killed and reaped, uncommitted checkpoint debris is cleared, and the
    gang relaunches at the same size.  After `max_restarts` restarts the
    last incarnation's outputs come back with ok=False.

    Heartbeats (`heartbeat_dir`), telemetry (`telemetry_root`) and elastic
    resizing (`elastic`, `capacity_fn`) raise NotImplementedError: they
    come with the gang's health and resilience layer (ROADMAP A10.2)."""
    for what, asked in (("heartbeat_dir", heartbeat_dir is not None),
                        ("telemetry_root", telemetry_root is not None),
                        ("elastic", elastic), ("capacity_fn", capacity_fn is not None)):
        if asked:
            raise NotImplementedError(f"run_gang({what}=...): comes with {_A10_2}")
    result = GangResult()
    base_env = dict(extra_env or {})
    if checkpoint_root:
        base_env["PADDLE_CHECKPOINT_ROOT"] = checkpoint_root
    cur = int(n_procs)
    restarts_left = int(max_restarts)
    incarnation = 0
    while True:
        result.incarnations = incarnation + 1
        result.size_history.append(cur)
        env = dict(base_env)
        env["PADDLE_RESTART_NUM"] = str(incarnation)
        with Gang(argv, cur, devices_per_proc=devices_per_proc,
                  extra_env=env, grace_s=grace_s) as gang:
            try:
                ok, codes = gang.wait_any_death_or_exit(poll_s=0.05, timeout=timeout)
            except TimeoutError:
                ok = False
            if not ok:
                # the survivors may be exiting on their own (a collective
                # with a dead peer fails): give them one bounded window
                # before the reaper kills the rest
                deadline = time.monotonic() + peer_grace_s
                while (time.monotonic() < deadline
                       and any(p.poll() is None for p in gang.procs)):
                    time.sleep(0.05)
                codes = [p.poll() for p in gang.procs]
            result.workers = gang.communicate(timeout=grace_s)
            result.history.append(result.workers)
        if ok:
            result.ok = True
            result.final_nprocs = cur
            return result
        dead = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        incident = {
            "kind": "dist_event", "action": "worker_death",
            "incarnation": incarnation, "nprocs": cur,
            "dead": [{"rank": r, "returncode": c,
                      "signaled": (c is not None and c < 0)} for r, c in dead],
            "stderr_tails": {r: (result.workers[r][2] or "")[-2000:]
                             for r in range(len(result.workers))},
        }
        result.incidents.append(incident)
        _MON.counter("dist.worker_deaths").inc(max(len(dead), 1))
        _MON.record_step(incident)
        if log:
            for r, c in dead:
                err = result.workers[r][2] if r < len(result.workers) else ""
                print(f"paddle_tpu_torch.launch: worker {r} died "
                      f"(returncode {c}) in incarnation {incarnation}:\n"
                      f"{(err or '')[-2000:]}", file=sys.stderr, flush=True)
        if restarts_left == 0:
            break
        _clear_uncommitted(checkpoint_root or "")
        restarts_left -= 1
        result.restarts += 1
        _MON.counter("dist.gang_restarts").inc()
        _MON.record_step({"kind": "dist_event", "action": "gang_restart",
                          "incarnation": incarnation + 1, "nprocs": cur,
                          "after_death_of": [r for r, _ in dead]})
        if log:
            print(f"paddle_tpu_torch.launch: gang restart "
                  f"{result.restarts}/{max_restarts} -- relaunching {cur} workers",
                  file=sys.stderr, flush=True)
        incarnation += 1
    _MON.record_step({"kind": "dist_event", "action": "gang_failed",
                      "restarts": result.restarts})
    result.final_nprocs = cur
    return result


def run_serving_fleet(models: Dict[str, str], n_replicas: int = 2,
                      root: Optional[str] = None,
                      until=None, poll_s: float = 0.5, **fleet_kw) -> dict:
    """Serving-mode supervision: run a `ServingFleet` of `n_replicas`
    replica servers until SIGTERM/SIGINT (or the optional `until()`
    predicate turns true), then DRAIN — each replica gets SIGTERM, flips
    its beat to draining so the router stops dispatching, serves out its
    in-flight requests and exits 0.  An interrupted rolling publish found
    persisted in the fleet root is resumed (or converged back) before
    traffic supervision begins.  `fleet_kw` goes to `ServingFleet`
    (`place=CPUPlace()` serves on the CPU).

    Returns the final router ledger (`Router.stats()`)."""
    import signal as _signal
    import threading as _threading

    from .serving.fleet import ServingFleet

    stop = _threading.Event()
    prev = {}

    def _handler(sig, _frm):
        stop.set()

    for sig in (_signal.SIGTERM, _signal.SIGINT):
        try:
            prev[sig] = _signal.signal(sig, _handler)
        except ValueError:
            pass  # not the main thread: caller owns signal wiring
    fleet = ServingFleet(models, n_replicas=n_replicas, root=root,
                         **fleet_kw)
    try:
        fleet.resume_roll()
        fleet.wait_healthy(min_replicas=1)
        while not stop.wait(poll_s):
            if until is not None and until():
                break
    finally:
        fleet.stop()
        for sig, h in prev.items():
            try:
                _signal.signal(sig, h)
            except ValueError:
                pass
    return fleet.stats()


def _serve_main(argv: List[str]) -> int:
    """`python -m paddle_tpu_torch.launch --serve` — fleet CLI."""
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.launch --serve",
        description="Run a supervised serving fleet (replica servers + "
                    "health-aware router + rolling publish) until "
                    "SIGTERM, then drain.")
    ap.add_argument("--serve", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--model", action="append", default=[],
                    metavar="NAME=DIR", required=True,
                    help="model to serve (repeatable)")
    ap.add_argument("--nproc", type=int, default=2,
                    help="replica processes in the fleet")
    ap.add_argument("--fleet-root", default=None,
                    help="fleet state root (hb/, telemetry/, ACTIVE.json, "
                         "ROLL.json; default: a temp dir)")
    ap.add_argument("--buckets", default="1,4,8")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="per-replica restart budget")
    ap.add_argument("--hb-interval", type=float, default=0.5)
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                    help="where the replicas serve: the card (default) or "
                         "the CPU")
    ns = ap.parse_args(argv)

    models = {}
    for spec in ns.model:
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            ap.error(f"--model wants NAME=DIR, got {spec!r}")
        models[name] = path
    from .core.executor import CPUPlace, CUDAPlace
    from .serving.batcher import parse_buckets

    ledger = run_serving_fleet(
        models, n_replicas=ns.nproc, root=ns.fleet_root,
        buckets=parse_buckets(ns.buckets),
        max_restarts=ns.max_restarts, hb_interval_s=ns.hb_interval,
        place=CPUPlace() if ns.device == "cpu" else CUDAPlace(0))
    print(f"paddle_tpu_torch.launch --serve: drained; "
          f"{ledger['completed']}/{ledger['requests']} completed, "
          f"{ledger['errors']} classified errors", file=sys.stderr)
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if "--serve" in args:
        return _serve_main(args)
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.launch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nproc", type=int, default=2,
                    help="workers in the gang (PADDLE_TRAINERS_NUM role)")
    ap.add_argument("--devices-per-proc", type=int, default=1)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--elastic", action="store_true",
                    help=f"elastic supervision: comes with {_A10_2}")
    ap.add_argument("--min-procs", type=int, default=1,
                    help="elastic floor (with --elastic)")
    ap.add_argument("--checkpoint-root", default=None,
                    help="checkpoint directory (exported as "
                         "PADDLE_CHECKPOINT_ROOT; its *.tmp debris is cleared "
                         "before a restart)")
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--telemetry-root", default=None,
                    help=f"gang telemetry root: comes with {_A10_2}")
    ap.add_argument("--metrics", default=None,
                    help="JSONL file for the launcher's dist_event records "
                         "and a final counter snapshot")
    ap.add_argument("script", help="worker script")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    ns = ap.parse_args(args)

    logger = None
    if ns.metrics:
        from . import monitor as _monitor
        from .monitor import MonitorLogger

        _monitor.enable()
        logger = _monitor.get_monitor().attach_logger(MonitorLogger(ns.metrics))
    res = run_gang([sys.executable, ns.script, *ns.args], ns.nproc,
                   devices_per_proc=ns.devices_per_proc,
                   max_restarts=ns.max_restarts,
                   checkpoint_root=ns.checkpoint_root,
                   telemetry_root=ns.telemetry_root,
                   timeout=ns.timeout,
                   elastic=ns.elastic, min_procs=ns.min_procs)
    for rank, (code, out, err) in enumerate(res.workers):
        sys.stdout.write(out or "")
        if code != 0:
            sys.stderr.write(f"-- worker {rank} (exit {code}) stderr tail --\n"
                             f"{(err or '')[-2000:]}\n")
    sys.stdout.flush()
    if logger is not None:
        logger.write_snapshot()
        from . import monitor as _monitor

        _monitor.get_monitor().detach_logger(logger)
    print(f"paddle_tpu_torch.launch: {'ok' if res.ok else 'FAILED'} after "
          f"{res.incarnations} incarnation(s), {res.restarts} restart(s)",
          file=sys.stderr)
    return 0 if res.ok else 1


if __name__ == "__main__":
    sys.exit(main())

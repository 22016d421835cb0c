"""The serving part of the launcher (counterpart of paddle_tpu/launch.py):
port allocation, the `PADDLE_TRAINER_*` environment of a worker process,
and a supervised serving fleet run from the command line.

    python -m paddle_tpu_torch.launch --serve --model bert=/models/bert \\
        [--nproc 2] [--fleet-root DIR] [--buckets 1,8,32] [--device gpu|cpu]

runs `--nproc` replica processes behind the router until SIGTERM or
SIGINT, then drains them.  The replicas serve on the card (`CUDAPlace(0)`,
all of them on the one card `CUDA_VISIBLE_DEVICES` leaves first);
`--device cpu` is the only way to serve on the CPU.  Without `--serve` the
launcher supervises a training gang, which comes with data parallelism
(ROADMAP A10): `main` raises NotImplementedError.
"""
from __future__ import annotations

__all__ = ["allocate_port_block", "worker_env", "run_serving_fleet", "main"]

import argparse
import errno
import os
import random
import socket
import sys
import time
from typing import Dict, List, Optional, Sequence

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
    worker of the port sees the cards `CUDA_VISIBLE_DEVICES` lists."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO_ROOT
    env["PADDLE_TRAINER_ID"] = str(rank)
    env["PADDLE_TRAINER_ENDPOINTS"] = ",".join(endpoints)
    env["PADDLE_CURRENT_ENDPOINT"] = endpoints[rank]
    env.update(extra or {})
    return env


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
    raise NotImplementedError(
        "paddle_tpu_torch.launch supervises serving fleets (--serve); a "
        "training gang comes with data parallelism (ROADMAP A10)")


if __name__ == "__main__":
    sys.exit(main())

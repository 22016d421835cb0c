"""Multi-process bootstrap and the data-parallel gradient all-reduce
(counterpart of paddle_tpu/parallel/distributed.py).

Reference: the NCCL2 transpile mode -- `gen_nccl_id_op.cc:31` broadcasts an
ncclUniqueId keyed by trainer_id/endpoints set via PADDLE_TRAINER_ID /
PADDLE_TRAINER_ENDPOINTS / PADDLE_CURRENT_ENDPOINT
(`distribute_transpiler.py:261`).

Where the JAX package brings up JAX's coordination service, the port
brings up a `torch.distributed` process group: endpoint 0 is the
rendezvous (a TCPStore), the rest dial in.  Each rank is one process on
one device.  The backend is a rule, not a retry (`backend_for`): NCCL when
every rank has a card of its own, gloo when ranks share a card or run on
the CPU (gloo reduces CUDA tensors by staging them through the host).
Rank r takes card `r % torch.cuda.device_count()`.  When every endpoint is
a loopback address, gloo binds to the loopback device.

`make_grad_sync` builds the gradient all-reduce the executor's gang path
installs on the lowering context (core/lowering.py): dense gradients are
mean-reduced in float32 buckets, the 1/n scale applied before the cast
back to each gradient's dtype; SelectedRows gradients are all-gathered as
rows plus values.  In the "bucketed" mode each bucket's all-reduce is
launched, asynchronously, from tensor hooks as backward produces its last
gradient, in the reverse-topological order of `plan_buckets` on every
rank, and all are waited on before the optimizer ops; "serial" reduces
every dense gradient in one flat all-reduce after the backward.  Both give
each element the same sum, so at two ranks they agree bit for bit.
"""
from __future__ import annotations

import datetime
import ipaddress
import os
import socket
import threading
import time
from typing import Optional, Sequence

import torch

from ..errors import CollectiveTimeoutError
from ..monitor import MONITOR as _MON

_STATE = {"initialized": False, "world": 1, "rank": 0, "backend": None, "card": None}


def trainer_env():
    """Read the reference's trainer env-var contract."""
    tid = os.environ.get("PADDLE_TRAINER_ID")
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS")
    cur = os.environ.get("PADDLE_CURRENT_ENDPOINT")
    return (
        int(tid) if tid is not None else None,
        eps.split(",") if eps else None,
        cur,
    )


def is_initialized() -> bool:
    return _STATE["initialized"]


def backend_for(world_size: int, n_cards: int) -> str:
    """The process group's backend for `world_size` ranks on a host with
    `n_cards` cards: "nccl" when every rank has a card of its own, "gloo"
    when ranks share a card or there is none (NCCL does not put two ranks
    on one device)."""
    return "nccl" if n_cards > 0 and n_cards >= world_size else "gloo"


def card_for(rank: int, n_cards: int) -> Optional[int]:
    """The card rank `rank` runs on (None without a card)."""
    return rank % n_cards if n_cards > 0 else None


def _loopback(endpoint: str) -> bool:
    host = endpoint.rsplit(":", 1)[0].strip("[]")
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


def _loopback_device() -> Optional[str]:
    for _, name in socket.if_nameindex():
        if name == "lo" or name.startswith("lo0"):
            return name
    return None


def init_distributed(trainer_id: Optional[int] = None,
                     trainer_endpoints: Optional[Sequence[str]] = None,
                     current_endpoint: Optional[str] = None):
    """Bring up the cross-process runtime.  Arguments default to the
    PADDLE_* env vars (same contract the transpiler's NCCL2 mode used).
    Endpoint 0's host:port is the rendezvous (the gen_nccl_id role).
    Idempotent; a single endpoint needs no process group.  The rendezvous
    is bounded by FLAGS_dist_bootstrap_timeout_s: a gang whose worker
    never dials in raises CollectiveTimeoutError here."""
    if _STATE["initialized"]:
        return  # idempotent: the runtime is already bootstrapped

    env_tid, env_eps, env_cur = trainer_env()
    trainer_id = trainer_id if trainer_id is not None else env_tid
    trainer_endpoints = list(trainer_endpoints or env_eps or [])
    current_endpoint = current_endpoint or env_cur
    if trainer_id is None or not trainer_endpoints:
        raise ValueError(
            "init_distributed: need trainer_id + trainer_endpoints (args or "
            "PADDLE_TRAINER_ID / PADDLE_TRAINER_ENDPOINTS)")
    if current_endpoint and current_endpoint != trainer_endpoints[trainer_id]:
        raise ValueError(
            f"init_distributed: current_endpoint {current_endpoint!r} does not "
            f"match trainer_endpoints[{trainer_id}] = "
            f"{trainer_endpoints[trainer_id]!r}")
    world = len(trainer_endpoints)
    if world == 1:
        _STATE.update(initialized=True, world=1, rank=0)
        return  # single process: nothing to bootstrap

    import torch.distributed as dist

    from ..flags import flag as _flag

    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = backend_for(world, n_cards)
    card = card_for(trainer_id, n_cards)
    if card is not None:
        torch.cuda.set_device(card)
    if backend == "gloo" and all(_loopback(e) for e in trainer_endpoints):
        lo = _loopback_device()
        if lo is not None:
            os.environ.setdefault("GLOO_SOCKET_IFNAME", lo)
    boot_timeout = float(_flag("FLAGS_dist_bootstrap_timeout_s"))
    outcome = {}

    def _boot():
        try:
            # the store's timeout bounds the rendezvous; collectives keep
            # torch's default timeout
            host, port = trainer_endpoints[0].rsplit(":", 1)
            store = dist.TCPStore(host.strip("[]"), int(port), world, trainer_id == 0,
                                  timeout=datetime.timedelta(seconds=boot_timeout + 10))
            dist.init_process_group(backend, store=store, world_size=world, rank=trainer_id)
            outcome["ok"] = True
        except Exception as e:  # reported by the waiting thread
            outcome["error"] = e

    # the rendezvous is the first gang-wide wait, so it is the first place a
    # worker that never started wedges the others: run it on a thread and
    # raise at the deadline (torch's own timeout is a little wider, a
    # backstop for the abandoned thread)
    t0 = time.monotonic()
    boot = threading.Thread(target=_boot, name="paddle-dist-boot", daemon=True)
    boot.start()
    boot.join(boot_timeout)
    if boot.is_alive() or "error" in outcome:
        err = outcome.get("error")
        raise CollectiveTimeoutError(
            f"init_distributed: the gang's rendezvous at {trainer_endpoints[0]} "
            f"({world} ranks, {backend}) did not complete within "
            f"{boot_timeout:g} s (FLAGS_dist_bootstrap_timeout_s)"
            + (f": {type(err).__name__}: {err}" if err is not None else ""),
            rank=trainer_id, collective="init_process_group") from err
    _STATE.update(initialized=True, world=world, rank=trainer_id, backend=backend, card=card)
    _MON.gauge(f"dist.backend.{backend}").set(1)
    _MON.gauge("dist.world_size").set(world)
    _MON.observe("dist.bootstrap", time.monotonic() - t0)


def backend() -> Optional[str]:
    """The process group's backend ("nccl" / "gloo"), None without one."""
    return _STATE["backend"]


def card() -> Optional[int]:
    """The card this rank runs on (None on the CPU or without a gang)."""
    return _STATE["card"]


def global_mesh(axes=None):
    """Mesh over every rank of the gang.  axes defaults to one
    data-parallel axis spanning everything."""
    from .mesh import make_mesh

    ranks = list(range(num_trainers()))
    if axes is None:
        return make_mesh((len(ranks),), ("dp",), devices=ranks)
    shape = tuple(n for n, _ in axes)
    names = tuple(a for _, a in axes)
    return make_mesh(shape, names, devices=ranks)


def trainer_id() -> int:
    return _STATE["rank"]


def num_trainers() -> int:
    return _STATE["world"]


# --------------------------------------------------------------------------
# collectives over the gang (each a no-op at world size 1)
# --------------------------------------------------------------------------

def _staged(t: torch.Tensor) -> torch.Tensor:
    """`t` as the backend takes it for a gather: gloo gathers host tensors
    only, so a CUDA tensor goes through a host copy there."""
    return t.cpu() if backend() == "gloo" and t.is_cuda else t


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the gang in place; returns it."""
    if num_trainers() > 1:
        import torch.distributed as dist

        dist.all_reduce(t)
    return t


def rank_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of `t` over the ranks, summed in float32 (the JAX package's
    pmean: the sum, then a division by n), in `t`'s dtype."""
    n = num_trainers()
    if n == 1:
        return t
    s = all_reduce_sum_(t.detach().to(torch.float32).clone())
    return (s / n).to(t.dtype)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's `t` along axis 0, in rank order (ranks may
    hold different row counts); the result lies where `t` does."""
    n = num_trainers()
    if n == 1:
        return t
    import torch.distributed as dist

    src = _staged(t.detach())
    width = {torch.bfloat16: torch.int16, torch.float16: torch.int16, torch.bool: torch.uint8}
    raw = src.view(width[src.dtype]) if src.dtype in width else src
    rows = torch.tensor([raw.shape[0]], dtype=torch.int64, device=raw.device)
    sizes = [torch.zeros_like(rows) for _ in range(n)]
    dist.all_gather(sizes, rows)
    sizes = [int(s.item()) for s in sizes]
    padded = raw.new_zeros((max(sizes),) + tuple(raw.shape[1:]))
    padded[:raw.shape[0]] = raw
    parts = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(parts, padded)
    out = torch.cat([p[:k] for p, k in zip(parts, sizes)])
    if src.dtype in width:
        out = out.view(src.dtype)
    return out.to(t.device)


class AllReduceSum(torch.autograd.Function):
    """A differentiable sum over the gang: the backward sums the
    cotangents over the gang too (each rank's loss depends on every rank's
    input through the sum).  Batch norm's global statistics use it."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_sum_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone())


# --------------------------------------------------------------------------
# the data-parallel gradient all-reduce (DDP-style bucketing)
# --------------------------------------------------------------------------

def plan_buckets(named_sizes, cap_bytes):
    """Group (name, nbytes) pairs into size-capped buckets, preserving
    order: a bucket closes when adding the next grad would exceed
    `cap_bytes` (a single over-cap grad gets its own bucket).  Callers pass
    grads in REVERSE-topological order -- the order backward produces them --
    so early buckets complete while later grads are still being computed
    (the PyTorch-DDP bucketing strategy)."""
    buckets, cur, cur_bytes = [], [], 0
    for name, nbytes in named_sizes:
        if cur and cur_bytes + nbytes > cap_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(name)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


_ALIGN = 4  # float32 elements: each gradient's segment starts 16 bytes aligned


def _padded(k):
    return -(-k // _ALIGN) * _ALIGN


def _flat_f32(vals):
    """The gradients flattened into one float32 buffer, each segment
    starting on a 16-byte boundary (zeros between): a float32 gradient
    comes back as a view of the buffer, and the Adam kernel takes its
    vector path only for 16-byte-aligned pointers, rounding otherwise
    (csrc/adam.cu), so an unaligned view would make the update depend on
    the bucket layout."""
    parts = []
    for v in vals:
        f = v.reshape(-1).to(torch.float32)
        pad = _padded(f.numel()) - f.numel()
        parts.append(f)
        if pad:
            parts.append(f.new_zeros(pad))
    return torch.cat(parts)


def _split_scaled(flat, vals, inv_n):
    """The reduced flat bucket, scaled by 1/n in float32 before the cast
    back to each gradient's dtype (a division after the cast would round
    twice in bf16), split into the gradients' shapes."""
    flat.mul_(inv_n)
    out, off = [], 0
    for v in vals:
        k = v.numel()
        out.append(flat[off:off + k].reshape(v.shape).to(v.dtype))
        off += _padded(k)
    return out


def all_reduce_mean(vals):
    """`vals` mean-reduced over the gang in one float32 all-reduce, the 1/n
    scale applied before the cast back to each one's dtype."""
    flat = all_reduce_sum_(_flat_f32(vals))
    return _split_scaled(flat, vals, 1.0 / num_trainers())


def _sparse_mean(g):
    """A SelectedRows gradient synced over the gang: every rank's rows and
    values all-gathered in rank order, the values scaled by 1/n in float32
    (the optimizer's merge sums duplicate rows)."""
    from ..core.selected_rows import SelectedRows

    rows = all_gather_rows(g.rows)
    vals = all_gather_rows(g.values)
    vals = (vals.to(torch.float32) * (1.0 / num_trainers())).to(g.values.dtype)
    return SelectedRows(rows, vals, g.height)


class GradSync:
    """The callable `make_grad_sync` returns: `sync(named_grads)` takes
    [(grad_name, value)] in forward-parameter order and returns
    {grad_name: synced value}; `hooked(named)` starts the bucketed mode's
    backward-overlapped session.  `last_ms` and `last_bytes` are the last
    step's exposed sync time (host clock, after the device caught up) and
    its dense bytes (every dense gradient in float32)."""

    def __init__(self, axis_name: str, bucket_bytes: int, mode: str):
        self.axis_name = axis_name
        self.bucket_bytes = int(bucket_bytes)
        self.mode = mode
        self.last_ms = 0.0
        self.last_bytes = 0

    def _buckets(self, dense):
        if self.mode == "serial":
            return [[nm for nm, _ in dense]]
        return plan_buckets([(nm, g.numel() * 4) for nm, g in dense], self.bucket_bytes)

    def _account(self, t0, dense):
        self.last_ms = (time.perf_counter() - t0) * 1e3
        self.last_bytes = sum(g.numel() * 4 for _, g in dense)
        _MON.observe("dist.grad_sync", self.last_ms / 1e3)
        _MON.counter("dist.grad_sync_bytes").inc(self.last_bytes)

    def __call__(self, named_grads):
        from ..core.selected_rows import SelectedRows

        _settle(named_grads)
        t0 = time.perf_counter()
        out, dense = {}, []
        for name, g in named_grads:
            if isinstance(g, SelectedRows):
                out[name] = _sparse_mean(g)
            else:
                dense.append((name, g))
        dense = dense[::-1]  # reverse-topological: backward-production order
        by_name = dict(dense)
        for bucket in self._buckets(dense):
            out.update(zip(bucket, all_reduce_mean([by_name[nm] for nm in bucket])))
        _settle(list(out.items()))
        self._account(t0, dense)
        return out

    def hooked(self, named):
        """The bucketed mode's session for one backward region: `named` is
        [(grad_name, tensor)] of every dense gradient in forward-parameter
        order, each tensor either an autograd leaf (hooked) or a stand-in
        of the gradient's shape (its zero gradient is added at `finish`).
        None in the serial mode or at world size 1."""
        if self.mode != "bucketed" or num_trainers() == 1:
            return None
        return _HookedBuckets(self, named)


class _HookedBuckets:
    """Launches each bucket's async all-reduce from the hooks of its
    gradients' leaves once backward has produced the bucket's last one,
    strictly in bucket order, so every rank issues the same collectives in
    the same order."""

    def __init__(self, sync: GradSync, named):
        self.sync = sync
        dense = list(named)[::-1]
        self.shapes = {nm: t for nm, t in dense}
        self.buckets = plan_buckets([(nm, t.numel() * 4) for nm, t in dense], sync.bucket_bytes)
        self.bucket_of = {nm: b for b, names in enumerate(self.buckets) for nm in names}
        self.got = [dict() for _ in self.buckets]
        self.works = [None] * len(self.buckets)
        self.next = 0
        self.handles = [t.register_hook(self._hook(nm)) for nm, t in dense
                        if isinstance(t, torch.Tensor) and t.requires_grad]

    def _hook(self, name):
        def ready(grad):
            self.got[self.bucket_of[name]][name] = grad
            self._launch_ready()
        return ready

    def _launch_ready(self):
        while (self.next < len(self.buckets)
               and len(self.got[self.next]) == len(self.buckets[self.next])):
            self._launch(self.next)
            self.next += 1

    def _launch(self, b):
        import torch.distributed as dist

        vals = [self.got[b][nm] for nm in self.buckets[b]]
        flat = _flat_f32(vals)
        self.works[b] = (flat, vals, dist.all_reduce(flat, async_op=True))

    def finish(self, named_grads):
        """Launch the buckets whose gradients never reached a hook (a
        parameter the loss does not read), wait for every bucket, and
        return {grad_name: synced value}, SelectedRows included."""
        from ..core.selected_rows import SelectedRows

        for h in self.handles:
            h.remove()
        inv_n = 1.0 / num_trainers()
        _settle(named_grads)
        t0 = time.perf_counter()
        out = {}
        for name, g in named_grads:
            if isinstance(g, SelectedRows):
                out[name] = _sparse_mean(g)
            elif name in self.bucket_of:
                self.got[self.bucket_of[name]].setdefault(name, g)
        self._launch_ready()
        if self.next != len(self.buckets):
            raise RuntimeError("bucketed gradient sync: a bucket lacks a gradient")
        for names, (flat, vals, work) in zip(self.buckets, self.works):
            work.wait()
            out.update(zip(names, _split_scaled(flat, vals, inv_n)))
        _settle(list(out.items()))
        self.sync._account(t0, [(nm, self.shapes[nm]) for names in self.buckets
                                for nm in names])
        return out


def _settle(named):
    """Wait for the card to finish what the named tensors depend on, so a
    host clock around the sync times the sync alone."""
    for _, t in named:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def make_grad_sync(axis_name: str, bucket_bytes: int, mode: str = "bucketed"):
    """Build the grad-sync callable the executor installs on the
    LoweringContext (core/lowering.py) for a gang step.

    Receives [(grad_name, value)] in forward-parameter order, returns
    {grad_name: synced_value}.  Dense grads are MEAN-reduced over the gang
    (sync-SGD; each rank computed grads of its LOCAL-batch mean loss).
    SelectedRows grads (is_sparse embeddings) are synced by all-gathering
    rows+values -- the concatenated slab is the global sparse gradient and
    the optimizer's merge sums duplicates.

    mode="bucketed": dense grads are taken in REVERSE order (the order
    backward produces them) and grouped into `bucket_bytes`-capped buckets,
    one all-reduce per bucket, each launched from the backward's tensor
    hooks (`GradSync.hooked`).  mode="serial": ONE flat all-reduce over
    every dense grad after the whole backward.  Both modes are
    element-wise identical: bucketing never changes what each element is
    summed with."""
    if mode not in ("bucketed", "serial"):
        raise ValueError(f"make_grad_sync: unknown mode {mode!r}")
    return GradSync(axis_name, bucket_bytes, mode)

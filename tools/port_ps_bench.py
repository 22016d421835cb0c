#!/usr/bin/env python3
"""Where a host-tier push's time goes, at chip_smoke phase 69's shape (one
DeepFM batch of 4096 x 26 ids over a [200000, 16] table, the hot quarter in
process): the numpy pieces alone (the hot rows' np.add.at, the client's
np.unique and merge, the server's _merge_rows and row update, the frame's
packing, a journal record appended with and without its fsync), then the
pull and the push of those rows against an in-process ParameterServer,
one with a snapshot directory (its journal) and a supervised pserver child.

    python3 tools/port_ps_bench.py

Prints numpy's version, torch's intra-op threads and the CPU count, then
one line a piece: the median of 7 calls in ms.  Runs on the host only (the
child hides the card); imports nothing of JAX or paddle_tpu.
"""
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from paddle_tpu_torch import io as tio  # noqa: E402
from paddle_tpu_torch import param_server as ps  # noqa: E402

VOCAB, DIM, BATCH, FIELDS, LR = 200000, 16, 4096, 26, 0.05
HOT = VOCAB // 4


def timed(name, fn, n=7):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    print(f"{name}: {1e3 * np.median(times):.2f} ms", flush=True)
    return out


def main():
    print("numpy", np.__version__, "torch threads", torch.get_num_threads(), "cpus",
          os.cpu_count(), flush=True)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, VOCAB, (BATCH, FIELDS))
    g = rng.rand(BATCH * FIELDS, DIM).astype("f4")
    flat = ids.reshape(-1)
    hm = flat < HOT
    cold = flat[~hm] - HOT
    hot_t = np.zeros((HOT, DIM), "f4")
    timed("hot add.at", lambda: np.add.at(hot_t, flat[hm], -LR * g[hm]))
    uniq, inv = timed("client unique", lambda: np.unique(cold, return_inverse=True))

    def merge():
        m = np.zeros((uniq.size, DIM), "f4")
        np.add.at(m, inv, g[~hm])
        return m

    m = timed("client add.at merge", merge)
    timed("server _merge_rows", lambda: ps._merge_rows(uniq, m))
    table = np.zeros((VOCAB - HOT, DIM), "f4")

    def update():
        table[uniq] += -LR * m

    timed("server update", update)
    payload = timed("pack", lambda: ps._pack_arr(np.asarray(uniq, np.int64)) + ps._pack_arr(m))
    os.makedirs(os.path.join(ROOT, ".chip_smoke_tmp"), exist_ok=True)
    d = tempfile.mkdtemp(dir=os.path.join(ROOT, ".chip_smoke_tmp"))
    try:
        pieces_against_servers(d, payload, uniq, m)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return 0


def pieces_against_servers(d, payload, uniq, m):
    """The journal's appends in `d`, then each server's pull and push."""
    timed("journal append fsync", lambda: tio.append_record(os.path.join(d, "j.log"), b"S" + payload))
    timed("journal append no fsync",
          lambda: tio.append_record(os.path.join(d, "k.log"), b"S" + payload, fsync=False))
    for kind in ("inproc", "inproc_journal", "child"):
        if kind == "child":
            sup = ps.PServerSupervisor(os.path.join(d, "sup"), optimizer="sgd", lr=LR,
                                       snapshot_every_ops=64).start().wait_ready()
            endpoint = sup.endpoint
        else:
            srv = ps.ParameterServer(
                optimizer="sgd", lr=LR, snapshot_every_ops=64,
                snapshot_dir=os.path.join(d, kind) if kind == "inproc_journal" else None).start()
            endpoint = srv.endpoint
        client = ps.KVClient(endpoint)
        client.create("v", np.zeros((VOCAB - HOT, DIM), "f4"))
        timed(f"{kind} pull", lambda: client.pull("v", uniq))
        timed(f"{kind} push", lambda: client.push("v", uniq, m))
        client.close()
        if kind == "child":
            sup.stop()
        else:
            srv.stop()


if __name__ == "__main__":
    sys.exit(main())

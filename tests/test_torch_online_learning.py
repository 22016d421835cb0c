"""Fault-hardened online learning in the port on the CPU: the supervised
pserver child, the tiered table's degraded mode, the sparse publish ladder
under rot_row, the compound kill_pserver@2;rot_row@1, and the perf_report
gates on the port's own metrics stream (tests/test_online_learning.py and
tests/test_compound_faults.py:176, against the port).

Tolerances: digests, tables and served outputs exactly (bit for bit); the
SIGKILL run's final table against the JAX package's server fed the same
pushes exactly."""
import json
import os
import sys

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu import param_server as j_ps
from paddle_tpu_torch import io, layers, monitor
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.errors import ParamServerError, ServingError
from paddle_tpu_torch.faults import FaultInjector
from paddle_tpu_torch.launch import _ephemeral_low
from paddle_tpu_torch.parallel import TieredEmbedding
from paddle_tpu_torch.param_server import KVClient, ParameterServer, PServerSupervisor

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tools"))
import perf_report  # noqa: E402


@pytest.fixture
def mon():
    monitor.reset()
    monitor.enable()
    try:
        yield monitor
    finally:
        monitor.disable()
        monitor.reset()


def _environ(pid):
    with open(f"/proc/{pid}/environ", "rb") as f:
        return dict(kv.split(b"=", 1) for kv in f.read().split(b"\0") if b"=" in kv)


# --- the supervised child: SIGKILL and SIGSTOP ---------------------------------

def test_supervisor_sigkill_bit_identical_and_exactly_once(tmp_path):
    """SIGKILL the pserver child mid-stream: the supervisor respawns it on
    the SAME endpoint, the journal replays bit for bit (digest equal across
    the kill), the client's retried pushes land exactly once, and the final
    table equals the JAX package's server fed the same pushes.  The child
    is the port's module with the card hidden from it."""
    sup = PServerSupervisor(str(tmp_path / "ps"), optimizer="sgd", lr=0.1,
                            snapshot_every_ops=4, max_restarts=2).start()
    ref = j_ps.ParameterServer(optimizer="sgd", lr=0.1).start()
    try:
        sup.wait_ready()
        env = _environ(sup._proc.pid)
        with open(f"/proc/{sup._proc.pid}/cmdline", "rb") as f:
            assert b"paddle_tpu_torch.param_server" in f.read()
        assert env[b"CUDA_VISIBLE_DEVICES"] == b"" and b"FLAGS_fault_spec" not in env
        low = _ephemeral_low()
        assert low is None or sup.port < low  # a restart never loses its port
        c, r = KVClient(sup.endpoint, retries=8, backoff_base_s=0.2), j_ps.KVClient(ref.endpoint)
        rng = np.random.RandomState(1)
        table = rng.rand(32, 4).astype("f4")
        pushes = [(rng.randint(0, 32, 4).astype(np.int64), rng.rand(4, 4).astype("f4"))
                  for _ in range(6)] + [(np.array([0], np.int64), np.ones((1, 4), "f4"))]
        for cl in (c, r):
            cl.create("t", table)
        for ids, g in pushes[:6]:
            c.push("t", ids, g)
            r.push("t", ids, g)
        before = c.table_digest("t")
        sup.kill()
        assert c.table_digest("t") == before  # the retry loop rode the restart out
        t0 = c.fetch_table("t")
        c.push("t", *pushes[6])
        r.push("t", *pushes[6])
        t1 = c.fetch_table("t")
        np.testing.assert_allclose(t1[0], t0[0] - 0.1, rtol=1e-6)
        np.testing.assert_array_equal(t1[1:], t0[1:])
        np.testing.assert_array_equal(t1, r.fetch_table("t"))
        assert c.table_digest("t") == r.table_digest("t")
        assert sup.restarts == 1 and not sup.failed
        c.close()
        r.close()
    finally:
        sup.stop()
        ref.stop()


def test_a_stalled_pserver_is_killed_and_respawned(tmp_path, mon):
    """stall_pserver SIGSTOPs the child past its health deadline: the
    supervisor kills it and respawns it, and a pull rides the gap out."""
    sup = PServerSupervisor(str(tmp_path / "ps"), optimizer="sgd", lr=0.1,
                            max_restarts=2).start()
    try:
        sup.wait_ready()
        c = KVClient(sup.endpoint, timeout_s=2.0, retries=8, backoff_base_s=0.2)
        c.create("t", np.arange(8, dtype="f4").reshape(4, 2))
        inj = FaultInjector("stall_pserver@1:4")
        inj.on_dispatch(1)
        assert inj.pending()  # no supervisor yet: pending
        inj.set_pserver(sup)
        inj.on_dispatch(1)
        assert not inj.pending() and inj.summary() == {"stall_pserver": 1}
        np.testing.assert_array_equal(c.pull("t", np.array([3])), [[6, 7]])
        assert sup.restarts == 1 and mon.counter("ps.stall_kills").value == 1
        c.close()
    finally:
        sup.stop()


# --- degraded mode ---------------------------------------------------------------

def test_degraded_mode_bounded_then_terminal(mon):
    """With the host tier dead and degraded_ok=True, lookups run
    hot-shard-only (cold rows zero) while host_lag_steps rises; past
    FLAGS_max_host_lag_steps the next failure is TERMINAL."""
    srv = ParameterServer(optimizer="sgd", lr=0.1).start()
    c = KVClient(srv.endpoint, retries=1, timeout_s=2.0, backoff_base_s=0.0)
    emb = TieredEmbedding(c, "tbl", vocab_size=16, dim=2, hot_rows=8, degraded_ok=True, seed=0)
    ids = np.array([[1, 9]])  # one hot row, one cold row
    warm = emb.lookup(ids)
    assert np.abs(warm[0, 1]).sum() > 0  # the cold row served while healthy
    srv.stop()
    c.close()
    fluid.set_flags({"FLAGS_max_host_lag_steps": 3})
    try:
        for k in (1, 2):
            out = emb.lookup(ids)
            np.testing.assert_array_equal(out[0, 1], np.zeros(2, "f4"))
            np.testing.assert_array_equal(out[0, 0], warm[0, 0])  # hot intact
            assert emb.host_lag_steps == k
            assert mon.gauge("sparse.host_lag_steps").value == k
        # a push during the outage drops the COLD slab only, counted; it is
        # itself one degraded step against the budget (lag 3)
        hot_before = emb.hot[1].copy()
        emb.apply_grad(ids.reshape(-1), np.ones((2, 2), "f4"))
        np.testing.assert_allclose(emb.hot[1], hot_before - 0.1)
        assert mon.counter("sparse.dropped_pushes").value == 1
        assert emb.host_lag_steps == 3
        with pytest.raises(ParamServerError, match="FLAGS_max_host_lag_steps=3") as ei:
            emb.lookup(ids)  # lag 4 > bound: terminal
        assert not ei.value.transient
    finally:
        fluid.set_flags({"FLAGS_max_host_lag_steps": 0})
        c.close()


# --- the sparse publish ladder: rot_row -----------------------------------------

def _sparse_model(tmp_path, name, vocab=24, dim=4, feat=3):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = layers.data("ids", [feat], dtype="int64")
        e = layers.embedding(ids, size=[vocab, dim], is_sparse=True,
                             param_attr=fluid.ParamAttr(name=name))
        pred = layers.fc(layers.reshape(e, [-1, feat * dim]), 1,
                         param_attr=fluid.ParamAttr(name=name + "_fc"), bias_attr=False)
    startup.random_seed = 5
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    d0 = str(tmp_path / "model-0")
    io.save_inference_model(d0, ["ids"], [pred], exe, main, scope)
    return main, scope, d0


def _snapshot(tmp_path, dirname, main, scope, name, table):
    """A sparse snapshot: the table as one SelectedRows over every row, the
    dense vars as they are, through io.save_sharded."""
    import torch

    vocab = table.shape[0]
    s = fluid.Scope()
    s.set_var(name, SelectedRows(torch.arange(vocab, dtype=torch.int64),
                                 torch.from_numpy(np.array(table, "f4")), vocab))
    names = [v.name for v in io._persistables(main)]
    for n in names:
        if n != name:
            s.set_var(n, scope.to_numpy(n))
    d = str(tmp_path / dirname)
    io.save_sharded(d, names, s, program=main, process_index=0)
    return d


def test_rot_row_rejected_last_good_serves(tmp_path, mon):
    """rot_row flips a byte of a committed SelectedRows VALUES shard: the
    ladder rejects and quarantines it, and the previous sparse snapshot
    keeps serving bit for bit."""
    from paddle_tpu_torch.serving import ModelRegistry, publish, quarantine_marker

    main, scope, d0 = _sparse_model(tmp_path, "q_tbl")
    reg = ModelRegistry(place=fluid.CPUPlace())
    reg.load("q", d0)
    feeds = {"ids": np.array([[1, 2, 3]], np.int64)}
    table = scope.to_numpy("q_tbl").copy()
    inj = FaultInjector("rot_row@1")
    good = _snapshot(tmp_path, "snap-1", main, scope, "q_tbl", table + 0.25)
    inj.on_commit(good)  # ordinal 0: not the target
    publish(reg, "q", good)
    out_good = np.array(reg.acquire("q").run(feeds)[0])
    bad = _snapshot(tmp_path, "snap-2", main, scope, "q_tbl", table + 0.5)
    inj.on_commit(bad)  # ordinal 1: flips a byte of the .vals. shard
    assert inj.summary() == {"rot_row": 1}
    with pytest.raises(ServingError, match="REJECTED"):
        publish(reg, "q", bad)
    assert quarantine_marker(bad) is not None and quarantine_marker(good) is None
    np.testing.assert_array_equal(np.array(reg.acquire("q").run(feeds)[0]), out_good)
    evs = [r for r in monitor.step_records() if r.get("kind") == "serving_event"]
    assert any(r.get("action") == "publish" and r.get("sparse_digest") for r in evs)
    assert any(r.get("action") == "publish_rejected" for r in evs)


def test_kill_pserver_mid_publish_cadence_converges_on_last_good(tmp_path, mon):
    """`kill_pserver@2;rot_row@1` (tests/test_compound_faults.py:176): the
    pushes ride the respawn out, the ladder rejects exactly the rotted
    commit while the previous version serves, and the next clean periods
    converge on new versions trained across the restart."""
    from paddle_tpu_torch.serving import ModelRegistry, publish

    main, scope, d0 = _sparse_model(tmp_path, "p_tbl")
    reg = ModelRegistry(place=fluid.CPUPlace())
    reg.load("m", d0)
    feeds = {"ids": np.array([[1, 2, 3]], np.int64)}
    sup = PServerSupervisor(str(tmp_path / "ps"), optimizer="sgd", lr=0.1,
                            snapshot_every_ops=4, max_restarts=2).start()
    try:
        sup.wait_ready()
        c = KVClient(sup.endpoint, retries=8, backoff_base_s=0.2)
        c.create("p_tbl", scope.to_numpy("p_tbl").copy())
        inj = FaultInjector("kill_pserver@2;rot_row@1").set_pserver(sup)
        rng = np.random.RandomState(7)
        push_ids = np.array([1, 2, 3, 5], np.int64)  # the served rows move every period
        outs, rejected = {}, []
        for step in range(4):
            inj.on_dispatch(step)  # step 2: SIGKILL the child
            c.push("p_tbl", push_ids, rng.rand(4, 4).astype("f4") + 0.1)
            d = _snapshot(tmp_path, f"snap-{step}", main, scope, "p_tbl", c.fetch_table("p_tbl"))
            inj.on_commit(d)  # commit ordinal 1 gets the rotted row
            try:
                publish(reg, "m", d)
            except ServingError:
                rejected.append(step)
            outs[step] = np.array(reg.acquire("m").run(feeds)[0])
        assert sup.restarts == 1 and not sup.failed
        assert rejected == [1] and inj.summary() == {"kill_pserver": 1, "rot_row": 1}
        np.testing.assert_array_equal(outs[1], outs[0])  # the last good version served
        assert not np.array_equal(outs[2], outs[1])
        assert not np.array_equal(outs[3], outs[2])
        c.close()
    finally:
        sup.stop()


# --- the perf_report gates on the port's metrics stream -------------------------

def _lines(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def test_host_lag_and_publish_staleness_gates_on_the_ports_stream(tmp_path, mon):
    """The port's own run writes the stream: a publish cadence with an
    enospc on its step-6 publish (staleness 3), and two degraded lookups of
    a tiered table whose pserver died (lag 2).  The gates hold the declared
    bounds, trip one below them, and fail a stream without the evidence."""
    path = str(tmp_path / "metrics.jsonl")
    logger = monitor.attach_logger(monitor.MonitorLogger(path))
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = layers.data("x", [4], dtype="float32")
            y = layers.data("y", [1], dtype="float32")
            loss = layers.mean(layers.square_error_cost(
                layers.fc(x, 1, param_attr=fluid.ParamAttr(name="cw")), y))
            fluid.optimizer.SGD(0.1).minimize(loss)
        startup.random_seed = 3
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(0)
        feeds = [{"x": rng.rand(8, 4).astype("f4"), "y": rng.rand(8, 1).astype("f4")}
                 for _ in range(12)]
        stats = fluid.resilient_train_loop(
            exe, main, lambda: list(feeds), [loss], scope=scope,
            injector=FaultInjector("enospc@6"),
            publish_hook=lambda step: io.save_vars(str(tmp_path / f"pub-{step}"), ["cw"], scope),
            publish_period_steps=3, max_inflight=1, policy=fluid.RetryPolicy(backoff_base_s=0.0))
        assert (stats.steps, stats.publish_failures) == (12, 1)
        srv = ParameterServer().start()
        c = KVClient(srv.endpoint, retries=1, timeout_s=2.0, backoff_base_s=0.0)
        emb = TieredEmbedding(c, "tbl", vocab_size=16, dim=2, hot_rows=8, seed=0)
        srv.stop()
        c.close()
        for _ in range(2):
            emb.lookup(np.array([[1, 9]]))
        logger.write_snapshot()
    finally:
        monitor.detach_logger(logger)
        logger.close()
    lines = _lines(path)
    assert perf_report.publish_staleness_steps(lines) == 3
    assert perf_report.host_lag_steps(lines) == 2
    late = dict(steady_after=len(lines) + 2)  # the steady-state recompile gate is not these
    assert perf_report.check(path, max_publish_staleness_steps=3, **late) == 0
    assert perf_report.check(path, max_publish_staleness_steps=2, **late) == 1
    assert perf_report.check(path, max_host_lag_steps=2, **late) == 0
    assert perf_report.check(path, max_host_lag_steps=1, **late) == 1
    silent = str(tmp_path / "silent.jsonl")
    with open(silent, "w") as f:  # the step records without the evidence
        for r in lines:
            if r.get("kind") == "step":
                f.write(json.dumps(r) + "\n")
    assert perf_report.check(silent, max_publish_staleness_steps=100, **late) == 1
    assert perf_report.check(silent, max_host_lag_steps=100, **late) == 1

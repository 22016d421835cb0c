"""The port's host parameter service (paddle_tpu_torch/param_server.py)
against the JAX package's on the CPU.

Every case of tests/test_param_server.py runs in both packages; the wire is
held byte for byte (a client of either package talks to a server of the
other, with equal tables and equal `table_digest` strings); a journal and
snapshot directory written by one package's server recovers in the other's
with the same digest, op count and dedup map; the exactly-once,
stale-sequence and frame-cap cases of tests/test_online_learning.py run in
both; and host-tier training matches the in-program sparse run in the port
and the JAX package's run.

Tolerances: tables, digests, bytes and counts exactly; the host-tier runs
against the in-program runs 1e-4 relative / 1e-5 absolute (the JAX test's
own rule), the port's host-tier run against the JAX package's 1e-5."""
import struct

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import monitor as j_monitor
from paddle_tpu import param_server as j_ps
from paddle_tpu_torch import monitor as t_monitor
from paddle_tpu_torch import param_server as t_ps

PKGS = {"jax": dict(fluid=jfluid, ps=j_ps, monitor=j_monitor),
        "torch": dict(fluid=tfluid, ps=t_ps, monitor=t_monitor)}
BOTH = pytest.mark.parametrize("pkg", sorted(PKGS))

# --- the cases of tests/test_param_server.py, in both packages ---------------

@BOTH
def test_pull_push_roundtrip_sgd(pkg):
    ps = PKGS[pkg]["ps"]
    srv = ps.ParameterServer(optimizer="sgd", lr=0.5).start()
    try:
        c = ps.KVClient(srv.endpoint)
        table = np.arange(12, dtype="f4").reshape(6, 2)
        c.create("t", table)
        np.testing.assert_array_equal(c.pull("t", np.array([1, 4])), table[[1, 4]])
        c.push("t", np.array([1, 1, 4]), np.ones((3, 2), "f4"))  # row 1 twice: summed
        exp = table.copy()
        exp[1] -= 0.5 * 2
        exp[4] -= 0.5
        np.testing.assert_array_equal(c.fetch_table("t"), exp)
        c.close()
    finally:
        srv.stop()


@BOTH
def test_server_error_reply_keeps_connection(pkg):
    ps = PKGS[pkg]["ps"]
    srv = ps.ParameterServer().start()
    try:
        c = ps.KVClient(srv.endpoint)
        with pytest.raises(RuntimeError, match="KeyError"):
            c.pull("no_such_table", np.array([0]))
        c.create("t2", np.ones((3, 2), "f4"))
        np.testing.assert_array_equal(c.pull("t2", np.array([1])), [[1, 1]])
        c.close()
    finally:
        srv.stop()


@BOTH
def test_adagrad_push_merges_duplicates(pkg):
    ps = PKGS[pkg]["ps"]
    srv = ps.ParameterServer(optimizer="adagrad", lr=1.0).start()
    try:
        c = ps.KVClient(srv.endpoint)
        c.create("t", np.zeros((3, 1), "f4"))
        c.push("t", np.array([1, 1]), np.array([[1.0], [2.0]], "f4"))
        # merged: g = 3, acc = 9, update = -3 / (3 + eps)
        np.testing.assert_allclose(c.fetch_table("t")[1], [-1.0], atol=1e-5)
        c.close()
    finally:
        srv.stop()


@BOTH
def test_async_communicator_converges_to_same_total(pkg):
    ps = PKGS[pkg]["ps"]
    srv = ps.ParameterServer(optimizer="sgd", lr=1.0).start()
    try:
        c = ps.KVClient(srv.endpoint)
        c.create("t", np.zeros((5, 2), "f4"))
        comm = ps.AsyncCommunicator(c, send_interval_s=0.002).start()
        rng = np.random.RandomState(0)
        total = np.zeros((5, 2), "f4")
        for _ in range(50):
            ids = rng.randint(0, 5, size=4)
            g = rng.rand(4, 2).astype("f4")
            comm.push_async("t", ids, g)
            np.add.at(total, ids, g)
        comm.stop()
        np.testing.assert_allclose(c.fetch_table("t"), -total, rtol=1e-5, atol=1e-5)
        c.close()
    finally:
        srv.stop()


# --- the wire ------------------------------------------------------------------

@pytest.mark.parametrize("dtype,shape", [("float32", (4, 3)), ("int64", (7,)),
                                         ("float64", ()), ("int32", (2, 0, 3))])
def test_array_frames_are_the_jax_packages_bytes(dtype, shape):
    a = np.arange(int(np.prod(shape)), dtype=dtype).reshape(shape)
    frame = j_ps._pack_arr(a)
    assert t_ps._pack_arr(a) == frame
    (got, end), (want, wend) = t_ps._unpack_arr(frame), j_ps._unpack_arr(frame)
    # a 0-d array travels as shape (1,) in both (np.ascontiguousarray)
    assert (got.dtype, got.shape, end) == (want.dtype, want.shape, wend) == (
        a.dtype, a.shape or (1,), len(frame))
    np.testing.assert_array_equal(got, want)
    assert t_ps._MAGIC == j_ps._MAGIC == b"PTPS"


def _drive(ps, endpoint, ops):
    """Run one scripted session through `ps.KVClient`; returns what it read."""
    c = ps.KVClient(endpoint)
    rng = np.random.RandomState(4)
    c.create("emb", rng.rand(20, 3).astype("f4"))
    c.create("w", rng.rand(20, 1).astype("f4"))
    out = {}
    for i in range(ops):
        name = ("emb", "w")[i % 2]
        ids = rng.randint(0, 20, 6).astype(np.int64)  # repeats: the merge sums them
        c.push(name, ids, rng.rand(6, 3 if name == "emb" else 1).astype("f4"))
    out["pull"] = c.pull("emb", np.array([0, 5, 19, 5]))
    out["emb"], out["w"] = c.fetch_table("emb"), c.fetch_table("w")
    out["digests"] = (c.table_digest("emb"), c.table_digest("w"))
    c.close()
    return out


@pytest.mark.parametrize("client,server", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_a_client_of_either_package_talks_to_a_server_of_the_other(client, server, optimizer):
    """The same session through a mixed pair and through the JAX package's
    own pair ends in bitwise equal tables and equal digest strings."""
    got_srv = PKGS[server]["ps"].ParameterServer(optimizer=optimizer, lr=0.3).start()
    ref_srv = j_ps.ParameterServer(optimizer=optimizer, lr=0.3).start()
    try:
        got = _drive(PKGS[client]["ps"], got_srv.endpoint, 9)
        want = _drive(j_ps, ref_srv.endpoint, 9)
    finally:
        got_srv.stop()
        ref_srv.stop()
    for k in ("pull", "emb", "w"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["digests"] == want["digests"]


def _durable_session(ps, snap, crash):
    srv = ps.ParameterServer(optimizer="adagrad", lr=0.5, snapshot_dir=snap,
                             snapshot_every_ops=3).start()
    c = ps.KVClient(srv.endpoint)
    rng = np.random.RandomState(0)
    c.create("t", rng.rand(16, 4).astype("f4"))
    for _ in range(8):  # crosses snapshot boundaries; the journal tail replays
        c.push("t", rng.randint(0, 16, 5).astype(np.int64), rng.rand(5, 4).astype("f4"))
    # the same client sequence once more: deduped, and the dedup map recovers
    c._call(b"S", "t", np.array([1], np.int64), np.ones((1, 4), "f4"),
            seq_prefix=struct.pack("<QQ", c.client_id, 3))
    state = (c.table_digest("t"), srv.op_count, dict(srv.applied))
    c.close()
    if crash:  # no stop()-time snapshot: recovery comes from snap + journal
        srv._srv.shutdown()
        srv._srv.server_close()
    else:
        srv.stop()
    return state


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("crash", [True, False], ids=["crashed", "stopped"])
def test_a_snapshot_and_journal_dir_recovers_across_packages(tmp_path, writer, reader, crash):
    snap = str(tmp_path / "ps")
    digest, op_count, applied = _durable_session(PKGS[writer]["ps"], snap, crash)
    srv = PKGS[reader]["ps"].ParameterServer(optimizer="adagrad", lr=0.5, snapshot_dir=snap,
                                             snapshot_every_ops=3).start()
    try:
        assert srv.table_digest("t") == digest
        assert srv.op_count == op_count and srv.applied == applied
    finally:
        srv.stop()


def test_journal_records_are_the_jax_packages_bytes(tmp_path):
    for name, io in (("jax", jfluid.io), ("torch", tfluid.io)):
        for rec in (b"C\x00\x01", b"", b"S" * 300):
            io.append_record(str(tmp_path / f"{name}.log"), rec)
    raw = (tmp_path / "jax.log").read_bytes()
    assert raw == (tmp_path / "torch.log").read_bytes()
    with open(tmp_path / "torch.log", "ab") as f:  # a torn tail: dropped
        f.write(struct.pack("<I", 99) + b"partial")
    assert list(tfluid.io.read_journal(str(tmp_path / "torch.log"))) == \
        list(jfluid.io.read_journal(str(tmp_path / "jax.log"))) == [b"C\x00\x01", b"", b"S" * 300]


# --- exactly-once, stale sequences, the frame cap (tests/test_online_learning.py)

@BOTH
def test_resent_push_applied_exactly_once(pkg):
    ps, mon = PKGS[pkg]["ps"], PKGS[pkg]["monitor"]
    mon.enable()
    srv = ps.ParameterServer(optimizer="sgd", lr=1.0).start()
    try:
        c = ps.KVClient(srv.endpoint)
        c.create("t", np.zeros((4, 2), "f4"))
        ids, grads = np.array([1, 2], np.int64), np.ones((2, 2), "f4")
        c.push("t", ids, grads)  # seq 1
        c._call(b"S", "t", ids, grads, seq_prefix=struct.pack("<QQ", c.client_id, 1))
        exp = np.zeros((4, 2), "f4")
        exp[[1, 2]] -= 1.0  # ONE application
        np.testing.assert_array_equal(c.fetch_table("t"), exp)
        assert mon.counter("ps.push_dedup").value == 1
        c.close()
    finally:
        srv.stop()
        mon.disable()
        mon.reset()


@BOTH
def test_stale_sequence_push_ignored_fresh_applied(pkg):
    ps = PKGS[pkg]["ps"]
    srv = ps.ParameterServer(optimizer="sgd", lr=1.0).start()
    try:
        c = ps.KVClient(srv.endpoint)
        c.create("t", np.zeros((3, 1), "f4"))
        c.push("t", np.array([0], np.int64), np.ones((1, 1), "f4"))
        c.push("t", np.array([1], np.int64), np.ones((1, 1), "f4"))
        c._call(b"S", "t", np.array([2], np.int64), np.ones((1, 1), "f4"),
                seq_prefix=struct.pack("<QQ", c.client_id, 1))  # stale: dropped
        c2 = ps.KVClient(srv.endpoint)  # a new client is a new stream
        c2.push("t", np.array([2], np.int64), np.ones((1, 1), "f4"))
        np.testing.assert_array_equal(c.fetch_table("t"), [[-1.0], [-1.0], [-1.0]])
        c.close()
        c2.close()
    finally:
        srv.stop()


@BOTH
def test_frame_cap_rejects_oversized_terminal(pkg):
    fluid, ps, mon = PKGS[pkg]["fluid"], PKGS[pkg]["ps"], PKGS[pkg]["monitor"]
    mon.enable()
    fluid.set_flags({"FLAGS_ps_max_frame_mb": 1})
    srv = ps.ParameterServer().start()
    try:
        c = ps.KVClient(srv.endpoint, retries=3)
        with pytest.raises(fluid.errors.ParamServerError) as ei:
            c.create("big", np.zeros((1024, 512), "f4"))  # a 2 MB frame
        assert not ei.value.transient and ei.value.op == "create"
        assert mon.counter("ps.retries").value == 0  # terminal: no retry storm
        c.close()
    finally:
        fluid.set_flags({"FLAGS_ps_max_frame_mb": 256})
        srv.stop()
        mon.disable()
        mon.reset()


def test_a_corrupt_length_prefix_is_refused_by_the_ports_server():
    """A frame header past the cap, from a raw socket: the server answers
    with an error frame and drops the connection, counting the reject."""
    import socket

    t_monitor.enable()
    srv = t_ps.ParameterServer().start()
    try:
        host, port = srv.endpoint.rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=5) as s:
            s.sendall(b"PTPS" + b"P" + struct.pack("<Q", 1 << 40))
            op, payload = j_ps._recv_msg(s)
        assert op == b"e" and b"exceeds the FLAGS_ps_max_frame_mb cap" in payload
        assert t_monitor.counter("ps.frame_rejects").value == 1
    finally:
        srv.stop()
        t_monitor.disable()
        t_monitor.reset()


@pytest.mark.parametrize("exc,transient", [
    (ConnectionRefusedError(111, "refused"), True), (ConnectionResetError(104, "reset"), True),
    (TimeoutError("timed out"), True), (OSError(5, "EIO"), False)])
def test_classify_maps_the_pserver_seam_as_the_jax_package(exc, transient):
    got = []
    for fluid in (jfluid, tfluid):
        e = type(exc)(*exc.args)
        fluid.errors.attach_context(e, phase="pserver")
        c = fluid.errors.classify(e)
        got.append((type(c).__name__, c.transient, c.errno, c.phase))
    assert got[0] == got[1] == ("ParamServerError", transient, exc.errno, "pserver")


# --- host-tier training against the in-program sparse run ----------------------

V, D, F = 40, 4, 3


def _host_table_runs(fluid, ps):
    """tests/test_param_server.py's contract: the table on the HOST (pull,
    device step on the pulled rows as a feed, push the rows' gradient)
    against the fully in-program `is_sparse` run.  Returns both runs'
    losses and tables."""
    layers = fluid.layers
    rng = np.random.RandomState(0)
    table0 = rng.rand(V, D).astype("f4") * 0.2
    ids_stream = [rng.randint(0, V, size=(8, F)) for _ in range(6)]
    lbl_stream = [rng.rand(8, 1).astype("f4") for _ in range(6)]
    fc_w0 = rng.rand(F * D, 1).astype("f4") * 0.1

    def build(host):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            ids = layers.data("ids", [F], dtype="int64")
            label = layers.data("label", [1], dtype="float32")
            if host:
                rows = layers.data("rows", [D], dtype="float32")
                emb = layers.reshape(layers.gather(rows, layers.reshape(ids, [-1])),
                                     [-1, F * D])
            else:
                emb = layers.reshape(layers.embedding(
                    ids, size=[V, D], is_sparse=True,
                    param_attr=fluid.ParamAttr(name="ps_tbl")), [-1, F * D])
            pred = layers.fc(emb, 1, param_attr=fluid.ParamAttr(name="ps_fc"),
                             bias_attr=False)
            loss = layers.mean(layers.square_error_cost(pred, label))
            if host:
                (grad,) = fluid.calc_gradient(loss, [rows])
                fluid.optimizer.SGD(0.3).minimize(loss, parameter_list=["ps_fc"])
                return main, startup, loss, grad
            fluid.optimizer.SGD(0.3).minimize(loss)
            return main, startup, loss, None

    exe = fluid.Executor(fluid.CPUPlace())
    main, startup, loss, _ = build(False)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    scope.set_var("ps_tbl", table0.copy())
    scope.set_var("ps_fc", fc_w0.copy())
    ref_losses = []
    for ids, lbl in zip(ids_stream, lbl_stream):
        (lv,) = exe.run(main, feed={"ids": ids, "label": lbl}, fetch_list=[loss], scope=scope)
        ref_losses.append(float(np.asarray(lv).reshape(-1)[0]))
    ref_table = np.array(np.asarray(scope.find_var("ps_tbl")))

    srv = ps.ParameterServer(optimizer="sgd", lr=0.3).start()
    try:
        client = ps.KVClient(srv.endpoint)
        client.create("ps_tbl", table0.copy())
        hte = ps.HostTableEmbedding(client, "ps_tbl", D)
        main, startup, loss, rows_grad = build(True)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        scope.set_var("ps_fc", fc_w0.copy())
        losses = []
        for ids, lbl in zip(ids_stream, lbl_stream):
            uniq, local, rows = hte.prepare_batch(ids)
            lv, gv = exe.run(main, feed={"rows": rows, "ids": local, "label": lbl},
                             fetch_list=[loss, rows_grad], scope=scope)
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
            hte.push_grad(uniq, np.asarray(gv))
        table = client.fetch_table("ps_tbl")
        client.close()
    finally:
        srv.stop()
    return dict(ref_losses=ref_losses, ref_table=ref_table, losses=losses, table=table)


def test_host_table_training_matches_in_hbm_and_the_jax_package():
    got = _host_table_runs(tfluid, t_ps)
    np.testing.assert_allclose(got["losses"], got["ref_losses"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["table"], got["ref_table"], rtol=1e-4, atol=1e-5)
    want = _host_table_runs(jfluid, j_ps)
    for k in ("losses", "ref_losses"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    for k in ("table", "ref_table"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)

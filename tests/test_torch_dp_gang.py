"""Data parallelism and the training gang (ROADMAP A10.1) against the JAX
package on the CPU.

The port's ranks are processes over gloo.  One gang of two ranks, started
as a user starts one (`python -m paddle_tpu_torch.launch --nproc 2`), runs
this file as its worker script: each rank reads the cases the parent
built with the JAX package (programs by `Program.to_dict`, the JAX
package's persistables after its startup, the global batches), trains on
its own shard of each batch through `CompiledProgram.with_data_parallel`,
`with_grad_overlap` (serial and bucketed), the transpiler's trainer
program and `dygraph.DataParallel`, and writes what it fetched and its
state.  The parent holds that against the JAX package on the global batch:
GSPMD (`with_mesh` on two CPU devices) for plain data parallelism, its
manual per-shard region for `with_grad_overlap`.  The gang's own
mechanics (restarts, the rendezvous deadline, the backend rule) and the
world-size-1 path run here without a gang.
"""
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT_S = 240
STEPS = 3


# --------------------------------------------------------------------------
# the cases: built by the parent with the JAX package, run by each rank
# --------------------------------------------------------------------------

def _mlp_momentum(fluid):
    """tests/dist_worker.py's model."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 90
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [32], dtype="float32")
        y = fluid.layers.data("y", [1], dtype="int64")
        h = fluid.layers.fc(x, 64, act="relu")
        logits = fluid.layers.fc(h, 10)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.Momentum(0.05, 0.9).minimize(loss)
    return main, startup, [loss.name, logits.name]


def _mlp_adam(fluid):
    """tests/test_grad_overlap.py's _mlp."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = main.random_seed = 11
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16], dtype="float32")
        y = fluid.layers.data("y", [1], dtype="float32")
        h = fluid.layers.fc(x, 32, act="relu")
        loss = fluid.layers.mean(fluid.layers.square_error_cost(fluid.layers.fc(h, 1), y))
        fluid.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, [loss.name]


def _conv_bn(fluid):
    """tests/test_grad_overlap.py's batch-norm net."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = main.random_seed = 13
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", [3, 8, 8], dtype="float32")
        y = fluid.layers.data("y", [1], dtype="float32")
        c = fluid.layers.batch_norm(fluid.layers.conv2d(img, 4, 3, padding=1))
        loss = fluid.layers.mean(fluid.layers.square_error_cost(fluid.layers.fc(c, 1), y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, [loss.name]


def _auc_net(fluid):
    """tests/test_grad_overlap.py's auc net."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = main.random_seed = 17
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16], dtype="float32")
        y = fluid.layers.data("y", [1], dtype="float32")
        yl = fluid.layers.data("yl", [1], dtype="int64")
        pred = fluid.layers.sigmoid(fluid.layers.fc(x, 1))
        fluid.layers.auc(pred, yl, num_thresholds=255)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, [loss.name]


def _sparse_net(fluid):
    """tests/test_grad_overlap.py's is_sparse embedding net."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = main.random_seed = 13
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", [4], dtype="int64")
        y = fluid.layers.data("y", [1], dtype="float32")
        emb = fluid.layers.embedding(ids, size=(50, 8), is_sparse=True)
        h = fluid.layers.reduce_mean(emb, dim=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(fluid.layers.fc(h, 1), y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, [loss.name]


def _batch_sum_net(fluid):
    """A loss summed over the batch: its global value is not the mean of
    the ranks' values, so plain data parallelism across a gang refuses it."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 5
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16], dtype="float32")
        y = fluid.layers.data("y", [1], dtype="float32")
        loss = fluid.layers.reduce_sum(fluid.layers.square_error_cost(fluid.layers.fc(x, 1), y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, [loss.name]


def _batches(kind, steps=STEPS):
    rng = np.random.RandomState({"momentum": 1234, "adam": 0, "bn": 0, "auc": 0,
                                 "sparse": 0, "sum": 3}[kind])
    out = []
    for _ in range(steps):
        if kind == "momentum":
            out.append({"x": rng.rand(32, 32).astype("f4"),
                        "y": rng.randint(0, 10, size=(32, 1)).astype("int64")})
        elif kind in ("adam", "sum"):
            out.append({"x": rng.rand(8, 16).astype("f4"), "y": rng.rand(8, 1).astype("f4")})
        elif kind == "bn":
            out.append({"img": rng.rand(16, 3, 8, 8).astype("f4"),
                        "y": rng.rand(16, 1).astype("f4")})
        elif kind == "auc":
            out.append({"x": rng.rand(16, 16).astype("f4"), "y": rng.rand(16, 1).astype("f4"),
                        "yl": (rng.rand(16, 1) > 0.5).astype("i8")})
        else:
            out.append({"ids": rng.randint(0, 50, (8, 4)).astype("i8"),
                        "y": rng.rand(8, 1).astype("f4")})
    return out


# name: (builder, batches kind, the port's arms)
STATIC_CASES = {
    "momentum": (_mlp_momentum, "momentum", ("plain", "transpiler")),
    "adam": (_mlp_adam, "adam", ("plain", "serial", "bucketed", "serial_k3", "bucketed_k3")),
    "bn": (_conv_bn, "bn", ("plain", "serial", "bucketed")),
    "auc": (_auc_net, "auc", ("plain", "serial", "bucketed")),
    "sparse": (_sparse_net, "sparse", ("plain", "bucketed")),
}
# a port arm's JAX counterpart (None: GSPMD)
JAX_ARM = {"plain": None, "transpiler": None, "serial": "serial", "bucketed": "bucketed",
           "serial_k3": "serial", "bucketed_k3": "bucketed"}

DYGRAPH_BATCH = 16


def _dygraph_batches():
    rng = np.random.RandomState(7)
    return [(rng.rand(DYGRAPH_BATCH, 16).astype("f4"),
             rng.randint(0, 4, (DYGRAPH_BATCH, 1)).astype("int64")) for _ in range(STEPS)]


def _dygraph_net(fluid):
    dy = fluid.dygraph

    class Net(dy.Layer):
        def __init__(self):
            super().__init__("net")
            self.fc1 = dy.Linear(16, 32, act="relu")
            self.fc2 = dy.Linear(32, 4)

        def forward(self, x):
            return self.fc2(self.fc1(x))

    return Net()


def _dygraph_steps(fluid, net, batches, model=None):
    """STEPS Adam steps of `net` (through `model`, a DataParallel, when
    given) on `batches`; returns the losses."""
    dy = fluid.dygraph
    model = model or net
    opt = fluid.optimizer.Adam(0.01)
    losses = []
    for xv, yv in batches:
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            model(dy.to_variable(xv)), dy.to_variable(yv)))
        if model is not net:
            loss = model.scale_loss(loss)
        loss.backward()
        if model is not net:
            model.apply_collective_grads()
        opt.minimize(loss, parameter_list=net.parameters())
        net.clear_gradients()
        losses.append(float(loss.numpy().reshape(-1)[0]))
    return losses


SYNC_SHAPES = {"g0": (8, 4), "g1": (16,), **{f"h{i}": (64,) for i in range(6)}}
SYNC_BUCKET_BYTES = {"serial": 64, "bucketed": 64 * 4 * 2}


def _sync_grads(world):
    """Each worker's gradients, from one seed: [[(name, array)] a worker]."""
    rng = np.random.RandomState(0)
    return [[(n, rng.randn(*s).astype("f4")) for n, s in SYNC_SHAPES.items()]
            for _ in range(world)]


# --------------------------------------------------------------------------
# the worker: one rank of the gang
# --------------------------------------------------------------------------

def _shard(feed, rank, world):
    out = {}
    for n, v in feed.items():
        per = v.shape[0] // world
        out[n] = v[rank * per:(rank + 1) * per]
    return out


def _rank_static(fluid, case, arm, rank, world, endpoints):
    main = fluid.Program.from_dict(case["main"])
    scope = fluid.Scope()
    # copies: a CPU tensor made from an array shares its memory, and auc
    # accumulates into its state in place
    fluid.io.load_numpy_params(scope, {n: v.copy() for n, v in case["state"].items()})
    exe = fluid.Executor(fluid.CPUPlace())
    if arm == "transpiler":
        t = fluid.DistributeTranspiler()
        t.transpile(rank, program=main, trainers=",".join(endpoints),
                    current_endpoint=endpoints[rank])
        compiled = t.get_trainer_program()
    else:
        compiled = fluid.CompiledProgram(main).with_data_parallel(loss_name=case["fetch"][0])
        mode = JAX_ARM[arm]
        if mode:
            compiled = compiled.with_grad_overlap(bucket_mb=0.001, mode=mode)
    shards = [_shard(f, rank, world) for f in case["batches"]]
    fetched = []
    if arm.endswith("_k3"):
        stacked = {n: np.stack([s[n] for s in shards]) for n in shards[0]}
        out = exe.run(compiled, feed=stacked, fetch_list=case["fetch"], scope=scope,
                      steps=len(shards))
        fetched = [[o[k] for o in out] for k in range(len(shards))]
    else:
        for feed in shards:
            fetched.append(exe.run(compiled, feed=feed, fetch_list=case["fetch"], scope=scope))
    plan = exe.last_plan
    state = {n: np.array(scope.to_numpy(n)) for n in case["state"]}
    return {"fetched": [[np.array(f) for f in step] for step in fetched], "state": state,
            "graph_refusal": plan.graph_refusal, "sync_mode": plan.grad_sync.mode,
            "sync_bytes": plan.grad_sync.last_bytes}


def _worker_main(d):
    t0 = time.perf_counter()
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import distributed as dist

    torch.set_num_threads(1)
    dist.init_distributed()
    rank, world = dist.trainer_id(), dist.num_trainers()
    endpoints = os.environ["PADDLE_TRAINER_ENDPOINTS"].split(",")
    with open(os.path.join(d, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    out = {"rank": rank, "world": world, "backend": dist.backend(),
           "start_s": time.perf_counter() - t0}
    for name, case in cases["static"].items():
        for arm in case["arms"]:
            with fluid.unique_name.guard():
                out[(name, arm)] = _rank_static(fluid, case, arm, rank, world, endpoints)
    # a batch-summed loss under plain data parallelism: refused, naming the op
    with fluid.unique_name.guard():
        main, startup, fetch = _batch_sum_net(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    try:
        exe.run(fluid.CompiledProgram(main).with_data_parallel(), feed=_shard(
            _batches("sum")[0], rank, world), fetch_list=fetch, scope=scope)
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    # make_grad_sync on this rank's gradients
    mine = _sync_grads(world)[rank]
    for mode in ("serial", "bucketed"):
        sync = dist.make_grad_sync("dp", SYNC_BUCKET_BYTES[mode], mode)
        got = sync([(n, torch.from_numpy(g.copy())) for n, g in mine])
        out[("sync", mode)] = {n: got[n].numpy() for n, _ in mine}
    # dygraph DataParallel: this rank's shard of each global batch
    dyg = cases["dygraph"]
    with fluid.dygraph.guard(fluid.CPUPlace()):
        net = _dygraph_net(fluid)
        net.set_dict(dyg["initial"])
        env = fluid.dygraph.parallel.prepare_context()
        model = fluid.dygraph.DataParallel(net)
        per = DYGRAPH_BATCH // world
        losses = _dygraph_steps(fluid, net, [(x[rank * per:(rank + 1) * per],
                                              y[rank * per:(rank + 1) * per])
                                             for x, y in dyg["batches"]], model)
        out["dygraph"] = {"losses": losses, "state": {k: np.array(v) for k, v in
                                                      net.state_dict().items()},
                          "nranks": env.nranks, "local_rank": env.local_rank}
    # install_check's data-parallel pass over the gang
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fluid.install_check.run_check(place=fluid.CPUPlace())
    out["install_check"] = buf.getvalue().strip().splitlines()
    out["seconds"] = time.perf_counter() - t0
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    print("GANG_RANK_DONE " + json.dumps({"rank": rank, "seconds": out["seconds"]}), flush=True)


# --------------------------------------------------------------------------
# the parent: the JAX side and the comparisons
# --------------------------------------------------------------------------

def _jax_mesh2():
    import jax

    from paddle_tpu.parallel import make_mesh

    return make_mesh((2,), ("dp",), jax.devices()[:2])


def _jax_case(name):
    import paddle_tpu as jfluid

    build, kind, arms = STATIC_CASES[name]
    with jfluid.unique_name.guard():
        main, startup, fetch = build(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    state = {v.name: np.array(scope.find_var(v.name)) for v in main.list_vars()
             if v.persistable and scope.find_var(v.name) is not None}
    return main, fetch, state, _batches(kind)


def _jax_run(main, fetch, state, batches, mode):
    import paddle_tpu as jfluid

    scope = jfluid.Scope()
    for n, v in state.items():
        scope.set_var(n, v)
    compiled = jfluid.CompiledProgram(main).with_mesh(_jax_mesh2())
    if mode:
        compiled = compiled.with_grad_overlap(bucket_mb=0.001, mode=mode)
    exe = jfluid.Executor(jfluid.CPUPlace())
    fetched = [[np.array(f) for f in exe.run(compiled, feed=b, fetch_list=fetch, scope=scope)]
               for b in batches]
    return {"fetched": fetched, "state": {n: np.array(scope.find_var(n)) for n in state}}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The JAX package's cases, one gang of two ranks started through the
    launcher's command line, and the JAX references computed while it runs."""
    import paddle_tpu as jfluid

    d = str(tmp_path_factory.mktemp("dp_gang"))
    jax_side, static, initial = {}, {}, {}
    for name, (_, _, arms) in STATIC_CASES.items():
        main, fetch, state, batches = _jax_case(name)
        jax_side[name] = (main, fetch, state, batches)
        initial[name] = state
        static[name] = {"main": main.to_dict(), "state": state, "batches": batches,
                        "fetch": fetch, "arms": arms}
    with jfluid.dygraph.guard():
        dy_initial = {k: np.array(v) for k, v in _dygraph_net(jfluid).state_dict().items()}
    with open(os.path.join(d, "cases.pkl"), "wb") as f:
        pickle.dump({"static": static, "dygraph": {"initial": dy_initial,
                                                   "batches": _dygraph_batches()}}, f)
    bn_stats = sorted(n for op in jax_side["bn"][0].global_block().ops if op.type == "batch_norm"
                      for slot in ("MeanOut", "VarianceOut") for n in op.output(slot))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.launch", "--nproc", "2", "--max-restarts", "0",
         "--timeout", str(GANG_TIMEOUT_S), os.path.abspath(__file__), d],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        refs = {}
        for name, (main, fetch, state, batches) in jax_side.items():
            for mode in sorted({JAX_ARM[a] for a in STATIC_CASES[name][2]}, key=str):
                refs[(name, mode)] = _jax_run(main, fetch, state, batches, mode)
        # the conv+BN net's sensitivity to the reduction order: the JAX
        # package's one-device run of the global batch against its 2-device one
        main, fetch, state, batches = jax_side["bn"]
        one = jfluid.Scope()
        for n, v in state.items():
            one.set_var(n, v)
        exe = jfluid.Executor(jfluid.CPUPlace())
        for b in batches:
            exe.run(main, feed=b, fetch_list=fetch, scope=one)
        spread = {n: float(np.abs(np.array(one.find_var(n)) - refs[("bn", None)]["state"][n]).max())
                  for n in state}
        # the auc net in one process of the port over the global batch
        import paddle_tpu_torch as tfluid

        main, fetch, state, batches = jax_side["auc"]
        tmain, tscope = tfluid.Program.from_dict(main.to_dict()), tfluid.Scope()
        tfluid.io.load_numpy_params(tscope, {n: v.copy() for n, v in state.items()})
        texe = tfluid.Executor(tfluid.CPUPlace())
        for b in batches:
            texe.run(tmain, feed=b, fetch_list=fetch, scope=tscope)
        auc_one = {n: tscope.to_numpy(n).copy() for n in state}
        with jfluid.dygraph.guard():
            net = _dygraph_net(jfluid)
            net.set_dict(dy_initial)
            dy_losses = _dygraph_steps(jfluid, net, _dygraph_batches())
            refs["dygraph"] = {"losses": dy_losses, "state": {
                k: np.array(v) for k, v in net.state_dict().items()}}
        out, err = proc.communicate(timeout=GANG_TIMEOUT_S + 30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, f"launcher exit {proc.returncode}:\n{out[-3000:]}\n{err[-5000:]}"
    ranks = []
    for r in range(2):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "refs": refs, "stdout": out, "stderr": err, "initial": initial,
            "bn_stats": bn_stats, "jax_spread": spread,
            "port_world1_auc": auc_one, "seconds": time.perf_counter() - t0}


def test_launch_trains_a_two_rank_gang_over_gloo(gang):
    """`python -m paddle_tpu_torch.launch --nproc 2 <script>`: both ranks of
    one gang over gloo on the CPU, each rank's output on the launcher's."""
    r0, r1 = gang["ranks"]
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["world"] == r1["world"] == 2 and r0["backend"] == r1["backend"] == "gloo"
    assert gang["stdout"].count("GANG_RANK_DONE") == 2
    assert "ok after 1 incarnation(s), 0 restart(s)" in gang["stderr"]


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("arm", ["plain", "transpiler"])
def test_momentum_mlp_gang_matches_the_jax_mesh(gang, arm):
    """tests/dist_worker.py's MLP under Momentum: the gang's losses within
    tests/test_dist_multiprocess.py's 2e-5 / 1e-6 of the JAX package's
    global-batch run, parameters within 1e-5, and the per-sample logits
    gathered in rank order equal to the global batch's."""
    ref = gang["refs"][("momentum", None)]
    for rank in gang["ranks"]:
        got = rank[("momentum", arm)]
        _close([s[0] for s in got["fetched"]], [s[0] for s in ref["fetched"]], 2e-5, 1e-6,
               "losses")
        for g, w in zip(got["fetched"], ref["fetched"]):
            assert g[1].shape == w[1].shape == (32, 10)
            _close(g[1], w[1], 1e-5, 1e-5, "logits")
        for n, w in ref["state"].items():
            _close(got["state"][n], w, 0, 1e-5, n)
        assert got["sync_mode"] == "serial" and got["sync_bytes"] == 4 * (32 * 64 + 64 + 64 * 10
                                                                          + 10)
    a, b = (r[("momentum", arm)] for r in gang["ranks"])
    for n in a["state"]:
        np.testing.assert_array_equal(a["state"][n], b["state"][n], err_msg=n)


def test_adam_mlp_serial_and_bucketed_are_bitwise_and_match_jax(gang):
    """tests/test_grad_overlap.py's MLP under Adam in the three modes: the
    port's serial and bucketed arms (single steps, and steps=3) agree bit
    for bit, and every arm is within 1e-5 of its JAX arm."""
    for rank in gang["ranks"]:
        s, b = rank[("adam", "serial")], rank[("adam", "bucketed")]
        for arm in ("bucketed", "serial_k3", "bucketed_k3"):
            other = rank[("adam", arm)]
            for x, y in zip(s["fetched"], other["fetched"]):
                np.testing.assert_array_equal(np.asarray(x[0]).reshape(-1),
                                              np.asarray(y[0]).reshape(-1), err_msg=arm)
            for n in s["state"]:
                np.testing.assert_array_equal(s["state"][n], other["state"][n], err_msg=n)
        assert b["graph_refusal"] is None  # the CPU captures nothing
        for arm in ("plain", "serial", "bucketed"):
            got, ref = rank[("adam", arm)], gang["refs"][("adam", JAX_ARM[arm])]
            _close([f[0] for f in got["fetched"]], [f[0] for f in ref["fetched"]], 1e-5, 1e-6, arm)
            for n, w in ref["state"].items():
                _close(got["state"][n], w, 1e-5, 1e-6, f"{arm} {n}")


def test_conv_bn_global_and_per_shard_statistics_match_jax(gang):
    """Plain data parallelism normalizes with the global batch's statistics
    (JAX GSPMD); with_grad_overlap normalizes per shard and rank-means the
    running statistics (test_overlap_syncs_bn_running_stats): the running
    statistics within 1e-5 of max(1, |JAX|), the same on both ranks, and
    moved.  A conv under a batch norm is ill-conditioned in its weights:
    the JAX package's own one-device run of the global batch parts from its
    2-device run by ~6e-5 in the conv weights, so each parameter is held to
    the larger of the same rule and twice that spread of the JAX package's
    own (`jax_spread`)."""
    initial, stats, spread = gang["initial"]["bn"], gang["bn_stats"], gang["jax_spread"]
    assert len(stats) == 2
    for arm in ("plain", "serial", "bucketed"):
        ref = gang["refs"][("bn", JAX_ARM[arm])]
        a, b = (r[("bn", arm)] for r in gang["ranks"])
        for n, w in ref["state"].items():
            tol = 1e-5 * max(1.0, float(np.abs(w).max()))
            if n not in stats:
                tol = max(tol, 2 * spread[n])
            _close(a["state"][n], w, 0, tol, f"{arm} {n}")
            np.testing.assert_array_equal(a["state"][n], b["state"][n], err_msg=n)
        _close([f[0] for f in a["fetched"]], [f[0] for f in ref["fetched"]], 1e-5, 1e-6, arm)
        assert all(not np.array_equal(a["state"][n], initial[n]) for n in stats), arm
    # global and per-shard statistics differ: the two semantics are told apart
    plain, overlap = (gang["ranks"][0][("bn", arm)]["state"] for arm in ("plain", "serial"))
    assert any(not np.allclose(plain[n], overlap[n], rtol=0, atol=1e-4) for n in stats)


def test_auc_accumulators_take_every_ranks_samples(gang):
    """auc's histograms are additive accumulators: base plus every rank's
    delta.  In all three arms every sample of the 3 steps x 16 is counted
    exactly once (a base counted by each rank would count the earlier
    steps twice), and the histograms equal the port's own one-process run
    of the global batch and the JAX package's up to a sample moved to a
    neighbouring bin: a prediction within float rounding of a bin edge may
    land on either side (the product's rounding depends on the rows a
    process holds)."""
    one = gang["port_world1_auc"]
    stats = sorted(n for n in one if ".stat_" in n)
    assert len(stats) == 2 and sum(int(one[n].sum()) for n in stats) == STEPS * 16
    for arm in ("plain", "serial", "bucketed"):
        ref = gang["refs"][("auc", JAX_ARM[arm])]
        for rank in gang["ranks"]:
            got = rank[("auc", arm)]["state"]
            np.testing.assert_array_equal(got[stats[0]], gang["ranks"][0][("auc", arm)]["state"][
                stats[0]])
            assert sum(int(got[n].sum()) for n in stats) == STEPS * 16
            for n in stats:
                for want in (one[n], ref["state"][n]):
                    assert got[n].sum() == want.sum(), (arm, n)
                    assert np.abs(np.cumsum(got[n]) - np.cumsum(want)).max() <= 1, (arm, n)
                    assert np.abs(got[n] - want).sum() <= 4, (arm, n)


def test_sparse_gradients_are_gathered_as_rows(gang):
    """is_sparse gradients ride the all-gather of rows plus values
    (test_overlap_sparse_grads_match_gspmd): losses and the table track the
    JAX package's GSPMD arm."""
    ref = gang["refs"][("sparse", None)]
    for rank in gang["ranks"]:
        for arm in ("plain", "bucketed"):
            got = rank[("sparse", arm)]
            _close([f[0] for f in got["fetched"]], [f[0] for f in ref["fetched"]], 1e-5, 1e-6,
                   arm)
            for n, w in ref["state"].items():
                _close(got["state"][n], w, 1e-5, 1e-7, f"{arm} {n}")


def test_a_batch_reduction_is_refused_under_plain_data_parallelism(gang):
    for rank in gang["ranks"]:
        assert rank["refusal"] and "'reduce_sum'" in rank["refusal"]
        assert "reduces the batch axis" in rank["refusal"]


@pytest.mark.parametrize("mode", ["serial", "bucketed"])
def test_grad_sync_matches_the_jax_function_on_two_devices(gang, mode):
    """make_grad_sync at two ranks against the JAX package's on a 2-device
    mesh (tests/test_grad_overlap.py's harness): every rank holds the mean,
    and the two modes agree bit for bit."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.core.jax_compat import shard_map
    from paddle_tpu.parallel.distributed import make_grad_sync

    grads = _sync_grads(2)
    names = list(SYNC_SHAPES)
    sync = make_grad_sync("dp", SYNC_BUCKET_BYTES[mode], mode=mode)

    def worker(*stacked):
        out = sync([(n, g[0]) for n, g in zip(names, stacked)])
        return tuple(out[n][None] for n in names)

    args = [jnp.stack([dict(g)[n] for g in grads]) for n in names]
    f = shard_map(worker, mesh=_jax_mesh2(), in_specs=tuple(P("dp") for _ in names),
                  out_specs=tuple(P("dp") for _ in names))
    want = dict(zip(names, f(*args)))
    for r, rank in enumerate(gang["ranks"]):
        got = rank[("sync", mode)]
        for n in names:
            np.testing.assert_allclose(got[n], np.asarray(want[n][r]), rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(got[n], rank[("sync", "serial")][n])
            np.testing.assert_array_equal(got[n], gang["ranks"][0][("sync", mode)][n])


def test_dygraph_data_parallel_matches_the_jax_global_batch(gang):
    """dygraph.DataParallel over the gang: each rank's Adam steps on its
    shard, gradients mean-reduced by apply_collective_grads, against the
    JAX package's eager steps on the global batch."""
    ref = gang["refs"]["dygraph"]
    for rank in gang["ranks"]:
        got = rank["dygraph"]
        assert (got["nranks"], got["local_rank"]) == (2, rank["rank"])
        local = np.asarray(got["losses"])
        other = np.asarray(gang["ranks"][1 - rank["rank"]]["dygraph"]["losses"])
        _close((local + other) / 2, ref["losses"], 1e-5, 1e-6, "losses")
        for n, w in ref["state"].items():
            _close(got["state"][n], w, 1e-5, 1e-6, n)


def test_install_check_runs_its_pass_over_the_gang(gang):
    for rank in gang["ranks"]:
        assert rank["install_check"] == [
            "Your paddle_tpu_torch works well on 2 devices (data parallel over a gang of 2 "
            "ranks, gloo).", "install check passed."]


# --------------------------------------------------------------------------
# the gang's mechanics, world size 1, and the API, without a gang
# --------------------------------------------------------------------------

_EXIT_SCRIPT = """
import os, sys
print("incarnation", os.environ["PADDLE_RESTART_NUM"], os.environ["PADDLE_TRAINER_ID"],
      os.environ["PADDLE_TRAINER_ENDPOINTS"], os.environ.get("PADDLE_CHECKPOINT_ROOT"))
sys.exit(3 if os.environ["PADDLE_TRAINER_ID"] == "1" else 0)
"""


def test_a_failing_rank_restarts_the_gang_until_max_restarts(tmp_path):
    """Rank 1 always exits 3: the gang relaunches once (max_restarts=1) on a
    fresh port block with PADDLE_RESTART_NUM bumped, the checkpoint root's
    uncommitted debris cleared, then gives up with ok=False and each rank's
    (returncode, stdout, stderr)."""
    from paddle_tpu_torch import launch

    script = tmp_path / "worker.py"
    script.write_text(_EXIT_SCRIPT)
    root = tmp_path / "ckpt"
    (root / "ckpt-7.tmp").mkdir(parents=True)
    (root / "ckpt-5").mkdir()
    res = launch.run_gang([sys.executable, str(script)], 2, max_restarts=1,
                          checkpoint_root=str(root), timeout=60, grace_s=1.0,
                          peer_grace_s=2.0, log=False)
    assert not res.ok and res.restarts == 1 and res.incarnations == 2
    assert res.size_history == [2, 2] and len(res.history) == 2 and res.workers is res.history[-1]
    assert [w[0] for w in res.workers] == [0, 3]
    lines = [h[r][1].split() for h in res.history for r in range(2)]
    assert [ln[1] for ln in lines] == ["0", "0", "1", "1"]
    assert [ln[2] for ln in lines] == ["0", "1", "0", "1"]
    assert lines[0][3] == lines[1][3] != lines[2][3] == lines[3][3]  # a fresh port block
    assert {ln[4] for ln in lines} == {str(root)}
    assert not (root / "ckpt-7.tmp").exists() and (root / "ckpt-5").exists()
    assert [i["dead"][0]["rank"] for i in res.incidents] == [1, 1]
    for what in ({"elastic": True}, {"heartbeat_dir": str(tmp_path)},
                 {"telemetry_root": str(tmp_path)}, {"capacity_fn": lambda: 2}):
        with pytest.raises(NotImplementedError, match="ROADMAP A10.2"):
            launch.run_gang([sys.executable, str(script)], 2, **what)


def test_a_rendezvous_that_never_completes_raises_within_its_deadline():
    """Rank 1 of a gang whose rank 0 never comes up: CollectiveTimeoutError
    at FLAGS_dist_bootstrap_timeout_s, and no gang left initialized."""
    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch.errors import CollectiveTimeoutError, DistributedError
    from paddle_tpu_torch.launch import allocate_port_block
    from paddle_tpu_torch.parallel import distributed as dist

    base = allocate_port_block(2)
    eps = [f"127.0.0.1:{base}", f"127.0.0.1:{base + 1}"]
    tfluid.set_flags({"FLAGS_dist_bootstrap_timeout_s": 1.5})
    try:
        t0 = time.monotonic()
        with pytest.raises(CollectiveTimeoutError, match="FLAGS_dist_bootstrap_timeout_s") as e:
            dist.init_distributed(1, eps, eps[1])
        took = time.monotonic() - t0
    finally:
        tfluid.set_flags({"FLAGS_dist_bootstrap_timeout_s": 120.0})
    assert 1.5 <= took < 3.0, took
    assert isinstance(e.value, DistributedError) and e.value.rank == 1
    assert not dist.is_initialized() and dist.num_trainers() == 1


@pytest.mark.parametrize("world,cards,want", [(2, 0, "gloo"), (2, 1, "gloo"), (2, 2, "nccl"),
                                              (4, 2, "gloo"), (2, 8, "nccl"), (1, 1, "nccl")])
def test_backend_rule(world, cards, want):
    """NCCL when every rank has a card of its own, gloo when ranks share a
    card or there is none; rank r takes card r % cards."""
    from paddle_tpu_torch.parallel import distributed as dist

    assert dist.backend_for(world, cards) == want
    assert [dist.card_for(r, cards) for r in range(world)] == (
        [r % cards for r in range(world)] if cards else [None] * world)


DIST_FLAGS = ["FLAGS_dist_heartbeat_interval_s", "FLAGS_dist_heartbeat_miss_factor",
              "FLAGS_dist_straggler_lag_steps", "FLAGS_dist_watchdog_timeout_s",
              "FLAGS_dist_bootstrap_timeout_s", "FLAGS_dp_bucket_mb"]


@pytest.mark.parametrize("name", DIST_FLAGS)
def test_dist_flags_have_the_jax_packages_defaults(name):
    from paddle_tpu import flags as jflags

    from paddle_tpu_torch import flags as tflags

    assert name in tflags.all_flags()
    assert tflags.flag(name) == jflags.flag(name)
    assert type(tflags.flag(name)) is type(jflags.flag(name))


PLAN_CASES = [
    ([("a", 3), ("b", 3), ("c", 3), ("d", 3)], 6),
    ([("a", 3), ("b", 3), ("c", 3), ("d", 3)], 7),
    ([("a", 3), ("b", 3), ("c", 3), ("d", 3)], 100),
    ([("a", 3), ("b", 3), ("c", 3), ("d", 3)], 1),
    ([("big", 50), ("s1", 2), ("s2", 2)], 10),
    ([("s1", 2), ("big", 50), ("s2", 2)], 10),
    ([], 10),
]


@pytest.mark.parametrize("sizes,cap", PLAN_CASES)
def test_plan_buckets_matches_the_jax_function(sizes, cap):
    from paddle_tpu.parallel.distributed import plan_buckets as jplan

    from paddle_tpu_torch.parallel.distributed import plan_buckets as tplan

    assert tplan(sizes, cap) == jplan(sizes, cap)


def _signature_targets():
    return ["parallel.CompiledProgram.with_data_parallel", "parallel.CompiledProgram.with_mesh",
            "parallel.CompiledProgram.with_grad_overlap", "parallel.CompiledProgram.with_local_sgd",
            "CompiledProgram.with_data_parallel", "CompiledProgram.with_mesh",
            "CompiledProgram.with_grad_overlap", "CompiledProgram.with_local_sgd",
            "launch.run_gang", "launch.Gang", "launch.GangResult", "launch.main",
            "parallel.init_distributed", "parallel.make_mesh", "parallel.distributed.make_grad_sync",
            "parallel.distributed.plan_buckets", "parallel.distributed.global_mesh",
            "ParallelExecutor", "ParallelExecutor.run", "ExecutionStrategy",
            "dygraph.DataParallel", "dygraph.parallel.DataParallel", "dygraph.prepare_context",
            "core.analysis.check_program", "core.analysis.verify_program",
            "core.analysis.collective_signature", "core.analysis.lint_collective_order",
            "errors.DistributedError", "errors.PeerFailureError",
            "errors.CollectiveTimeoutError"]


@pytest.mark.parametrize("name", _signature_targets())
def test_signatures_match_the_jax_package(name):
    import inspect

    import paddle_tpu as jfluid

    import paddle_tpu_torch as tfluid

    def resolve(pkg):
        obj = pkg
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj

    assert inspect.signature(resolve(tfluid)) == inspect.signature(resolve(jfluid))


def _world1_build(fluid, seed=5):
    """tests/test_parallel.py's model."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16], dtype="float32")
        y = fluid.layers.data("y", [1], dtype="int64")
        h = fluid.layers.fc(x, size=32, act="relu")
        logits = fluid.layers.fc(h, size=4)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def test_world_one_matches_the_jax_eight_device_mesh():
    """At world size 1 the port's with_data_parallel (and both overlap
    modes) is the plain step, bit for bit, and within
    tests/test_parallel.py:58's 2e-4 / 2e-5 of the JAX package's
    with_data_parallel over its 8 virtual CPU devices, from the JAX
    package's initial state."""
    import jax

    import paddle_tpu as jfluid

    import paddle_tpu_torch as tfluid

    assert len(jax.devices()) == 8
    with jfluid.unique_name.guard():
        jmain, jstartup, jloss = _world1_build(jfluid)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstartup, scope=jscope)
    state = {v.name: np.array(jscope.find_var(v.name)) for v in jmain.list_vars()
             if v.persistable and jscope.find_var(v.name) is not None}
    compiled = jfluid.CompiledProgram(jmain).with_data_parallel(loss_name=jloss.name)
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.rand(32, 16).astype("f4"), "y": rng.randint(0, 4, (32, 1))}
             for _ in range(8)]
    ref = [float(np.asarray(jexe.run(compiled, feed=f, fetch_list=[jloss], scope=jscope)[0])
                 .reshape(-1)[0]) for f in feeds]
    tmain = tfluid.Program.from_dict(jmain.to_dict())
    runs = {}
    for arm in ("program", "plain", "serial", "bucketed"):
        prog = tmain
        if arm != "program":
            prog = tfluid.CompiledProgram(tmain).with_data_parallel(loss_name=jloss.name)
            if arm != "plain":
                prog = prog.with_grad_overlap(bucket_mb=0.001, mode=arm)
        scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
        tfluid.io.load_numpy_params(scope, state)
        losses = [exe.run(prog, feed=f, fetch_list=[jloss.name], scope=scope)[0] for f in feeds]
        runs[arm] = (np.concatenate(losses), {n: scope.to_numpy(n).copy() for n in state})
        assert exe.last_plan.gang is None and exe.last_plan.grad_sync is None
    for arm in ("plain", "serial", "bucketed"):
        np.testing.assert_array_equal(runs[arm][0], runs["program"][0])
        for n in state:
            np.testing.assert_array_equal(runs[arm][1][n], runs["program"][1][n], err_msg=n)
    np.testing.assert_allclose(runs["plain"][0], ref, rtol=2e-4, atol=2e-5)


ARG_CHECKS = ["non_scalar_fetch", "requires_mesh", "local_sgd_composition", "bad_mode",
              "bad_bucket", "bucket_default"]


@pytest.mark.parametrize("check", ARG_CHECKS)
def test_overlap_argument_checks_match_the_jax_package(check):
    """tests/test_grad_overlap.py:270-330 in both packages: the same
    errors, raised at the same call."""
    import paddle_tpu as jfluid

    import paddle_tpu_torch as tfluid

    seen = {}
    for pkg, fluid in (("jax", jfluid), ("torch", tfluid)):
        with fluid.unique_name.guard():
            main, startup, fetch = _mlp_adam(fluid)
            pred = [op for op in main.global_block().ops if op.type == "elementwise_add"][-1] \
                .output("Out")[0]
        scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        feed = {"x": np.random.RandomState(0).rand(32, 16).astype("f4"),
                "y": np.random.RandomState(1).rand(32, 1).astype("f4")}
        try:
            if check == "non_scalar_fetch":
                cp = (fluid.CompiledProgram(main).with_data_parallel(loss_name=fetch[0])
                      .with_grad_overlap(bucket_mb=1.0))
                exe.run(cp, feed=feed, fetch_list=[pred, fetch[0]], scope=scope)
            elif check == "requires_mesh":
                exe.run(fluid.CompiledProgram(main).with_grad_overlap(bucket_mb=1.0),
                        feed=feed, fetch_list=fetch, scope=scope)
            elif check == "local_sgd_composition":
                fluid.CompiledProgram(main).with_grad_overlap().with_local_sgd(2)
            elif check == "bad_mode":
                fluid.CompiledProgram(main).with_grad_overlap(mode="async")
            elif check == "bad_bucket":
                fluid.CompiledProgram(main).with_grad_overlap(bucket_mb=0.0)
            else:
                fluid.set_flags({"FLAGS_dp_bucket_mb": 7.5})
                try:
                    seen[pkg] = fluid.CompiledProgram(main).with_grad_overlap() \
                        .grad_overlap_bucket_mb
                finally:
                    fluid.set_flags({"FLAGS_dp_bucket_mb": 4.0})
                continue
            seen[pkg] = None
        except ValueError as e:
            # the JAX package names the fetch's per-shard shape, the port its
            # declared one: the message up to the shape is compared
            seen[pkg] = str(e).split(" has shape")[0]
    assert seen["torch"] == seen["jax"] and seen["torch"] is not None


def test_collective_signature_matches_over_the_zoo():
    """collective_signature in both packages over each package's tiny zoo
    (tools/donation_audit.py, tools/port_donation_audit.py) and this file's
    programs: empty for every data-parallel program (COLLECTIVE_OPS names
    only the model-parallel ops), the collective-order lint quiet with a
    sibling program."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from donation_audit import build_zoo as jzoo
    from paddle_tpu.core import analysis as janalysis
    from port_donation_audit import build_zoo as tzoo

    from paddle_tpu_torch.core import analysis as tanalysis

    jsigs = {z[0]: janalysis.collective_signature(z[1]) for z in jzoo(tiny=True)}
    tprogs = {z[0]: z[1] for z in tzoo(tiny=True)}
    assert set(tprogs) == set(jsigs) and len(tprogs) >= 5
    for name, main in tprogs.items():
        assert tanalysis.collective_signature(main) == jsigs[name] == [], name
        diags = tanalysis.check_program(main, level="full", sibling_programs=[main])
        assert not [d for d in diags if d.code == "collective_order"], name
    assert tanalysis.COLLECTIVE_OPS == janalysis.COLLECTIVE_OPS


if __name__ == "__main__":
    _worker_main(sys.argv[1])

"""The executor's depth on the CPU against the JAX package: the plan
cache's hits and misses, `steps > 1`, `run_async` / `FetchHandle`,
`pipeline.train_loop`, remat (`BuildStrategy.memory_optimize`), the NaN/Inf
guard's error class, and a `set_var` between two runs of a cached plan.

The models are the tiny zoo BERT (vocab 200, seq 16, d 32, 2 layers, 2
heads, d_ff 64, Adam lr 1e-3) and small fc nets; the port starts from the
JAX package's state (`io.load_numpy_params`).  Tolerances are chip_smoke
phase 7's: losses 1e-3; parameters 1e-5, save elements whose JAX gradient
is 0 to rounding (within 1e-6 of the model's largest at some step: Adam's
first step is +-lr there whatever the gradient's size), which keep
2*lr*steps + 1e-5; moments 1e-4 of the largest of their kind.  Where both
sides are the port on the CPU (K steps against K runs, async against sync,
remat against none), the runs agree bit for bit."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import errors as jerrors
from paddle_tpu import monitor as jmonitor
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.models import transformer as j_transformer
from paddle_tpu_torch import errors as terrors
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import lowering as tlowering
from paddle_tpu_torch.core.scope import RNG_STATE_VAR
from paddle_tpu_torch.models import transformer as t_transformer

LR = 1e-3
TINY_BERT = dict(vocab_size=200, seq_len=16, d_model=32, n_layers=2, n_heads=2, d_ff=64,
                 use_fused_attention=False, learning_rate=LR, with_optimizer=True)
LOSS_TOL, PARAM_TOL, MOMENT_RTOL, ZERO_GRAD = 1e-3, 1e-5, 1e-4, 1e-6
PKG = {"jax": (jfluid, j_unique), "torch": (tfluid, tfluid.unique_name)}


def _bert(pkg, dropout=0.0):
    fluid, unique = PKG[pkg]
    transformer = j_transformer if pkg == "jax" else t_transformer
    with unique.guard():
        main, startup, _, fetches = transformer.build_bert(dropout_prob=dropout, **TINY_BERT)
    main.random_seed = startup.random_seed = 0
    return main, startup, fetches["loss"].name


def _batches(n, batch=2, seed=1):
    rng = np.random.RandomState(seed)
    return [dict(t_transformer.make_fake_batch(batch, 16, 200, rng=rng)) for _ in range(n)]


def _jax_start(main, startup):
    """The JAX package's executor and scope after its startup, and the whole
    persistable state as numpy."""
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(startup, scope=scope)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    return exe, scope, {n: np.asarray(scope.find_var(n)) for n in names}


def _port_start(state, graphs=True):
    scope = tfluid.Scope()
    tfluid.io.load_numpy_params(scope, state)
    return tfluid.Executor(tfluid.CPUPlace(), _graphs=graphs), scope


def _fc_program(pkg, dropout=0.0, optimizer="adam", seed=11):
    """x[4] -> fc 8 relu -> (dropout) -> fc 1, mean squared error."""
    fluid, unique = PKG[pkg]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with unique.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4], dtype="float32")
        y = fluid.layers.data("y", [1], dtype="float32")
        h = fluid.layers.fc(x, 8, act="relu")
        if dropout:
            h = fluid.layers.dropout(h, dropout_prob=dropout)
        d = fluid.layers.fc(h, 1) - y
        loss = fluid.layers.mean(d * d)
        opt = (fluid.optimizer.Adam(1e-2) if optimizer == "adam"
               else fluid.optimizer.Momentum(0.05, 0.9))
        opt.minimize(loss)
    return main, startup, loss.name


def _fc_feeds(n, batch=8):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        xv = rng.rand(batch, 4).astype("f4")
        out.append({"x": xv, "y": xv.sum(1, keepdims=True)})
    return out


def _hold_state(tscope, jscope, state, jgrads, names, steps):
    """The port's persistables against the JAX package's (module docstring)."""
    params = set(jgrads[0])
    peaks = [max(float(np.abs(g).max()) for g in step.values()) for step in jgrads]
    moment_peak = {}
    for n in names:
        for kind in ("moment1", "moment2"):
            if n.endswith(f"_{kind}_0"):
                moment_peak[kind] = max(moment_peak.get(kind, 0.0),
                                        float(np.abs(np.asarray(jscope.find_var(n))).max()))
    for n in names:
        want = np.asarray(jscope.find_var(n), np.float32)
        err = np.abs(tscope.to_numpy(n).astype(np.float32) - want)
        if n in params:
            near_zero = np.zeros(err.shape, bool)
            for step, peak in zip(jgrads, peaks):
                near_zero |= np.abs(step[n]) <= ZERO_GRAD * peak
            assert err.max() <= 2 * LR * steps + PARAM_TOL, n
            assert not (err[~near_zero] > PARAM_TOL).any(), n
        else:
            kind = next((k for k in moment_peak if n.endswith(f"_{k}_0")), None)
            tol = MOMENT_RTOL * (moment_peak[kind] if kind else max(float(np.abs(want).max()), 1.0))
            assert err.max() <= tol, n


# --------------------------------------------------------------------------
# the NaN/Inf guard
# --------------------------------------------------------------------------


def _scale_program(pkg):
    fluid, unique = PKG[pkg]
    main, startup = fluid.Program(), fluid.Program()
    with unique.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [2], dtype="float32")
        y = fluid.layers.scale(x, scale=2.0)
    return main, y.name


@pytest.fixture
def nan_guard():
    for fluid, _ in PKG.values():
        fluid.set_flags({"FLAGS_check_nan_inf": True})
    yield
    for fluid, _ in PKG.values():
        fluid.set_flags({"FLAGS_check_nan_inf": False})


def test_nan_guard_raises_the_jax_packages_error(nan_guard):
    """Both packages raise NumericError, a TrainingError and so a
    RuntimeError, with one message: from `run`, and from `run_async` only
    at resolution, stickily for every handle of the dispatch."""
    bad = {"x": np.array([[1.0, np.nan]], dtype="f4")}
    got = {}
    for pkg, (fluid, _) in PKG.items():
        main, y = _scale_program(pkg)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        with pytest.raises(RuntimeError) as sync_err:
            exe.run(main, feed=bad, fetch_list=[y], scope=scope)
        h1, h2 = exe.run_async(main, feed=bad, fetch_list=[y, y], scope=scope)  # no raise yet
        with pytest.raises(RuntimeError) as async_err:
            h1.numpy()
        with pytest.raises(RuntimeError) as again:
            np.asarray(h2)
        assert again.value is async_err.value
        (ok,) = exe.run(main, feed={"x": np.ones((1, 2), "f4")}, fetch_list=[y], scope=scope)
        np.testing.assert_allclose(ok, [[2.0, 2.0]])
        got[pkg] = (sync_err.value, async_err.value)
    for (je, te) in zip(got["jax"], got["torch"]):
        assert type(te).__name__ == type(je).__name__ == "NumericError"
        assert isinstance(te, terrors.TrainingError) and isinstance(te, RuntimeError)
        assert str(te) == str(je)


def test_classify_maps_the_cards_out_of_memory_error():
    e = terrors.classify(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert isinstance(e, terrors.TransientDeviceError) and e.resource_exhausted
    assert e.code == "RESOURCE_EXHAUSTED" and e.phase == "device"
    nan = terrors.classify(RuntimeError("fetch 'x' contains NaN/Inf"))
    assert isinstance(nan, terrors.NumericError)
    other = ValueError("no")
    assert terrors.classify(other) is other
    assert isinstance(terrors.classify(other, wrap_unknown=True), terrors.FatalError)


# --------------------------------------------------------------------------
# the plan cache
# --------------------------------------------------------------------------


@pytest.fixture
def monitors():
    for mon in (jmonitor, tmonitor):
        mon.reset()
        mon.enable()
    yield
    for mon in (jmonitor, tmonitor):
        mon.disable()
        mon.reset()


def _cache_counts(mon):
    return (mon.counter("executor.cache_hit").value, mon.counter("executor.cache_miss").value)


def test_plan_cache_hits_and_misses_match_jax(monitors):
    """One sequence of runs in both packages: the startup, the same feed
    shape again, a new batch size, a new fetch list, a program mutation
    (one more op), and a capacity of 6 that evicts the oldest plan."""
    counts = {}
    for pkg, (fluid, unique) in PKG.items():
        main, startup, loss = _fc_program(pkg)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        feeds = _fc_feeds(2) + _fc_feeds(1, batch=5)
        seq = []

        def run(**kw):
            exe.run(scope=scope, **kw)
            seq.append(_cache_counts(jmonitor if pkg == "jax" else tmonitor))

        run(program=startup)                                        # miss
        run(program=main, feed=feeds[0], fetch_list=[loss])         # miss
        run(program=main, feed=feeds[1], fetch_list=[loss])         # hit
        run(program=main, feed=feeds[2], fetch_list=[loss])         # miss: batch 5
        run(program=main, feed=feeds[0], fetch_list=[])             # miss: fetches
        run(program=main, feed=feeds[0], fetch_list=[loss])         # hit
        with unique.guard(), fluid.program_guard(main, startup):
            extra = fluid.layers.scale(main.global_block().var(loss), scale=2.0)
        run(program=main, feed=feeds[0], fetch_list=[loss])         # miss: version
        run(program=main, feed=feeds[0], fetch_list=[extra.name])   # miss: 6 plans
        fluid.set_flags({"FLAGS_executor_cache_capacity": 6})
        try:
            run(program=main, feed=feeds[2], fetch_list=[loss])     # miss, evicts startup
            run(program=startup)                                    # miss: evicted
            run(program=main, feed=feeds[2], fetch_list=[loss])     # hit
        finally:
            fluid.set_flags({"FLAGS_executor_cache_capacity": 128})
        counts[pkg] = seq
    assert counts["torch"] == counts["jax"]
    assert counts["torch"][-1] == (3, 8)


def test_step_records_spans_and_gauges_of_a_run_of_steps(monitors):
    """What the monitor holds for a run of steps (chip_smoke prints it for
    each such run on the card): one kind="step" record a run with its
    dispatch and fetch seconds and whether the plan was a hit, the
    executor.dispatch and executor.fetch spans once a run, executor.build
    once a miss, and memory gauges read lazily from the card's allocator
    (NaN without a card)."""
    fluid, _ = PKG["torch"]
    main, startup, loss = _fc_program("torch")
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    tmonitor.reset()
    for feed in _fc_feeds(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    records = [r for r in tmonitor.step_records() if r["kind"] == "step"]
    assert [r["cache_hit"] for r in records] == [False, True, True]
    assert [r["step"] for r in records] == [0, 1, 2]
    assert all(r["t_dispatch_s"] > 0 and r["t_fetch_s"] >= 0 and not r["graphed"]
               for r in records)
    spans = tmonitor.get_monitor().span_stats()
    assert spans["executor.dispatch"]["calls"] == spans["executor.fetch"]["calls"] == 3
    assert spans["executor.build"]["calls"] == 1
    assert tmonitor.counter("executor.steps").value == 3
    in_use = tmonitor.gauge("memory.device_bytes_in_use").read()
    assert np.isnan(in_use) if not torch.cuda.is_available() else in_use >= 0


def test_program_identity_and_version():
    main, startup, loss = _fc_program("torch")
    v = main.version
    with tfluid.program_guard(main, startup):
        tfluid.layers.scale(main.global_block().var(loss), scale=2.0)
    assert main.version > v
    clone = main.clone(for_test=True)
    assert clone._uuid != main._uuid
    v = main.version
    tfluid.passes.apply_pass(main, "fuse_bias_act")
    assert main.version > v
    assert tfluid.Scope()._uuid != tfluid.Scope()._uuid


def test_set_var_between_runs_of_a_cached_plan_is_seen():
    main, startup, loss = _fc_program("torch")
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = _fc_feeds(1)[0]
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    w = main.all_parameters()[0].name
    scope.set_var(w, torch.zeros_like(scope.find_var(w)))
    state = {n: scope.to_numpy(n) for n in (v.name for v in main.list_vars() if v.persistable)}
    got = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
    fresh_exe, fresh = _port_start(state)
    want = fresh_exe.run(main, feed=feed, fetch_list=[loss], scope=fresh)[0]
    np.testing.assert_array_equal(got, want)
    assert exe.last_plan is not None and exe.last_plan.runs == 3


def test_graph_refusal_is_read_off_the_ops():
    """A `while` op and SelectedRows gradients keep a plan off CUDA graphs."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        i = tfluid.layers.assign(np.zeros(1, "int32"))
        n = tfluid.layers.assign(np.full(1, 3, "int32"))
        cond = tfluid.layers.less_than(i, n)
        w = tfluid.layers.While(cond)
        with w.block():
            tfluid.layers.increment(i)
            tfluid.layers.less_than(i, n, cond=cond)
    ops = texecutor._runnable_ops(main.global_block())
    assert "while op" in texecutor._graph_refusal(ops)
    sparse_main, sparse_startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(sparse_main, sparse_startup):
        ids = tfluid.layers.data("ids", [1], dtype="int64")
        emb = tfluid.layers.embedding(ids, size=[10, 4], is_sparse=True)
        tfluid.optimizer.SGD(0.1).minimize(tfluid.layers.mean(emb))
    ops = texecutor._runnable_ops(sparse_main.global_block())
    assert "SelectedRows" in texecutor._graph_refusal(ops)
    fc_main, _, _ = _fc_program("torch")
    assert texecutor._graph_refusal(texecutor._runnable_ops(fc_main.global_block())) is None


# --------------------------------------------------------------------------
# steps > 1
# --------------------------------------------------------------------------


def test_steps_k_equals_k_runs_and_the_jax_package():
    K = 3
    jm, js, jl = _bert("jax")
    tm, _, tl = _bert("torch")
    jexe, jscope, state = _jax_start(jm, js)
    batches = _batches(K)
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    params = [p.name for p in jm.all_parameters()]
    grads = [f"{p}@GRAD" for p in params]
    jout = jexe.run(jm, feed=stacked, fetch_list=[jl] + grads, scope=jscope, steps=K)
    jgrads = [dict(zip(params, (np.asarray(g[k], np.float32) for g in jout[1:])))
              for k in range(K)]

    exe_k, scope_k = _port_start(state)
    (losses_k,) = exe_k.run(tm, feed=stacked, fetch_list=[tl], scope=scope_k, steps=K)
    exe_1, scope_1 = _port_start(state)
    losses_1 = [exe_1.run(tm, feed=b, fetch_list=[tl], scope=scope_1)[0] for b in batches]
    assert losses_k.shape == (K,) + losses_1[0].shape
    np.testing.assert_array_equal(losses_k, np.stack(losses_1))
    names = sorted(state)
    for n in names:
        np.testing.assert_array_equal(scope_k.to_numpy(n), scope_1.to_numpy(n), err_msg=n)
    np.testing.assert_allclose(losses_k.reshape(K), np.asarray(jout[0]).reshape(K),
                               atol=LOSS_TOL, rtol=0)
    _hold_state(scope_k, jscope, state, jgrads, names, K)


def test_steps_k_refusals_match_jax():
    for pkg, (fluid, unique) in PKG.items():
        main, startup = fluid.Program(), fluid.Program()
        with unique.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [1], dtype="float32", lod_level=1)
            y = fluid.layers.scale(x, scale=2.0)
        exe = fluid.Executor(fluid.CPUPlace())
        ragged = fluid.LoDTensor([np.ones((3, 1), "f4"), np.ones((2, 1), "f4")])
        with pytest.raises(ValueError) as ragged_err:
            exe.run(main, feed={"x": ragged}, fetch_list=[y], scope=fluid.Scope(), steps=2)
        with pytest.raises(ValueError) as axis_err:
            exe.run(main, feed={"x": np.ones((3, 1), "f4")}, fetch_list=[y],
                    scope=fluid.Scope(), steps=2)
        if pkg == "jax":
            want = (str(ragged_err.value), str(axis_err.value))
    assert (str(ragged_err.value), str(axis_err.value)) == want


# --------------------------------------------------------------------------
# run_async and FetchHandle (mirroring tests/test_async_pipeline.py)
# --------------------------------------------------------------------------


def _serial(main, startup, loss, feeds):
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    return [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0] for f in feeds], scope


def test_run_async_matches_run():
    """All 6 steps dispatched before any resolves: the same losses, state
    and generator as the synchronous loop (dropout 0.3 draws every step)."""
    main, startup, loss = _fc_program("torch", dropout=0.3)
    feeds = _fc_feeds(6)
    sync_losses, sync_scope = _serial(main, startup, loss, feeds)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    handles = [exe.run_async(main, feed=f, fetch_list=[loss], scope=scope) for f in feeds]
    for hs, want in zip(handles, sync_losses):
        np.testing.assert_array_equal(hs[0].numpy(), want)
    for n in sync_scope.local_var_names():
        if n != RNG_STATE_VAR:
            np.testing.assert_array_equal(scope.to_numpy(n), sync_scope.to_numpy(n), err_msg=n)
    assert torch.equal(scope.find_var(RNG_STATE_VAR).get_state(),
                       sync_scope.find_var(RNG_STATE_VAR).get_state())


def test_run_async_interleaves_with_run():
    main, startup, loss = _fc_program("torch", dropout=0.3)
    feeds = _fc_feeds(4)
    sync_losses, _ = _serial(main, startup, loss, feeds)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    for f in feeds[:3]:
        exe.run_async(main, feed=f, fetch_list=[loss], scope=scope)
    (last,) = exe.run(main, feed=feeds[3], fetch_list=[loss], scope=scope)
    np.testing.assert_array_equal(last, sync_losses[3])


def test_fetch_handle_api():
    main, y = _scale_program("torch")
    exe = tfluid.Executor(tfluid.CPUPlace())
    (h,) = exe.run_async(main, feed={"x": np.ones((2, 2), "f4")}, fetch_list=[y],
                         scope=tfluid.Scope())
    assert h.name == y and "in-flight" in repr(h)
    assert h.wait() is h and h.block_until_ready() is h and h.is_ready()
    np.testing.assert_allclose(np.asarray(h), np.full((2, 2), 2.0))
    np.testing.assert_allclose(h.numpy(), np.full((2, 2), 2.0))
    assert float(h) == 2.0 and "resolved" in repr(h)


# --------------------------------------------------------------------------
# pipeline.train_loop
# --------------------------------------------------------------------------


def test_train_loop_matches_jax_and_the_serial_loop(monitors):
    jm, js, jl = _bert("jax")
    tm, _, tl = _bert("torch")
    jexe, jscope, state = _jax_start(jm, js)
    batches = _batches(6)
    jstats = jfluid.train_loop(jexe, jm, iter(batches), [jl], scope=jscope, max_inflight=2,
                               log_period=2)
    texe, tscope = _port_start(state)
    tstats = tfluid.train_loop(texe, tm, iter(batches), [tl], scope=tscope, max_inflight=2,
                               log_period=2)
    for field in ("steps", "max_inflight_seen"):
        assert getattr(tstats, field) == getattr(jstats, field), field
    assert [s for s, _ in tstats.logged] == [s for s, _ in jstats.logged] == [0, 2, 4]
    for (_, tv), (_, jv) in zip(tstats.logged, jstats.logged):
        np.testing.assert_allclose(tv[0], np.asarray(jv[0]), atol=LOSS_TOL, rtol=0)
    assert tstats.wall_s > 0 and 0.0 <= tstats.host_blocked_frac <= 1.0
    records = [r for r in tmonitor.step_records() if r["kind"] == "pipeline_step"]
    assert len(records) == 6 and tmonitor.counter("executor.steps").value == 6
    assert tmonitor.gauge("pipeline.inflight").read() == 0
    sexe, sscope = _port_start(state)
    serial = [sexe.run(tm, feed=b, fetch_list=[tl], scope=sscope)[0] for b in batches]
    for s, vals in tstats.logged:
        np.testing.assert_array_equal(vals[0], serial[s])


def test_train_loop_errors_drain_and_carry_their_step(nan_guard, monitors):
    """A NaN at step 2 (resolution) and a failing dispatch hook at step 3:
    in both packages the loop drains what is in flight and the error names
    its step."""
    seen = {}
    for pkg, (fluid, _) in PKG.items():
        errors = jerrors if pkg == "jax" else terrors
        mon = jmonitor if pkg == "jax" else tmonitor
        main, startup, loss = _fc_program(pkg)
        feeds = _fc_feeds(6)
        feeds[2] = {"x": np.full_like(feeds[2]["x"], np.nan), "y": feeds[2]["y"]}
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        with pytest.raises(RuntimeError) as nan_err:
            fluid.train_loop(exe, main, iter(feeds), [loss], scope=scope, max_inflight=3,
                             log_period=1)
        assert mon.gauge("pipeline.inflight").read() == 0

        def hook(step, feed):
            if step == 13:
                raise RuntimeError("dispatch hook failed")

        scope = fluid.Scope()  # the NaN step poisoned the parameters
        exe.run(startup, scope=scope)
        with pytest.raises(RuntimeError) as hook_err:
            fluid.train_loop(exe, main, iter(_fc_feeds(6)), [loss], scope=scope,
                             max_inflight=3, step_offset=10, on_dispatch=hook)
        seen[pkg] = (type(nan_err.value).__name__, errors.get_context(nan_err.value)["step"],
                     str(hook_err.value), errors.get_context(hook_err.value)["step"])
    assert seen["torch"] == seen["jax"] == ("NumericError", 2, "dispatch hook failed", 13)


# --------------------------------------------------------------------------
# remat (mirroring tests/test_parallel.py test_memory_optimize_remat_matches_baseline)
# --------------------------------------------------------------------------


def _train(program, state, feeds, fetches, dropout_seed=0):
    exe, scope = _port_start(state)
    scope.set_var(RNG_STATE_VAR, torch.Generator().manual_seed(dropout_seed))
    return [exe.run(program, feed=f, fetch_list=fetches, scope=scope) for f in feeds], scope


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_memory_optimize_remat_matches_no_remat(dropout, monkeypatch):
    """The same losses, gradients and parameters with and without remat,
    and with dropout 0.1 too: the recompute repeats the forward's masks.
    The rematerialized step runs each forward op twice."""
    tm, ts, tl = _bert("torch", dropout)
    init_exe, init = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    init_exe.run(ts, scope=init)
    state = {v.name: init.to_numpy(v.name) for v in tm.list_vars() if v.persistable}
    grads = [f"{p.name}@GRAD" for p in tm.all_parameters()]
    feeds = _batches(3)
    strategy = tfluid.BuildStrategy()
    strategy.memory_optimize = True
    remat = tfluid.CompiledProgram(tm, strategy)

    calls = {"n": 0}
    lower_one = tlowering.lower_one

    def counting(ctx, op, env):
        calls["n"] += op.type == "mul"
        return lower_one(ctx, op, env)

    monkeypatch.setattr(tlowering, "lower_one", counting)
    plain_out, plain_scope = _train(tm, state, feeds, [tl] + grads)
    plain_calls, calls["n"] = calls["n"], 0
    remat_out, remat_scope = _train(remat, state, feeds, [tl] + grads)
    assert calls["n"] > plain_calls > 0
    for a, b in zip(remat_out, plain_out):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for n in state:
        np.testing.assert_array_equal(remat_scope.to_numpy(n), plain_scope.to_numpy(n))


def test_compiled_program_mesh_paths_name_their_slice():
    """with_data_parallel and with_grad_overlap are ported (ROADMAP A10.1);
    LocalSGD and a mesh with a model-parallel axis name their slice
    (A10.3)."""
    compiled = tfluid.CompiledProgram(tfluid.Program())
    assert compiled.with_data_parallel() is compiled and dict(compiled.mesh.shape) == {"dp": 1}
    assert compiled.with_grad_overlap() is compiled
    with pytest.raises(NotImplementedError, match="A10.3"):
        tfluid.CompiledProgram(tfluid.Program()).with_local_sgd()
    with pytest.raises(NotImplementedError, match="A10.3"):
        tfluid.CompiledProgram(tfluid.Program()).with_mesh(
            tfluid.parallel.make_mesh((1, 2), ("dp", "tp"), [0, 1]))

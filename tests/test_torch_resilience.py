"""The port's resilience layer on the CPU: the failure taxonomy, the fault
grammar, content digests, checkpoints across the packages, the resilient
loop against the JAX package, chaos runs against the port's own clean
runs, and the storage faults.

Tolerances: classes, messages, counters, digests and stream states
exactly; the resilient loop against the JAX package (dropout 0, the same
initial weights) 1e-5 in the losses and every persistable; a chaos run
against the port's clean run over the surviving batches (dropout 0.3)
bit for bit."""
import errno
import json
import os
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import integrity as j_integrity
from paddle_tpu import io as j_io
from paddle_tpu import monitor as j_monitor
from paddle_tpu.checkpoint_manager import CheckpointManager as JCheckpointManager
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu_torch import integrity as t_integrity
from paddle_tpu_torch import io as t_io
from paddle_tpu_torch import monitor as t_monitor
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.errors import (CheckpointError, DataError, NumericError, StorageError,
                                     TransientDeviceError)
from paddle_tpu_torch.ops import cuda_kernels as ck

FAST = dict(backoff_base_s=0.0)  # chaos tests must not sleep
TOL = 1e-5
PKGS = {
    "jax": dict(fluid=jfluid, io=j_io, monitor=j_monitor, unique=j_unique,
                integrity=j_integrity, CheckpointManager=JCheckpointManager),
    "torch": dict(fluid=tfluid, io=t_io, monitor=t_monitor, unique=t_unique,
                  integrity=t_integrity, CheckpointManager=tfluid.CheckpointManager),
}
RNG = "__rng_state__"


@pytest.fixture(autouse=True)
def _clean():
    before = dict(ck.LAUNCHES)
    yield
    t_io.set_io_fault_hook(None)
    j_io.set_io_fault_hook(None)
    assert ck.LAUNCHES == before, "a CPU run must not count a kernel launch"


@pytest.fixture
def mon():
    t_monitor.reset()
    t_monitor.enable()
    yield t_monitor
    t_monitor.disable()
    t_monitor.reset()


def _build(pkg, dropout=0.3, seed=11, width=(4, 8)):
    """tests/test_resilience.py's MLP: fc relu, dropout, fc, square error, Adam."""
    fluid = pkg["fluid"]
    main, startup = fluid.Program(), fluid.Program()
    with pkg["unique"].guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [width[0]], dtype="float32")
        y = fluid.layers.data("y", [1], dtype="float32")
        h = fluid.layers.fc(x, width[1], act="relu")
        if dropout:
            h = fluid.layers.dropout(h, dropout_prob=dropout)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(fluid.layers.fc(h, 1), y))
        fluid.optimizer.Adam(1e-2).minimize(loss)
    startup.random_seed = main.random_seed = seed
    return main, startup, loss


def _feeds(n, batch=8, dim=4):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        xv = rng.rand(batch, dim).astype("f4")
        out.append({"x": xv, "y": xv.sum(1, keepdims=True)})
    return out


def _fresh(startup, state=None):
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    if state is not None:
        tfluid.io.load_numpy_params(scope, state)
    return exe, scope


def _run(main, startup, loss, feeds, **kw):
    exe, scope = _fresh(startup)
    stats = tfluid.resilient_train_loop(exe, main, lambda: list(feeds), [loss], scope=scope, **kw)
    return stats, scope


def _state(scope):
    out = {}
    for n in scope.local_var_names():
        v = scope.find_var(n)
        out[n] = (v.get_state().numpy() if isinstance(v, torch.Generator)
                  else scope.to_numpy(n)).copy()  # a CPU tensor's numpy view shares its memory
    return out


def _assert_bitwise(a, b, what):
    assert sorted(a) == sorted(b), what
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=f"{what}: {n}")


# --- taxonomy and grammar: the same answers ------------------------------------

def _classify_cases(fluid):
    e = fluid.errors
    cases = [
        e.NumericError("x"), RuntimeError("fetch 'loss' contains NaN/Inf"),
        RuntimeError("RESOURCE_EXHAUSTED: out of memory"), RuntimeError("UNAVAILABLE: closed"),
        ValueError("user bug"), e.attach_context(ValueError("bad row"), batch_index=7,
                                                 phase="loader"),
        e.attach_context(RuntimeError("RESOURCE_EXHAUSTED: while staging"), batch_index=3,
                         phase="loader"),
        e.attach_context(ValueError("bad"), phase="feed"),
        e.attach_context(OSError(errno.EIO, "read failed"), phase="loader"),
        e.attach_context(OSError(errno.EIO, "read failed"), phase="storage"),
        OSError(errno.ENOENT, "x"),
    ] + [OSError(n, "boom") for n in (errno.ENOSPC, errno.EIO, errno.EAGAIN, errno.ETIMEDOUT,
                                       errno.EROFS, errno.EACCES)]
    out = []
    for exc in cases:
        ce = e.classify(exc)
        out.append((type(ce).__name__, str(ce), getattr(ce, "code", None),
                    getattr(ce, "resource_exhausted", None), getattr(ce, "transient", None),
                    getattr(ce, "phase", None), getattr(ce, "batch_index", None),
                    ce.__cause__ is exc if ce is not exc else "same"))
    out.append(type(e.classify(ValueError("x"), wrap_unknown=True)).__name__)
    ki = KeyboardInterrupt()
    out.append(e.classify(ki, wrap_unknown=True) is ki)
    out.append([c.__name__ for c in e.LockTimeoutError.__mro__[:4]])
    out.append([c.__name__ for c in e.CheckpointError.__mro__[:3]])
    out.append((sorted(e.TRANSIENT_STORAGE_ERRNOS), sorted(e.TERMINAL_STORAGE_ERRNOS)))
    out.append(str(e.StorageError("x", op="write", path="/p", errno=errno.ENOSPC)))
    return out


def test_classify_maps_as_the_jax_package_does():
    got = {name: _classify_cases(pkg["fluid"]) for name, pkg in PKGS.items()}
    assert got["torch"] == got["jax"]
    oom = tfluid.errors.classify(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert isinstance(oom, TransientDeviceError) and oom.resource_exhausted
    assert oom.code == "RESOURCE_EXHAUSTED" and oom.phase == "device"


SPECS = [" bad_batch@2; nan@5 ;device@7:RESOURCE_EXHAUSTED;preempt@9;",
         "bad_batch@5;nan@13;device@21:UNAVAILABLE;device@29:RESOURCE_EXHAUSTED",
         "kill_worker@3:1;stall_worker@6:0:0.2", "flip_bit@5:1;rot_shard@0",
         "enospc@4:1;eio@0:*man*;slow_io@2:250;ro_fs@3", "corrupt_chunk@1;truncated_file@2",
         "kill_pserver@3;stall_pserver@3:0.5;rot_row@0",
         "explode@3", "nan@soon", "kill_worker@3", "stall_worker@6:0", "flip_bit@5:x",
         "rot_shard@0:1", "slow_io@2", "slow_io@2:fast", "enospc@1:r0", "ro_fs@2:x",
         "stall_pserver@3:0"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_grammar_parses_alike(spec):
    got = {}
    for name, pkg in PKGS.items():
        faults = pkg["fluid"].faults
        try:
            got[name] = [(f.kind, f.at, f.arg, f.target_rank, str(f))
                         for f in faults.parse_fault_spec(spec)]
        except ValueError as err:
            got[name] = ("ValueError", str(err))
    assert got["torch"] == got["jax"]
    j, t = jfluid.faults, tfluid.faults
    assert t.KIND_INFO == j.KIND_INFO
    for s in ("nan@3;nan@3", "enospc@5;ro_fs@2", "kill_worker@3:1"):
        caps = ("dispatch",) if "kill" in s else None
        errs = [str(pytest.raises(ValueError, m.validate_schedule, s, caps).value)
                for m in (j, t)]
        assert errs[0] == errs[1]


@pytest.mark.parametrize("spec,item", [
    ("kill_worker@3:1", "A10"), ("stall_worker@6:0:0.2", "A10"), ("flip_bit@5:1", "A10"),
    ("enospc@4:1", "A10"), ("ro_fs@3:0", "A10")])
def test_injector_refuses_gang_and_parameter_server_entries(spec, item):
    """The port runs one training process: an entry aimed at a gang's
    worker rank parses, and the injector refuses it, naming the ROADMAP
    item that brings it.  The host-tier entries fire (the next test)."""
    assert tfluid.faults.parse_fault_spec(spec)[0].kind == spec.split("@")[0]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tfluid.FaultInjector("nan@1;" + spec)


class _Supervisor:
    """Stands in for a PServerSupervisor: records the chaos hooks' calls."""

    def __init__(self):
        self.calls = []

    def kill(self):
        self.calls.append(("kill",))

    def stall(self, seconds):
        self.calls.append(("stall", seconds))


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("spec", ["kill_pserver@3", "stall_pserver@3:0.5", "rot_row@1"])
def test_host_tier_entries_wait_for_their_target_then_fire(pkg, spec, tmp_path):
    """kill_pserver / stall_pserver stay pending at their step until a
    supervisor is registered, then fire on it once; rot_row passes its
    commit ordinal by while the commit holds no SelectedRows values shard,
    and rots the first one that does.  The same in both packages."""
    fluid = PKGS[pkg]["fluid"]
    inj = fluid.FaultInjector(spec)
    kind = spec.split("@")[0]
    if kind == "rot_row":
        dense = tmp_path / "dense"
        dense.mkdir()
        np.save(dense / "w.p0s0.npy", np.ones(8, "f4"))
        inj.on_commit(None)  # ordinal 0
        inj.on_commit(str(dense))  # ordinal 1: no .vals. shard, nothing to rot
        assert inj.pending() and (np.load(dense / "w.p0s0.npy") == 1).all()
        inj = fluid.FaultInjector(spec)
        sparse = tmp_path / "sparse"
        sparse.mkdir()
        vals = np.arange(1024, dtype="f4")  # the middle byte lies in the payload
        np.save(sparse / "t.rows.p0s0.npy", np.arange(1024))
        np.save(sparse / "t.vals.p0s0.npy", vals)
        inj.on_commit(None)
        inj.on_commit(str(sparse))
        assert not inj.pending() and inj.summary() == {"rot_row": 1}
        assert not np.array_equal(np.load(sparse / "t.vals.p0s0.npy"), vals)
        assert (np.load(sparse / "t.rows.p0s0.npy") == np.arange(1024)).all()
        return
    sup = _Supervisor()
    inj.on_dispatch(3)  # no supervisor: the entry stays pending
    assert inj.pending() and not sup.calls
    assert inj.set_pserver(sup) is inj
    inj.on_dispatch(2)
    assert inj.pending()
    inj.on_dispatch(3)
    inj.on_dispatch(3)  # fires once
    assert not inj.pending() and inj.summary() == {kind: 1}
    assert sup.calls == ([("kill",)] if kind == "kill_pserver" else [("stall", 0.5)])


def test_named_locks_keep_one_rank_per_name():
    from paddle_tpu_torch.core import locks

    lk = locks.named_lock("test.locks.rank", rank=7)
    with lk:
        assert lk.locked() and not lk.acquire(blocking=False)
    assert not lk.locked() and locks.named_lock("test.locks.rank", rank=7).rank == 7
    with pytest.raises(ValueError, match="already registered with rank 7"):
        locks.named_lock("test.locks.rank", rank=8)


def test_injector_hooks_fire_once_and_from_flags():
    inj = tfluid.FaultInjector("bad_batch@1;nan@2")
    with pytest.raises(DataError, match="injected bad batch 1"):
        inj.on_batch(1, {})
    assert inj.on_batch(1, {}) == {}
    feed = {"a": np.zeros(4, "i4"), "b": np.zeros((2, 3), "f4"), "c": torch.zeros(5)}
    out = inj.on_feed(2, feed)
    assert np.isnan(out["b"]).sum() == 1 and not np.isnan(feed["b"]).any()
    assert out["c"] is feed["c"]
    assert inj.on_feed(2, feed) is feed and inj.summary() == {"bad_batch": 1, "nan": 1}
    tensor_feed = {"x": torch.ones(3, 4), "y": torch.zeros(3, 1)}
    poisoned = tfluid.FaultInjector("nan@0").on_feed(0, tensor_feed)
    assert int(torch.isnan(poisoned["x"]).sum()) == 1 and not torch.isnan(tensor_feed["x"]).any()
    tfluid.set_flags({"FLAGS_fault_spec": "nan@3"})
    try:
        assert [f.kind for f in tfluid.FaultInjector.from_flags().pending()] == ["nan"]
    finally:
        tfluid.set_flags({"FLAGS_fault_spec": ""})
    assert tfluid.FaultInjector.from_flags() is None


def test_flip_bit_writes_into_the_scopes_tensor():
    main, startup, _ = _build(PKGS["torch"])
    _, scope = _fresh(startup)
    names = sorted(scope.local_var_names())
    held = {n: scope.find_var(n) for n in names}
    before = {n: t.clone() for n, t in held.items() if isinstance(t, torch.Tensor)}
    tfluid.FaultInjector("flip_bit@4").on_state(4, scope)
    changed = [n for n, t in before.items() if not torch.equal(scope.find_var(n), t)]
    assert len(changed) == 1 and scope.find_var(changed[0]) is held[changed[0]]
    assert torch.isfinite(scope.find_var(changed[0])).all()


# --- content digests -----------------------------------------------------------------

def test_state_digest_gives_the_same_hex_in_both_packages():
    """The same state (float32, bfloat16, int32 and a zero-size array) in a
    scope of each package: the same sha256, bf16 hashed by its bits; the
    amortized digester agrees with itself across packages too."""
    rng = np.random.RandomState(2)
    state = {"w": rng.randn(5, 3).astype("f4"), "b16": rng.randn(7).astype(ml_dtypes.bfloat16),
             "step": np.arange(4, dtype="i4"), "empty": np.zeros((0, 2), "f4")}
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    for n, a in state.items():
        jscope.set_var(n, a)
    tfluid.io.load_numpy_params(tscope, state)
    assert tscope.find_var("b16").dtype == torch.bfloat16
    digests = {"jax": j_integrity.state_digest(jscope), "torch": t_integrity.state_digest(tscope)}
    assert digests["torch"] == digests["jax"]
    assert t_integrity.state_digest(tscope, ["w", "step"]) == \
        j_integrity.state_digest(jscope, ["w", "step"])
    payloads = {}
    for name, (mod, scope) in {"jax": (j_integrity, jscope), "torch": (t_integrity, tscope)}.items():
        d = mod.StateDigester(scope, period=2)
        payloads[name] = [d.on_step(s) for s in range(4)]
    assert payloads["torch"] == payloads["jax"] and payloads["torch"][1] is not None
    # one flipped bit of a bf16 weight moves the digest
    tscope.find_var("b16").view(torch.int16)[3] ^= 1
    assert t_integrity.state_digest(tscope) != digests["jax"]
    verdict = t_integrity._vote({0: {"d": "a", "c": ["x"], "amax": [1.0]},
                                 1: {"d": "a", "c": ["x"], "amax": [1.0]},
                                 2: {"d": "b", "c": ["y"], "amax": [1e9]}})
    assert verdict == j_integrity._vote({0: {"d": "a", "c": ["x"], "amax": [1.0]},
                                         1: {"d": "a", "c": ["x"], "amax": [1.0]},
                                         2: {"d": "b", "c": ["y"], "amax": [1e9]}}) == ([2], True, 0)


# --- checkpoints across the packages -----------------------------------------------

def _stream_sidecar(fluid, tmp, n=12):
    """A RecordIO-backed shuffled batch reader stopped after two batches:
    (reader, its state) for the RESUME sidecar."""
    from paddle_tpu_torch import recordio
    p = os.path.join(tmp, "s.rio")
    if not os.path.exists(p):
        recordio.write_arrays(p, [(np.full(2, i, "f4"),) for i in range(n)], max_chunk_records=3)
    r = fluid.reader.batch(fluid.reader.shuffle(fluid.recordio.reader_creator(p), 5, seed=3), 2)
    it = r()
    next(it)
    next(it)
    return r, r.state_dict()


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_a_checkpoint_manager_dir_restores_in_the_other_package(tmp_path, saver):
    """A CheckpointManager of one package saves (parameters, moments, the
    generator, a RESUME sidecar with a pickled stream state); the other
    package's manager restores it.  Every persistable equal, the stream
    state equal, and the RNG var by the port's rule: a torch generator's
    state comes back bit for bit, a JAX PRNG key seeds the generator
    deterministically from its 64 bits and is counted
    (`checkpoint.rng_reseeded`)."""
    other = "torch" if saver == "jax" else "jax"
    built = {n: _build(p, dropout=0.0) for n, p in PKGS.items()}
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(built["jax"][1], scope=jscope)
    jexe.run(built["jax"][0], feed=_feeds(1)[0], fetch_list=[built["jax"][2]], scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in built["jax"][0].list_vars() if v.persistable}
    texe, tscope = _fresh(built["torch"][1], state)
    scopes = {"jax": jscope, "torch": tscope}
    _, stream = _stream_sidecar(PKGS[saver]["fluid"], str(tmp_path))
    root = str(tmp_path / "ckpt")
    sp = PKGS[saver]
    cm = sp["CheckpointManager"](root, program=built[saver][0], scope=scopes[saver])
    out = cm.save(step=7, sidecars={"RESUME.json": json.dumps(
        {"step": 7, "next_batch": 2, "stream_state": sp["io"].pack_stream_state(stream)})})
    assert out and os.path.isdir(out)
    op = PKGS[other]
    fresh = op["fluid"].Scope()
    kw = {"place": tfluid.CPUPlace()} if other == "torch" else {}
    cm2 = op["CheckpointManager"](root, program=built[other][0], scope=fresh, **kw)
    t_monitor.reset()
    t_monitor.enable()
    try:
        assert cm2.restore() == 7
    finally:
        t_monitor.disable()
    for v in built["jax"][0].list_vars():
        if not v.persistable:
            continue
        want = np.asarray(scopes[saver].find_var(v.name)) if saver == "jax" else \
            tscope.to_numpy(v.name)
        got = np.asarray(fresh.find_var(v.name)) if other == "jax" else fresh.to_numpy(v.name)
        np.testing.assert_array_equal(got, want, err_msg=v.name)
    info = json.load(open(os.path.join(cm2.last_restored_dir, "RESUME.json")))
    assert op["io"].unpack_stream_state(info["stream_state"]) == stream
    rng = fresh.find_var(RNG)
    if other == "torch":
        assert isinstance(rng, torch.Generator)
        assert t_monitor.counter("checkpoint.rng_reseeded").value == 1
        key = [int(k) for k in np.asarray(jscope.find_var(RNG)).reshape(-1)]
        again = torch.Generator()
        again.manual_seed((key[0] << 32) | key[1])
        assert torch.equal(rng.get_state(), again.get_state())
    else:
        assert np.asarray(rng).dtype == np.uint8  # the torch generator's state, as saved
        np.testing.assert_array_equal(np.asarray(rng), tscope.find_var(RNG).get_state().numpy())


def test_a_checkpoint_restores_into_the_scopes_own_tensors(tmp_path):
    """restore() copies into the tensors the scope holds (shape and dtype
    agreeing), the generator's state into the scope's generator; a
    generator state the generator cannot take raises CheckpointError."""
    main, startup, loss = _build(PKGS["torch"])
    exe, scope = _fresh(startup)
    cm = tfluid.CheckpointManager(str(tmp_path), program=main, scope=scope)
    exe.run(main, feed=_feeds(1)[0], fetch_list=[loss], scope=scope)
    saved = _state(scope)
    cm.save(step=1)
    for f in _feeds(3):
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    held = {n: scope.find_var(n) for n in scope.local_var_names()}
    assert cm.restore() == 1
    assert all(scope.find_var(n) is t for n, t in held.items())
    _assert_bitwise(_state(scope), saved, "restore in place")
    bad = os.path.join(cm.latest(), "__rng_state__.p0s0.npy")
    man = json.load(open(os.path.join(cm.latest(), "__sharded_manifest__.json")))
    np.save(bad, np.zeros(16, np.uint8))
    for e in man["vars"]:
        if e["name"] == RNG:
            e["shards"][0].update(t_integrity.stamp_file(bad))
            e["global_shape"] = [16]
            e["shards"][0]["index"] = [[0, 16]]
    with open(os.path.join(cm.latest(), "__sharded_manifest__.json"), "w") as f:
        json.dump(man, f)
    with pytest.raises(CheckpointError, match="__rng_state__"):
        t_io.load_sharded(cm.latest(), scope=tfluid.Scope(), device="cpu")


def test_what_waits_for_data_parallelism_raises_naming_it(tmp_path):
    main, _, _ = _build(PKGS["torch"])
    for kw in ({"world_size": 2, "rank": 1}, {"mesh": object()}, {"elastic": True}):
        with pytest.raises(NotImplementedError, match="A10"):
            tfluid.CheckpointManager(str(tmp_path), program=main, **kw)
    cm = tfluid.CheckpointManager(str(tmp_path), program=main)
    with pytest.raises(NotImplementedError, match="A10"):
        cm.restore(elastic=True)
    with pytest.raises(NotImplementedError, match="A10"):
        t_io.load_sharded(str(tmp_path), mesh=object())
    with pytest.raises(NotImplementedError, match="A10"):
        t_io.save_sharded(str(tmp_path), [], tfluid.Scope(), process_index=1)


# --- the resilient loop against the JAX package ----------------------------------

CHAOS = "bad_batch@5;nan@13;device@21:UNAVAILABLE;device@29:RESOURCE_EXHAUSTED"


def test_resilient_loop_matches_the_jax_package():
    """bench.py's bench_chaos spec on tests/test_resilience.py's MLP (dropout
    0, nan_mode skip_step, max_inflight 3), 34 batches, from the JAX
    package's initial weights in both: the same ResilienceStats, the same
    logged steps, losses and every persistable within 1e-5."""
    built = {n: _build(p, dropout=0.0) for n, p in PKGS.items()}
    feeds = _feeds(34)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(built["jax"][1], scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in built["jax"][0].list_vars() if v.persistable}
    texe, tscope = _fresh(built["torch"][1], state)
    runs = {"jax": (jexe, jscope), "torch": (texe, tscope)}
    stats = {}
    for name, pkg in PKGS.items():
        fluid = pkg["fluid"]
        exe, scope = runs[name]
        main, _, loss = built[name]
        stats[name] = fluid.resilient_train_loop(
            exe, main, lambda: list(feeds), [loss], scope=scope,
            injector=fluid.FaultInjector(CHAOS), nan_mode="skip_step",
            policy=fluid.RetryPolicy(**FAST), max_inflight=3)
    fields = ("steps", "preempted", "resume_step", "skipped_batches", "skipped_steps", "retries",
              "rollbacks", "degraded_inflight", "final_max_inflight", "segments")
    assert {f: getattr(stats["torch"], f) for f in fields} == \
        {f: getattr(stats["jax"], f) for f in fields}
    assert stats["torch"].steps == 32 and stats["torch"].final_max_inflight == 1
    assert [s for s, _ in stats["torch"].logged] == [s for s, _ in stats["jax"].logged]
    np.testing.assert_allclose([float(v[0].reshape(-1)[0]) for _, v in stats["torch"].logged],
                               [float(v[0].reshape(-1)[0]) for _, v in stats["jax"].logged],
                               rtol=TOL, atol=TOL)
    for name in state:
        np.testing.assert_allclose(tscope.to_numpy(name), np.asarray(jscope.find_var(name)),
                                   rtol=TOL, atol=TOL, err_msg=name)


# --- chaos runs against the port's own clean runs, bit for bit ---------------------

CHAOS_CASES = {
    # spec, nan_mode, max_inflight, raw batches dropped, steps, retries, inflight after
    "bad_batches": ("bad_batch@2;bad_batch@6", "raise", 3, (2, 6), 8, 0, 3),
    "skip_step": ("nan@4", "skip_step", 3, (4,), 9, 0, 3),
    "device_retry": ("device@5:UNAVAILABLE", "raise", 3, (), 10, 1, 3),
    "oom_halves_inflight": ("device@3:RESOURCE_EXHAUSTED", "raise", 4, (), 10, 1, 2),
    "all_at_once": ("bad_batch@2;nan@5;device@3:UNAVAILABLE;device@7:RESOURCE_EXHAUSTED",
                    "skip_step", 2, (2, 6), 8, 2, 1),
}


@pytest.mark.parametrize("case", sorted(CHAOS_CASES))
def test_chaos_run_equals_the_clean_run_over_the_surviving_batches(case, mon):
    """Dropout 0.3 (the generator is snapshotted and restored with the
    state): every persistable and the generator bit for bit."""
    spec, nan_mode, inflight, dropped, steps, retries, after = CHAOS_CASES[case]
    main, startup, loss = _build(PKGS["torch"])
    feeds = _feeds(10)
    stats, scope = _run(main, startup, loss, feeds, max_inflight=inflight,
                        injector=tfluid.FaultInjector(spec), nan_mode=nan_mode,
                        policy=tfluid.RetryPolicy(max_bad_batches=2, **FAST))
    assert (stats.steps, stats.retries, stats.final_max_inflight) == (steps, retries, after)
    assert mon.counter("resilience.retries").value == retries
    surviving = [f for i, f in enumerate(feeds) if i not in dropped]
    _, ref = _run(main, startup, loss, surviving, max_inflight=inflight)
    _assert_bitwise(_state(scope), _state(ref), case)
    if nan_mode == "skip_step":
        events = [r for r in mon.step_records() if r.get("kind") == "resilience_event"]
        assert "skip_step" in [e["action"] for e in events]
        assert not tfluid.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]


def test_nan_rollback_replays_to_full_parity(tmp_path, mon):
    main, startup, loss = _build(PKGS["torch"])
    feeds = _feeds(12)
    exe, scope = _fresh(startup)
    cm = tfluid.CheckpointManager(str(tmp_path), program=main, scope=scope, save_every_steps=3)
    stats = tfluid.resilient_train_loop(
        exe, main, lambda: list(feeds), [loss], scope=scope,
        injector=tfluid.FaultInjector("nan@7"), nan_mode="rollback", checkpoint_manager=cm,
        policy=tfluid.RetryPolicy(**FAST), max_inflight=3)
    assert stats.steps == 12 and stats.rollbacks == 1
    assert mon.counter("resilience.rollbacks").value == 1
    _, ref = _run(main, startup, loss, feeds, max_inflight=3)
    _assert_bitwise(_state(scope), _state(ref), "nan rollback")


def test_budgets_and_argument_checks():
    main, startup, loss = _build(PKGS["torch"])
    with pytest.raises(DataError, match="injected bad batch"):
        _run(main, startup, loss, _feeds(8), max_inflight=2,
             injector=tfluid.FaultInjector("bad_batch@1;bad_batch@3"),
             policy=tfluid.RetryPolicy(max_bad_batches=1, **FAST))
    with pytest.raises(NumericError):
        _run(main, startup, loss, _feeds(10), max_inflight=2,
             injector=tfluid.FaultInjector("nan@1;nan@5"), nan_mode="skip_step",
             policy=tfluid.RetryPolicy(max_skipped_steps=1, **FAST))
    with pytest.raises(TransientDeviceError):
        _run(main, startup, loss, _feeds(8), max_inflight=2,
             injector=tfluid.FaultInjector("device@1;device@3"),
             policy=tfluid.RetryPolicy(max_device_retries=1, **FAST))
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(ValueError, match="checkpoint_manager"):
        tfluid.resilient_train_loop(exe, main, iter(_feeds(2)), [loss], nan_mode="rollback")
    p = tfluid.RetryPolicy(backoff_base_s=0.1, backoff_factor=2.0, backoff_jitter=0.5, seed=3)
    q = jfluid.RetryPolicy(backoff_base_s=0.1, backoff_factor=2.0, backoff_jitter=0.5, seed=3)
    assert [p.backoff_s(i) for i in range(4)] == [q.backoff_s(i) for i in range(4)]


def _checkpointable_source(tmp, feeds):
    """The feeds as a RecordIO file through a shuffled, checkpointable reader."""
    p = os.path.join(tmp, "feeds.rio")
    tfluid.recordio.write_arrays(p, [(f["x"], f["y"]) for f in feeds], max_chunk_records=4)
    r = tfluid.reader
    return lambda: r.map_readers(lambda s: {"x": s[0], "y": s[1]},
                                 r.shuffle(tfluid.recordio.reader_creator(p), 5, seed=9))


@pytest.mark.parametrize("source", ["replay", "stream_seek"])
def test_preemption_flush_and_resume_bit_identical(tmp_path, source, mon):
    """SIGTERM at step 5 flushes a checkpoint (generator state and data
    position included); a fresh scope and executor resume to step 12, bit
    for bit equal to 12 straight steps, generator included.  A list source
    resumes by the loud replay fast-forward, a checkpointable reader by an
    O(1) seek of its stored stream state."""
    main, startup, loss = _build(PKGS["torch"])
    feeds = _feeds(12)
    factory = (lambda: list(feeds)) if source == "replay" else \
        _checkpointable_source(str(tmp_path), feeds)
    exe, ref_scope = _fresh(startup)
    tfluid.resilient_train_loop(exe, main, factory, [loss], scope=ref_scope, max_inflight=3)
    exe, scope = _fresh(startup)
    cm = tfluid.CheckpointManager(str(tmp_path / "ckpt"), program=main, scope=scope)
    stats = tfluid.resilient_train_loop(exe, main, factory, [loss], scope=scope,
                                        injector=tfluid.FaultInjector("preempt@5"),
                                        checkpoint_manager=cm, max_inflight=3)
    assert stats.preempted and stats.resume_step == 5 and stats.steps == 5
    info = json.load(open(os.path.join(stats.checkpoint_dir, "RESUME.json")))
    assert (info["step"], info["next_batch"]) == (5, 5)
    assert ("stream_state" in info) == (source == "stream_seek")
    exe2, scope2 = _fresh(startup)
    cm2 = tfluid.CheckpointManager(str(tmp_path / "ckpt"), program=main, scope=scope2)
    stats2 = tfluid.resilient_train_loop(exe2, main, factory, [loss], scope=scope2,
                                         checkpoint_manager=cm2, resume=True, max_inflight=3)
    assert stats2.steps == 12 and not stats2.preempted
    _assert_bitwise(_state(scope2), _state(ref_scope), "preemption resume")
    want = {"replay": ("resilience.replay_fallback", 1), "stream_seek": ("resilience.stream_seek", 1)}
    assert mon.counter(want[source][0]).value == want[source][1]
    assert mon.counter("resilience.preemptions").value == 1


def test_snapshots_are_values_and_restores_keep_the_tensors():
    from paddle_tpu_torch.resilience import _restore_scope, _snapshot_scope

    main, startup, loss = _build(PKGS["torch"])
    exe, scope = _fresh(startup)
    exe.run(main, feed=_feeds(1)[0], fetch_list=[loss], scope=scope)
    held = {n: scope.find_var(n) for n in scope.local_var_names()}
    snap = _snapshot_scope(scope)
    want = _state(scope)
    for f in _feeds(3):
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    for t in held.values():
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            t.add_(1.0)  # an in-place update after the snapshot
    _restore_scope(scope, snap)
    _assert_bitwise(_state(scope), want, "restore")
    _restore_scope(scope, snap)  # the snapshot is untouched by a restore
    _assert_bitwise(_state(scope), want, "second restore")
    assert scope.find_var(RNG) is held[RNG]


# --- storage faults (tests/test_storage_faults.py) ------------------------------------

def _cm(root, main, scope, **kw):
    kw.setdefault("retry_policy", tfluid.RetryPolicy(**FAST))
    return tfluid.CheckpointManager(str(root), program=main, scope=scope, **kw)


def test_atomic_write_and_the_read_seam(tmp_path, mon):
    p = str(tmp_path / "f.json")
    t_io.atomic_write(p, '{"a": 1}')
    t_io.set_io_fault_hook(lambda op, path: (_ for _ in ()).throw(OSError(errno.ENOSPC, "full")))
    with pytest.raises(OSError) as ei:
        t_io.atomic_write(p, '{"a": 2}')
    assert isinstance(tfluid.errors.classify(ei.value), StorageError)
    t_io.set_io_fault_hook(None)
    assert json.load(open(p)) == {"a": 1}
    assert [n for n in os.listdir(tmp_path) if "tmp~" in n] == []
    inj = tfluid.FaultInjector("eio@0:*f.json;slow_io@1:30").arm_io()
    try:
        with pytest.raises(OSError) as ei:
            t_io.open_for_read(p)
        ce = tfluid.errors.classify(ei.value)
        assert isinstance(ce, StorageError) and ce.transient and ei.value.errno == errno.EIO
        t0 = time.perf_counter()
        with t_io.open_for_read(p) as f:
            assert f.read() == b'{"a": 1}'
        assert time.perf_counter() - t0 >= 0.03
    finally:
        inj.disarm_io()
    assert mon.counter("faults.eio").value == 1 and mon.counter("faults.slow_io").value == 1


def test_enospc_save_retries_then_degrades_then_recovers(tmp_path, mon):
    main, startup, _ = _build(PKGS["torch"])
    _, scope = _fresh(startup)
    cm = _cm(tmp_path, main, scope)
    inj = tfluid.FaultInjector("enospc@4").arm_io()
    try:
        inj.set_step(2)
        assert cm.save(step=2) is not None
        inj.set_step(4)
        assert cm.save(step=4) is None
        assert cm.degraded and cm.ckpt_lag_steps == 2
        inj.set_step(6)
        assert cm.save(step=6) is not None and not cm.degraded
    finally:
        inj.disarm_io()
    assert mon.counter("faults.enospc").value == 1
    assert mon.counter("resilience.ckpt_save_retries").value == \
        tfluid.RetryPolicy().max_storage_retries
    assert mon.counter("resilience.storage_degraded").value == 1
    assert mon.counter("resilience.ckpt_recovered").value == 1
    assert mon.gauge("resilience.ckpt_lag_steps").read() == 0
    assert [r["action"] for r in mon.step_records() if r.get("kind") == "resilience_event"] == \
        ["storage_degraded", "storage_recovered"]
    assert cm.restore(scope=scope) == 6


def test_ro_fs_fallback_dir_lag_bound_and_quarantine(tmp_path, mon):
    main, startup, _ = _build(PKGS["torch"])
    _, scope = _fresh(startup)
    fb = str(tmp_path / "fallback")
    cm = _cm(tmp_path / "primary", main, scope, fallback_dir=fb)
    cm.save(step=2)
    inj = tfluid.FaultInjector("ro_fs@4").arm_io()
    try:
        inj.set_step(4)
        out = cm.save(step=4)
    finally:
        inj.disarm_io()
    assert out is not None and out.startswith(fb) and not cm.degraded
    assert mon.counter("resilience.ckpt_save_retries").value == 0
    assert mon.counter("resilience.ckpt_fallback_saves").value == 1
    assert cm.restore(scope=scope) == 4 and cm.last_restored_dir.startswith(fb)
    assert cm.reject_unsafe(3) >= 1
    assert cm.restore(scope=scope) == 2
    assert mon.counter("integrity.ckpt_rejected").value >= 1
    cm2 = _cm(tmp_path / "lagged", main, scope)
    tfluid.set_flags({"FLAGS_max_ckpt_lag_steps": 3})
    inj = tfluid.FaultInjector("ro_fs@0").arm_io()
    try:
        inj.set_step(0)
        assert cm2.save(step=0) is None
        inj.set_step(5)
        with pytest.raises(StorageError, match="FLAGS_max_ckpt_lag_steps") as ei:
            cm2.save(step=5)
        assert not ei.value.transient
    finally:
        inj.disarm_io()
        tfluid.set_flags({"FLAGS_max_ckpt_lag_steps": 0})


def test_restore_walks_back_past_unreadable_and_corrupt_checkpoints(tmp_path, mon):
    main, startup, _ = _build(PKGS["torch"])
    _, scope = _fresh(startup)
    cm = _cm(tmp_path, main, scope)
    for s in (2, 4, 6):
        cm.save(step=s)
    bad = os.path.join(str(tmp_path), "ckpt-0000000006")

    def hook(op, path):
        if op == "read" and path.startswith(bad) and path.endswith(".npy"):
            raise OSError(errno.EIO, "bad sector", path)

    t_io.set_io_fault_hook(hook)
    try:
        assert cm.restore(scope=scope) == 4
    finally:
        t_io.set_io_fault_hook(None)
    victim = sorted(n for n in os.listdir(os.path.join(str(tmp_path), "ckpt-0000000004"))
                    if n.endswith(".npy"))[0]
    path = os.path.join(str(tmp_path), "ckpt-0000000004", victim)
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 1]))
    t_io.set_io_fault_hook(hook)
    try:
        assert cm.restore(scope=scope) == 2
    finally:
        t_io.set_io_fault_hook(None)
    assert mon.counter("checkpoint.restore_skipped").value >= 3
    assert mon.counter("integrity.ckpt_rejected").value == 1
    assert t_integrity.scan_snapshot_dir(os.path.join(str(tmp_path), "ckpt-0000000004"))[0][
        "class"] == "digest_mismatch"


def test_resilient_loop_survives_enospc_with_parity(tmp_path, mon):
    main, startup, loss = _build(PKGS["torch"])
    feeds = _feeds(12)

    def run(spec, root):
        exe, scope = _fresh(startup)
        cm = _cm(root, main, scope, save_every_steps=3)
        stats = tfluid.resilient_train_loop(
            exe, main, lambda: list(feeds), [loss], scope=scope,
            injector=tfluid.FaultInjector(spec) if spec else None, checkpoint_manager=cm,
            policy=tfluid.RetryPolicy(**FAST), max_inflight=3)
        return stats, scope, cm

    stats, scope, cm = run("enospc@6", tmp_path / "chaos")
    assert stats.steps == 12
    assert mon.counter("resilience.storage_degraded").value == 1
    assert mon.counter("resilience.ckpt_recovered").value == 1
    assert "ckpt-0000000006" not in cm.checkpoints() and "ckpt-0000000009" in cm.checkpoints()
    _, ref, _ = run(None, tmp_path / "clean")
    _assert_bitwise(_state(scope), _state(ref), "storage chaos")
    assert t_io._IO_FAULT_HOOK is None


def test_preemption_handler_flushes_and_defers_during_a_save(tmp_path):
    import signal

    main, startup, _ = _build(PKGS["torch"])
    _, scope = _fresh(startup)
    cm = tfluid.CheckpointManager(str(tmp_path), program=main, scope=scope)
    seen = []
    old = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
        cm.install_preemption_handler(signals=(signal.SIGUSR1,))
        cm._step = 3
        os.kill(os.getpid(), signal.SIGUSR1)
        assert cm.checkpoints() == ["ckpt-0000000003"] and seen == [signal.SIGUSR1]
        cm._saving = True
        os.kill(os.getpid(), signal.SIGUSR1)
        assert cm._deferred_signal is not None and cm.checkpoints() == ["ckpt-0000000003"]
        cm._saving = False
        cm._deferred_signal = None
    finally:
        cm.uninstall_preemption_handler()
        signal.signal(signal.SIGUSR1, old)


# --- integrity: a divergence verdict and a rotted checkpoint ---------------------

def test_divergence_verdict_drives_a_bit_identical_rollback(tmp_path, mon):
    """FLAGS_integrity_check_period arms the live digester; a verdict
    latched mid-run (as a gang's beat thread would) rolls the loop back to
    the newest checkpoint at or before its safe_step, quarantining newer
    ones, and the run ends bit for bit as an uninterrupted one."""
    main, startup, loss = _build(PKGS["torch"])
    feeds = _feeds(16)
    tfluid.set_flags({"FLAGS_integrity_check_period": 2})

    def run(root, poison):
        exe, scope = _fresh(startup)
        cm = tfluid.CheckpointManager(root, program=main, scope=scope, save_every_steps=4)
        fired = []

        def on_logged(step, vals):
            if poison and step == 9 and not fired:
                fired.append(step)
                t_integrity.flag_divergence(
                    {"g": 0, "e": 4, "step": 9, "corrupt_ranks": [0], "attributed": True,
                     "chunk": 0, "safe_step": 8, "digests": {0: "aa", 1: "bb"}})

        stats = tfluid.resilient_train_loop(exe, main, lambda: list(feeds), [loss], scope=scope,
                                            checkpoint_manager=cm, max_inflight=1,
                                            on_logged=on_logged, max_steps=16)
        return stats, _state(scope)

    try:
        _, clean = run(str(tmp_path / "clean"), False)
        stats, poisoned = run(str(tmp_path / "poisoned"), True)
    finally:
        tfluid.set_flags({"FLAGS_integrity_check_period": 0})
    assert stats.rollbacks == 1 and mon.counter("integrity.rollbacks").value == 1
    assert mon.counter("integrity.digests").value > 0
    _assert_bitwise(poisoned, clean, "integrity rollback")
    events = [r for r in mon.step_records() if r.get("kind") == "resilience_event"
              and r.get("class") == "IntegrityError"]
    assert events and events[0]["corrupt_ranks"] == [0]


def test_rot_shard_then_resume_walks_back_bit_identical(tmp_path, mon):
    """rot_shard@1 flips a byte of the second committed checkpoint; a resume
    into an empty scope rejects it by digest, restores the first, and ends
    bit for bit as a resume from the pristine tree."""
    main, startup, loss = _build(PKGS["torch"])
    feeds = _feeds(12)

    def first_half(root, injector):
        exe, scope = _fresh(startup)
        cm = tfluid.CheckpointManager(root, program=main, scope=scope, save_every_steps=3)
        tfluid.resilient_train_loop(exe, main, lambda: list(feeds), [loss], scope=scope,
                                    checkpoint_manager=cm, injector=injector, max_inflight=1,
                                    max_steps=8)

    def resume(root):
        scope = tfluid.Scope()
        cm = tfluid.CheckpointManager(root, program=main, scope=scope, save_every_steps=3,
                                      place=tfluid.CPUPlace())
        tfluid.resilient_train_loop(tfluid.Executor(tfluid.CPUPlace()), main,
                                    lambda: list(feeds), [loss], scope=scope,
                                    checkpoint_manager=cm, resume=True, max_inflight=1,
                                    max_steps=12)
        return t_integrity.state_digest(scope), _state(scope)

    first_half(str(tmp_path / "clean"), None)
    first_half(str(tmp_path / "rot"), tfluid.FaultInjector("rot_shard@1"))
    rejected = mon.counter("integrity.ckpt_rejected").value
    clean_sha, clean = resume(str(tmp_path / "clean"))
    sha, state = resume(str(tmp_path / "rot"))
    assert mon.counter("integrity.ckpt_rejected").value == rejected + 1
    assert sha == clean_sha
    _assert_bitwise(state, clean, "rot_shard resume")

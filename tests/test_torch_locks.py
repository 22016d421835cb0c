"""The port's named locks (paddle_tpu_torch/core/locks.py) and static
resource planner (core/resource_plan.py) against the JAX package's on the
CPU: rank registration, re-entrancy, the condition's wait_for, the opt-in
telemetry counters, the FLAGS_lock_timeout_s deadline's LockTimeoutError,
the serving and lock flags' defaults, and `plan_program`'s peak bytes on
the zoo's tiny programs."""
import threading
import time
from importlib import import_module
from types import SimpleNamespace

import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu_torch.core import unique_name as t_unique


def _pkg(fluid, unique):
    return SimpleNamespace(fluid=fluid, unique=unique,
                           locks=import_module(f"{fluid.__name__}.core.locks"),
                           rp=import_module(f"{fluid.__name__}.core.resource_plan"),
                           errors=fluid.errors, flags=fluid.flags, monitor=fluid.monitor)


PKGS = {"jax": _pkg(jfluid, j_unique), "torch": _pkg(tfluid, t_unique)}


def _both(fn):
    got = {name: fn(P) for name, P in PKGS.items()}
    assert got["torch"] == got["jax"], got
    return got["torch"]


@pytest.fixture
def lock_flags():
    """Restores FLAGS_lock_telemetry / FLAGS_lock_timeout_s (and the locks'
    cached copies) and the monitors after the test."""
    saved = {n: P.flags.get_flags(["FLAGS_lock_telemetry", "FLAGS_lock_timeout_s"])
             for n, P in PKGS.items()}
    for P in PKGS.values():
        P.monitor.reset()
        P.monitor.enable()
    yield
    for n, P in PKGS.items():
        P.flags.set_flags(saved[n])
        P.monitor.disable()
        P.monitor.reset()


SERVING_FLAGS = ("FLAGS_serving_max_queue", "FLAGS_serving_default_deadline_ms",
                 "FLAGS_serving_hbm_budget_mb", "FLAGS_serving_quant_atol",
                 "FLAGS_serving_slo_target", "FLAGS_serving_buckets", "FLAGS_lock_telemetry",
                 "FLAGS_lock_timeout_s")


def test_serving_and_lock_flags_have_the_jax_defaults():
    _both(lambda P: P.flags.get_flags(list(SERVING_FLAGS)))


def test_one_rank_per_name_and_the_rank_table():
    def case(P):
        P.locks.named_lock("test.ranked", rank=30)
        P.locks.named_lock("test.ranked", rank=30)  # the same rank: another instance
        with pytest.raises(ValueError, match="one rank per name"):
            P.locks.named_lock("test.ranked", rank=31)
        return {n: r for n, r in P.locks.lock_ranks().items()
                if n in ("test.ranked", "serving.registry", "serving.server", "serving.publish")}

    tfluid.serving.ModelRegistry(place=tfluid.CPUPlace())  # registers the serving locks
    jfluid.serving.ModelRegistry(place=jfluid.CPUPlace())
    tfluid.serving.Server(tfluid.serving.ModelRegistry(place=tfluid.CPUPlace()), start=False)
    jfluid.serving.Server(jfluid.serving.ModelRegistry(place=jfluid.CPUPlace()), start=False)
    got = _both(case)
    assert got == {"test.ranked": 30, "serving.registry": 14, "serving.server": 12,
                   "serving.publish": 10}


def test_reentrancy_and_locked():
    def case(P):
        r = P.locks.named_rlock("test.reentrant", rank=32)
        with r:
            with r:
                inner = r.locked()
            still = r.locked()
        plain = P.locks.named_lock("test.plain", rank=33)
        with plain:
            again = plain.acquire(False)
        return [inner, still, r.locked(), again, plain.locked(), repr(plain), r.reentrant]

    assert _both(case)[:5] == [True, True, False, False, False]


def test_condition_wait_for():
    def case(P):
        cv = P.locks.named_condition("test.cond", rank=34)
        box = []

        def produce():
            time.sleep(0.02)
            with cv:
                box.append(1)
                cv.notify_all()

        t = threading.Thread(target=produce)
        t.start()
        with cv:
            ok = cv.wait_for(lambda: box, timeout=5)
        t.join()
        with cv:
            late = cv.wait_for(lambda: len(box) > 1, timeout=0.01)
        return [bool(ok), bool(late), cv.name, cv.rank]

    assert _both(case) == [True, False, "test.cond", 34]


def test_telemetry_counters_and_order_inversions(lock_flags):
    def case(P):
        P.flags.set_flags({"FLAGS_lock_telemetry": True})
        hi = P.locks.named_lock("test.tel_hi", rank=41)
        lo = P.locks.named_lock("test.tel_lo", rank=40)
        held = []
        for _ in range(3):
            with lo:
                with hi:  # ascending: legal
                    held.append(P.locks.held_locks())
        with hi:
            with lo:  # descending: counted, never raised
                pass
        gate, done = threading.Event(), threading.Event()

        def holder():
            with lo:
                gate.set()
                done.wait(5)

        t = threading.Thread(target=holder)
        t.start()
        gate.wait(5)
        threading.Timer(0.05, done.set).start()
        with lo:  # contended: waits for the holder
            pass
        t.join()
        P.flags.set_flags({"FLAGS_lock_telemetry": False})
        c = P.monitor.MONITOR.counter_values()
        return {"held": held[0],
                "counts": {k: c.get(k) for k in (
                    "lock.test.tel_lo.acquires", "lock.test.tel_hi.acquires",
                    "lock.test.tel_lo.contended", "lock.order_inversions")},
                "waited": c.get("lock.test.tel_lo.wait_us", 0) > 0,
                "held_us": c.get("lock.test.tel_hi.hold_us", 0) >= 0}

    got = _both(case)
    assert got["held"] == [("test.tel_lo", 40), ("test.tel_hi", 41)]
    assert got["counts"] == {"lock.test.tel_lo.acquires": 6, "lock.test.tel_hi.acquires": 4,
                             "lock.test.tel_lo.contended": 1, "lock.order_inversions": 1}
    assert got["waited"]


def test_deadline_raises_lock_timeout_error_naming_both_sides(lock_flags):
    def case(P):
        P.flags.set_flags({"FLAGS_lock_timeout_s": 0.05})
        outer = P.locks.named_lock("test.dl_outer", rank=42)
        inner = P.locks.named_lock("test.dl_inner", rank=43)
        gate, done = threading.Event(), threading.Event()

        def holder():
            with inner:
                gate.set()
                done.wait(5)

        t = threading.Thread(target=holder)
        t.start()
        gate.wait(5)
        try:
            with outer:
                with pytest.raises(P.errors.LockTimeoutError) as ei:
                    inner.acquire()
        finally:
            done.set()
            t.join()
        # a condition's re-acquisition after wait() is exempt from the deadline
        cv = P.locks.named_condition("test.dl_cond", rank=44)
        with cv:
            cv.wait(0.01)
        P.flags.set_flags({"FLAGS_lock_timeout_s": 0.0})
        e = ei.value
        return {"wanted": (e.wanted, e.wanted_rank), "held": e.held, "timeout": e.timeout_s,
                "fatal": isinstance(e, P.errors.FatalError), "phase": e.phase,
                "classified": P.errors.classify(e) is e}

    got = _both(case)
    assert got["wanted"] == ("test.dl_inner", 43) and got["held"] == [("test.dl_outer", 42)]
    assert got["fatal"] and got["classified"] and got["timeout"] == 0.05


# --------------------------------------------------------------------------
# the resource planner on the zoo's tiny programs
# --------------------------------------------------------------------------

ZOO = ("mnist", "resnet50", "bert", "bert_fused_bf16", "nmt", "deepfm")


def _zoo_program(P, name):
    """(main, loss name) of a tiny zoo configuration, built with the
    package's own layers."""
    def mod(m):
        return import_module(f"{P.fluid.__name__}.models.{m}")

    with P.unique.guard():
        if name == "mnist":
            main, _, _, f = mod("mnist").build(learning_rate=1e-3)
        elif name == "resnet50":
            main, _, _, f = mod("resnet").build(depth=50, class_dim=10, image_shape=(3, 32, 32),
                                                with_optimizer=True)
        elif name in ("bert", "bert_fused_bf16"):
            fused = name == "bert_fused_bf16"
            main, _, _, f = mod("transformer").build_bert(
                with_optimizer=True, vocab_size=200, seq_len=16, d_model=32, n_layers=2,
                n_heads=2, d_ff=64, dtype="bfloat16" if fused else "float32",
                use_fused_attention=fused)
        elif name == "nmt":
            main, _, _, f = mod("nmt").build_transformer_nmt(
                dropout=0.1, learning_rate=2.0, src_vocab=80, tgt_vocab=80, d_model=32,
                n_layers=1, n_heads=2, d_ff=64)
        else:
            main, _, _, f = mod("deepfm").build(learning_rate=0.05, num_fields=4, vocab_size=50,
                                                embed_dim=4, mlp_dims=(8,))
    return main, f["loss"].name


def _feed_shapes(main, batch=4):
    """Every var an op reads and no op writes, that is not persistable: the
    feeds, their dynamic dims at `batch`."""
    block = main.global_block()
    written = {n for op in block.ops for n in op.output_arg_names}
    read = {n for op in block.ops for n in op.input_arg_names}
    shapes = {}
    for n in sorted(read - written):
        v = block.var(n) if block.has_var(n) else None
        if v is None or v.persistable or v.shape is None:
            continue
        shapes[n] = tuple(batch if int(d) < 0 else int(d) for d in v.shape)
    return shapes


@pytest.mark.parametrize("name", ZOO)
def test_plan_program_peak_bytes_equal_on_the_zoo(name):
    def case(P):
        main, loss = _zoo_program(P, name)
        plan = P.rp.plan_program(main, _feed_shapes(main), [loss])
        return {"peak_bytes": plan.peak_bytes, "persistable_bytes": plan.persistable_bytes,
                "feed_bytes": plan.feed_bytes, "peak_temp_bytes": plan.peak_temp_bytes,
                "peak_op": (plan.peak_op_idx, plan.peak_op_type), "batch": plan.batch,
                "watermark": [(w["var"], w["bytes"]) for w in plan.watermark],
                "rows": [(r.op_idx, r.op_type, r.live_bytes) for r in plan.rows]}

    got = _both(case)
    assert got["peak_bytes"] == (got["persistable_bytes"] + got["feed_bytes"]
                                 + got["peak_temp_bytes"]) > 0

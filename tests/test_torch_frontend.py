"""The front end of the port on the CPU against the JAX package: the fetch
and feed dtypes (ROADMAP C1, C2), IntegrityError's class (C3), the verifier
and shape inference (core/analysis.py), the three program passes, the
port's own builds of the zoo against the JAX package's, checkpoints across
the packages and the fit-a-line program.

Every case runs through both packages on the same numpy inputs, drawn from
a seed.  Tolerances: integer fetches exact, float32 fetches 1e-7 (one
rounding of a value near 1) unless a case states its own; programs by
`to_dict`, exactly; diagnostics by code and error class."""
import contextlib
import json
import os
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import analysis as j_analysis
from paddle_tpu.core import passes as j_passes
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.core.program import Operator as JOperator
from paddle_tpu_torch.core import analysis as t_analysis
from paddle_tpu_torch.core import passes as t_passes
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Operator as TOperator
from paddle_tpu_torch.ops import cuda_kernels as ck

F32_TOL = 1e-7

PKGS = {
    "jax": dict(fluid=jfluid, unique=j_unique, analysis=j_analysis, passes=j_passes,
                Operator=JOperator),
    "torch": dict(fluid=tfluid, unique=t_unique, analysis=t_analysis, passes=t_passes,
                  Operator=TOperator),
}


@pytest.fixture(autouse=True)
def launches_unchanged():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before, "a CPU run must not count a kernel launch"


@contextlib.contextmanager
def _flag(fluid, name, value):
    old = fluid.get_flags([name])[name]
    fluid.set_flags({name: value})
    try:
        yield
    finally:
        fluid.set_flags({name: old})


def _both(fn):
    """fn(pkg dict) for each package: {"jax": ..., "torch": ...}."""
    return {name: fn(pkg) for name, pkg in PKGS.items()}


# --- C1: a fetched bfloat16 value is an ml_dtypes bfloat16 array, bits kept ----

def _bf16_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [5], dtype="float32")
        y = fluid.layers.cast(fluid.layers.scale(x, 1.0 / 3.0), "bfloat16")
    return main, startup, y


def _bf16_feed():
    return {"x": np.random.RandomState(0).randn(3, 5).astype(np.float32)}


def _check_bf16(got, want):
    assert got.dtype == want.dtype == ml_dtypes.bfloat16, (got.dtype, want.dtype)
    np.testing.assert_array_equal(np.asarray(got).view(np.uint16),
                                  np.asarray(want).view(np.uint16))


@pytest.mark.parametrize("how", ["run", "run_async"])
def test_bf16_fetch_is_ml_dtypes_bfloat16_with_the_jax_packages_bits(how):
    outs = {}
    for name, pkg in PKGS.items():
        fluid = pkg["fluid"]
        main, startup, y = _bf16_program(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        if how == "run":
            (outs[name],) = exe.run(main, feed=_bf16_feed(), fetch_list=[y], scope=fluid.Scope())
        else:
            (handle,) = exe.run_async(main, feed=_bf16_feed(), fetch_list=[y], scope=fluid.Scope())
            outs[name] = handle.numpy()
    _check_bf16(outs["torch"], outs["jax"])


def test_bf16_fetch_through_the_predictor_matches_jax(tmp_path):
    main, startup, y = _bf16_program(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.io.save_inference_model(str(tmp_path), ["x"], [y], exe, main, scope)
    outs = {}
    for name, pkg in PKGS.items():
        fluid = pkg["fluid"]
        p = fluid.inference.create_predictor(
            fluid.inference.AnalysisConfig(str(tmp_path), fluid.CPUPlace()))
        (run_out,) = p.run(_bf16_feed())
        p.get_input_handle("x").copy_from_cpu(_bf16_feed()["x"])
        p.run_zero_copy()
        outs[name] = (run_out, p.get_output_handle(p.get_output_names()[0]).copy_to_cpu())
    for got, want in zip(outs["torch"], outs["jax"]):
        _check_bf16(got, want)


def test_bf16_fetch_without_ml_dtypes_names_it(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_ml_dtypes(name, *a, **k):
        if name == "ml_dtypes":
            raise ImportError("no module named ml_dtypes")
        return real_import(name, *a, **k)

    main, startup, y = _bf16_program(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    monkeypatch.setattr(builtins, "__import__", no_ml_dtypes)
    with pytest.raises(ImportError, match="ml_dtypes"):
        exe.run(main, feed=_bf16_feed(), fetch_list=[y], scope=tfluid.Scope())
    (t,) = exe.run(main, feed=_bf16_feed(), fetch_list=[y], scope=tfluid.Scope(),
                   return_numpy=False)
    assert t.dtype == torch.bfloat16


# --- C2: feeds go through the x32 rule ---------------------------------------

def _feed_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [3], dtype="float64")
        third = fluid.layers.scale(x, 1.0 / 3.0)
        fluid.layers.data("label", [1], dtype="int64")
        fluid.layers.data("seq", [1], dtype="int64", lod_level=1)
        fluid.layers.data("undeclared_dtype", [2], dtype="float32")
    return main, third


def test_float64_int64_and_ragged_int64_feeds_compute_as_the_jax_package():
    rng = np.random.RandomState(0)
    feed = {"x": 1.0 + 2.0 ** -30 + rng.rand(2, 3),  # float64
            "label": rng.randint(0, 2 ** 40, (2, 1)).astype(np.int64) % 1000,
            "seq": [rng.randint(0, 50, (3, 1)).astype(np.int64),
                    rng.randint(0, 50, (1, 1)).astype(np.int64)]}
    fetch = ["x", None, "label", "seq", "seq@LOD"]

    def run(pkg):
        fluid = pkg["fluid"]
        main, third = _feed_program(fluid)
        names = [n if n is not None else third.name for n in fetch]
        return fluid.Executor(fluid.CPUPlace()).run(main, feed=feed, fetch_list=names,
                                                    scope=fluid.Scope())

    outs = _both(run)
    for got, want, name in zip(outs["torch"], outs["jax"], fetch):
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        assert got.shape == want.shape, (name, got.shape, want.shape)
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL, err_msg=str(name))
        else:
            np.testing.assert_array_equal(got, want, err_msg=str(name))
    assert outs["torch"][0].dtype == np.float32 and outs["torch"][2].dtype == np.int32


def test_int32_ids_reach_every_int64_consumer():
    """After C2 ids and labels arrive as int32: lookup_table, one_hot,
    cross_entropy and the xent's plain path take them (each casts at its
    use), and the fetched top-k indices are int32 in both packages."""
    def run(pkg):
        fluid = pkg["fluid"]
        main, startup = fluid.Program(), fluid.Program()
        with pkg["unique"].guard(), fluid.program_guard(main, startup):
            ids = fluid.layers.data("ids", [1], dtype="int64")
            emb = fluid.layers.embedding(ids, size=[10, 4])
            hot = fluid.layers.one_hot(ids, 10)
            prob = fluid.layers.softmax(fluid.layers.fc(emb, 10))
            ce = fluid.layers.cross_entropy(prob, ids)
            sce = fluid.layers.softmax_with_cross_entropy(fluid.layers.fc(hot, 10), ids)
            _, idx = fluid.layers.topk(prob, 3)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        params = sorted(p.name for p in main.all_parameters())
        return main, exe, scope, params, [ce, sce, idx, hot]

    built = _both(run)
    rng = np.random.RandomState(1)
    state = {n: rng.randn(*built["jax"][0].global_block().var(n).shape).astype(np.float32)
             for n in built["jax"][3]}
    feed = {"ids": rng.randint(0, 10, (6, 1)).astype(np.int64)}
    outs = {}
    for name, (main, exe, scope, params, fetch) in built.items():
        for n, a in state.items():
            scope.set_var(n, a if name == "torch" else __import__("jax").numpy.asarray(a))
        outs[name] = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    for got, want in zip(outs["torch"], outs["jax"]):
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# --- C3: a tampered checkpoint raises the JAX package's class -----------------

def _tiny_checkpoint(fluid, dirname):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4], dtype="float32")
        fluid.layers.fc(x, 3)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.io.save_persistables(exe, dirname, main, scope)
    return main, exe


@pytest.mark.parametrize("tamper", ["flip_a_byte", "truncate", "delete"])
def test_tampered_checkpoint_raises_the_same_integrity_error(tmp_path, tamper):
    classes = {}
    for name, pkg in PKGS.items():
        fluid = pkg["fluid"]
        d = str(tmp_path / name)
        main, exe = _tiny_checkpoint(fluid, d)
        victim = os.path.join(d, json.load(open(os.path.join(d, "__manifest__.json")))
                              ["vars"][0]["file"])
        if tamper == "delete":
            os.remove(victim)
        else:
            with open(victim, "r+b") as f:
                if tamper == "truncate":
                    f.truncate(os.path.getsize(victim) - 4)
                else:
                    f.seek(-1, os.SEEK_END)
                    last = f.read(1)
                    f.seek(-1, os.SEEK_END)
                    f.write(bytes([last[0] ^ 1]))
        with pytest.raises(Exception) as ei:
            fluid.io.load_persistables(exe, d, main, fluid.Scope())
        assert isinstance(ei.value, fluid.errors.TrainingError)
        assert isinstance(ei.value, fluid.errors.IntegrityError)
        assert ei.value.file == os.path.basename(victim)
        classes[name] = (type(ei.value).__name__, [c.__name__ for c in type(ei.value).__mro__],
                         ei.value.phase, ei.value.expected is None, ei.value.actual is None)
    assert classes["torch"] == classes["jax"]
    assert tfluid.io.IntegrityError is tfluid.errors.IntegrityError


# --- the verifier and shape inference, case by case in both packages ---------

def _relu_chain(pkg):
    fluid = pkg["fluid"]
    main, startup = fluid.Program(), fluid.Program()
    with pkg["unique"].guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4], dtype="float32")
        y = fluid.layers.relu(x)
        z = fluid.layers.relu(y)
    return main, startup, x, y, z


def _codes(diags):
    return sorted((d.code, d.severity, d.op_idx, d.op_type, d.var, d.block) for d in diags)


def _raises(fn):
    """The class name and MRO names of what fn() raises, or None."""
    try:
        fn()
    except Exception as e:  # the class is what the case compares
        return type(e).__name__, [c.__name__ for c in type(e).__mro__]
    return None


def _case_use_before_def(pkg):
    main, _, x, y, z = _relu_chain(pkg)
    blk = main.global_block()
    blk.ops = [blk.ops[1], blk.ops[0]]
    return _codes(pkg["analysis"].verify_program(main))


def _case_dangling_var(pkg):
    main, _, x, y, z = _relu_chain(pkg)
    main.global_block().ops[0].inputs["X"] = ["ghost"]
    return _codes(pkg["analysis"].verify_program(main))


def _case_unregistered_op(pkg):
    main, _, x, y, z = _relu_chain(pkg)
    blk = main.global_block()
    blk.ops.append(pkg["Operator"](blk, "reluu", {"X": [y.name]}, {"Out": [z.name]}))
    diags = pkg["analysis"].verify_program(main)
    return _codes(diags), ["relu" in d.message for d in diags]


def _case_orphan_sub_block(pkg):
    main, _, x, y, z = _relu_chain(pkg)
    main.global_block().ops[0].attrs["sub_block"] = 99
    first = _codes(pkg["analysis"].verify_program(main))
    main2, _, x2, y2, z2 = _relu_chain(pkg)
    sub = main2.create_block()
    sub.ops.append(pkg["Operator"](sub, "relu", {"X": [x2.name]}, {"Out": [y2.name]}))
    main2.rollback()
    return first, _codes(pkg["analysis"].verify_program(main2))


def _case_duplicate_param_write(pkg):
    fluid = pkg["fluid"]
    main, startup = fluid.Program(), fluid.Program()
    with pkg["unique"].guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4], dtype="float32")
        fluid.layers.fc(x, 4)
    blk = main.global_block()
    w = blk.all_parameters()[0]
    for _ in range(2):
        blk.ops.append(pkg["Operator"](blk, "assign", {"X": [x.name]}, {"Out": [w.name]}))
    return _codes(pkg["analysis"].verify_program(main))


def _case_fetch_target_missing_at_executor(pkg):
    fluid = pkg["fluid"]
    main, startup, x, y, z = _relu_chain(pkg)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return _raises(lambda: exe.run(main, feed={"x": np.ones((2, 4), "f4")},
                                   fetch_list=["nope"], scope=scope))


def _case_feed_target_unknown(pkg):
    main, _, x, y, z = _relu_chain(pkg)
    return _codes(pkg["analysis"].verify_feed_fetch(main, feed_names=["mystery"],
                                                    fetch_names=[z.name]))


def _case_elementwise_shape_mismatch(pkg):
    fluid = pkg["fluid"]
    main, startup = fluid.Program(), fluid.Program()
    with pkg["unique"].guard(), fluid.program_guard(main, startup):
        a = fluid.layers.data("a", [4], dtype="float32")
        b = fluid.layers.data("b", [5], dtype="float32")
        return _raises(lambda: fluid.layers.elementwise_add(a, b))


def _case_matmul_contraction_mismatch(pkg):
    fluid = pkg["fluid"]
    main, startup = fluid.Program(), fluid.Program()
    with pkg["unique"].guard(), fluid.program_guard(main, startup):
        a = fluid.layers.data("a", [3, 4], dtype="float32")
        b = fluid.layers.data("b", [5, 6], dtype="float32")
        return _raises(lambda: fluid.layers.matmul(a, b))


def _case_infer_fills_undeclared_shapes(pkg):
    fluid = pkg["fluid"]
    main, startup = fluid.Program(), fluid.Program()
    with pkg["unique"].guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4], dtype="float32")
        out = fluid.layers.mul(x, fluid.layers.data("w", [4, 8], dtype="float32",
                                                    append_batch_size=False))
        s = fluid.layers.reduce_sum(out, dim=1, keep_dim=True)
    return tuple(out.shape), tuple(s.shape), out.dtype


def _case_reshape_element_count_mismatch(pkg):
    fluid = pkg["fluid"]
    main, startup = fluid.Program(), fluid.Program()
    with pkg["unique"].guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4], dtype="float32", append_batch_size=False)
        return _raises(lambda: fluid.layers.reshape(x, [3]))


def _case_dtype_kind_mismatch(pkg):
    fluid = pkg["fluid"]
    main, startup = fluid.Program(), fluid.Program()
    with pkg["unique"].guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4], dtype="float32")
        bad = main.global_block().create_var("bad", shape=(-1, 4), dtype="int32")
        return _raises(lambda: main.global_block().append_op(
            "relu", inputs={"X": [x]}, outputs={"Out": [bad]}))


def _case_verify_shapes_after_a_rewrite(pkg):
    main, startup, x, y, z = _relu_chain(pkg)
    main.global_block().var(y.name).shape = (7, 9)
    return _codes(pkg["analysis"].verify_shapes(main))


def _case_donation_hazard(pkg):
    main = pkg["fluid"].Program()
    blk = main.global_block()
    blk.create_var("state", shape=(1,), dtype="float32", persistable=True)
    blk.create_var("out", shape=(1,), dtype="float32")
    blk.append_op("increment", inputs={"X": ["state"]}, outputs={"Out": ["state"]},
                  attrs={"step": 1.0})
    blk.append_op("scale", inputs={"X": ["state"]}, outputs={"Out": ["out"]},
                  attrs={"scale": 2.0})
    return _codes(pkg["analysis"].lint_donation(main))


def _case_recompile_hazard(pkg):
    fluid = pkg["fluid"]
    out = []
    for lod in (0, 1):
        main, startup = fluid.Program(), fluid.Program()
        with pkg["unique"].guard(), fluid.program_guard(main, startup):
            if lod:
                fluid.layers.data("seq", [3], dtype="float32", lod_level=1)
            else:
                fluid.layers.data("img", [-1, 3], dtype="float32")
        out.append(_codes(pkg["analysis"].lint_recompile(main)))
    return out


def _case_determinism_lint(pkg):
    fluid = pkg["fluid"]
    main, startup = fluid.Program(), fluid.Program()
    with pkg["unique"].guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4], dtype="float32")
        fluid.layers.dropout(x, 0.5)
        fluid.layers.uniform_random([2, 3])
    first = _codes(pkg["analysis"].lint_determinism(main))
    main.random_seed = 7
    return first, _codes(pkg["analysis"].lint_determinism(main))


def _case_seeded_pass_miscompile(pkg):
    fluid, passes = pkg["fluid"], pkg["passes"]

    @passes.register_pass("_test_seeded_miscompile")
    def _break(program):
        del program.global_block().ops[0]
        program._bump()

    try:
        main, startup, x, y, z = _relu_chain(pkg)
        with _flag(fluid, "FLAGS_verify_program", "off"):
            passes.apply_pass(main, "_test_seeded_miscompile")
            exe = fluid.Executor(fluid.CPUPlace())
            off = _raises(lambda: exe.run(main, feed={"x": np.ones((1, 4), "f4")},
                                          fetch_list=[z.name], scope=fluid.Scope()))
        main2, _, x2, y2, z2 = _relu_chain(pkg)
        with _flag(fluid, "FLAGS_verify_program", "full"):
            try:
                passes.PassBuilder(["_test_seeded_miscompile"]).apply(main2)
                full = None
            except pkg["analysis"].PassVerificationError as e:
                full = (e.pass_name, _codes(e.diagnostics), y2.name in str(e))
        return off, full
    finally:
        passes._PASS_REGISTRY.pop("_test_seeded_miscompile", None)


def _case_executor_verifies_a_broken_program(pkg):
    fluid = pkg["fluid"]
    main, startup, x, y, z = _relu_chain(pkg)
    main.global_block().ops[0].inputs["X"] = ["ghost"]
    exe = fluid.Executor(fluid.CPUPlace())
    return _raises(lambda: exe.run(main, feed={"x": np.ones((1, 4), "f4")},
                                   fetch_list=[z.name], scope=fluid.Scope()))


def _case_while_sub_block_attr(pkg):
    fluid = pkg["fluid"]
    main = fluid.Program()
    blk = main.global_block()
    cond = blk.create_var("cond", shape=(1,), dtype="bool")
    return _raises(lambda: blk.append_op("while", inputs={"Condition": [cond]},
                                         attrs={"sub_block": 5}))


def _case_pass_builder_verifies_under_flag(pkg):
    fluid, passes = pkg["fluid"], pkg["passes"]

    @passes.register_pass("_test_clobber_input")
    def _clobber(program):
        program.global_block().ops[-1].inputs["X"] = ["never_defined"]
        program._bump()

    try:
        main, startup = fluid.Program(), fluid.Program()
        with pkg["unique"].guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [4], dtype="float32")
            fluid.layers.scale(x, scale=2.0)
        return _raises(lambda: passes.PassBuilder(["_test_clobber_input"]).apply(main))
    finally:
        passes._PASS_REGISTRY.pop("_test_clobber_input", None)


def _case_full_level_on_the_zoo(pkg):
    out = []
    for name, main, _, _ in _zoo(pkg):
        out.append((name, _codes(pkg["analysis"].verify_program(main, level="full"))))
    return out


ANALYSIS_CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_use_before_def, _case_dangling_var, _case_unregistered_op, _case_orphan_sub_block,
    _case_duplicate_param_write, _case_fetch_target_missing_at_executor,
    _case_feed_target_unknown, _case_elementwise_shape_mismatch,
    _case_matmul_contraction_mismatch, _case_infer_fills_undeclared_shapes,
    _case_reshape_element_count_mismatch, _case_dtype_kind_mismatch,
    _case_verify_shapes_after_a_rewrite, _case_donation_hazard, _case_recompile_hazard,
    _case_determinism_lint, _case_seeded_pass_miscompile,
    _case_executor_verifies_a_broken_program, _case_while_sub_block_attr,
    _case_pass_builder_verifies_under_flag, _case_full_level_on_the_zoo)}


@pytest.mark.parametrize("case", sorted(ANALYSIS_CASES))
def test_verifier_and_inference_match_jax(case):
    """The same diagnostics (code, severity, op, var, block) and the same
    error classes in both packages."""
    got = _both(ANALYSIS_CASES[case])
    assert got["torch"] == got["jax"]
    assert got["torch"] not in (None, [], ())


def test_errors_are_fatal_and_counted():
    main, _, x, y, z = _relu_chain(PKGS["torch"])
    main.global_block().ops[0].inputs["X"] = ["ghost"]
    with pytest.raises(t_analysis.ProgramVerificationError) as ei:
        t_analysis.check_program(main)
    assert isinstance(ei.value, tfluid.errors.FatalError) and ei.value.phase == "build"
    tfluid.monitor.enable()
    tfluid.monitor.reset()
    try:
        t_analysis.verify_program(main)
        counts = tfluid.monitor.MONITOR.counter_values()
        assert counts["analysis.verify_runs"] == 1 and counts["analysis.diag.dangling_var"] == 1
        _relu_chain(PKGS["torch"])
        assert tfluid.monitor.MONITOR.counter_values()["analysis.infer_checks"] == 2
    finally:
        tfluid.monitor.disable()
        tfluid.monitor.reset()


def test_a_plans_later_runs_do_not_verify():
    fluid = tfluid
    main, startup, x, y, z = _relu_chain(PKGS["torch"])
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    fluid.monitor.enable()
    fluid.monitor.reset()
    try:
        for _ in range(3):
            exe.run(main, feed={"x": np.ones((1, 4), "f4")}, fetch_list=[z], scope=scope)
        stats = fluid.monitor.MONITOR.span_stats()
        assert stats["analysis.verify"]["calls"] == 1
        assert fluid.monitor.MONITOR.counter_values()["analysis.verify_runs"] == 1
    finally:
        fluid.monitor.disable()
        fluid.monitor.reset()


# --- the three passes ----------------------------------------------------------

def _pass_program(pkg):
    fluid = pkg["fluid"]
    main, startup = fluid.Program(), fluid.Program()
    with pkg["unique"].guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4], dtype="float32")
        kept = fluid.layers.assign(x)
        a = fluid.layers.assign(x)
        b = fluid.layers.scale(a, scale=1.0, bias=0.0)
        c = fluid.layers.scale(b, scale=2.0, bias=1.0)
        d = fluid.layers.scale(c, scale=3.0, bias=0.5)
        fluid.layers.increment(c, value=10.0, in_place=True)
        e = fluid.layers.scale(c, scale=5.0)
        dead = fluid.layers.relu(x)
        out = fluid.layers.elementwise_add(d, e)
    return main, startup, {"kept": kept.name, "out": out.name, "dead": dead.name}


PASS_RUNS = {
    "remove_identity_ops": lambda names: dict(keep=[names["kept"]]),
    "fold_scale_chains": lambda names: {},
    "prune_dead_ops": lambda names: dict(targets=[names["out"], names["kept"]]),
}


@pytest.mark.parametrize("pass_name", sorted(PASS_RUNS))
def test_pass_rewrites_like_the_jax_pass_and_keeps_the_numbers(pass_name):
    xv = np.random.RandomState(0).rand(3, 4).astype("f4")

    def run(pkg):
        fluid = pkg["fluid"]
        main, startup, names = _pass_program(pkg)
        exe = fluid.Executor(fluid.CPUPlace())
        fetch = [names["kept"], names["out"]]
        before = exe.run(main, feed={"x": xv}, fetch_list=fetch, scope=fluid.Scope())
        n_before = len(main.global_block().ops)
        pkg["passes"].apply_pass(main, pass_name, **PASS_RUNS[pass_name](names))
        after = exe.run(main, feed={"x": xv}, fetch_list=fetch, scope=fluid.Scope())
        return main.to_dict(), n_before, before, after

    got = _both(run)
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][0]["blocks"][0]["ops"] != [] and got["torch"][1] == got["jax"][1]
    for (tb, ta), (jb, ja) in zip(zip(got["torch"][2], got["torch"][3]),
                                  zip(got["jax"][2], got["jax"][3])):
        np.testing.assert_allclose(ta, tb, rtol=1e-6)
        np.testing.assert_allclose(ta, ja, rtol=1e-6)
    if pass_name != "fold_scale_chains":  # the fold keeps the bypassed op
        assert len(got["torch"][0]["blocks"][0]["ops"]) < got["torch"][1]


def test_pass_builder_order_and_prune_needs_targets():
    for pkg in PKGS.values():
        pb = pkg["passes"].PassBuilder()
        pb.append_pass("remove_identity_ops").append_pass("fold_scale_chains")
        pb.append_pass("prune_dead_ops")
        pb.remove_pass("prune_dead_ops")
        assert pb.all_passes() == ["remove_identity_ops", "fold_scale_chains"]
        with pytest.raises(ValueError, match="targets"):
            pkg["passes"].apply_pass(_pass_program(pkg)[0], "prune_dead_ops")


# --- the zoo: the port's own builds against the JAX package's -------------------

ZOO = ("mnist", "resnet50", "bert", "bert_clip_decay", "nmt", "deepfm")


def _zoo(pkg, only=None):
    """[(name, main, startup, loss name)]: tools/donation_audit.py build_zoo's
    tiny configurations, built with the package's own layers, plus the tiny
    BERT with L2Decay(0.01) and GradientClipByGlobalNorm(1.0)."""
    fluid = pkg["fluid"]
    models = __import__(fluid.__name__ + ".models", fromlist=["mnist"])
    from importlib import import_module

    def mod(name):
        return import_module(f"{models.__name__}.{name}")

    out = []
    for name in ZOO:
        if only is not None and name != only:
            continue
        with pkg["unique"].guard():
            if name == "mnist":
                main, startup, _, f = mod("mnist").build(learning_rate=1e-3)
            elif name == "resnet50":
                main, startup, _, f = mod("resnet").build(
                    depth=50, class_dim=10, image_shape=(3, 32, 32), with_optimizer=True)
            elif name == "bert":
                main, startup, _, f = mod("transformer").build_bert(
                    with_optimizer=True, vocab_size=200, seq_len=16, d_model=32, n_layers=2,
                    n_heads=2, d_ff=64)
            elif name == "bert_clip_decay":
                main, startup, _, f = mod("transformer").build_bert(
                    with_optimizer=False, vocab_size=200, seq_len=16, d_model=32, n_layers=2,
                    n_heads=2, d_ff=64, dtype="bfloat16", use_fused_attention=True)
                with fluid.program_guard(main, startup):
                    fluid.clip.set_gradient_clip(fluid.clip.GradientClipByGlobalNorm(1.0))
                    fluid.optimizer.Adam(1e-4, regularization=fluid.regularizer.L2Decay(0.01)
                                         ).minimize(f["loss"])
            elif name == "nmt":
                main, startup, _, f = mod("nmt").build_transformer_nmt(
                    dropout=0.1, learning_rate=2.0, src_vocab=80, tgt_vocab=80, d_model=32,
                    n_layers=1, n_heads=2, d_ff=64)
            else:
                main, startup, _, f = mod("deepfm").build(
                    learning_rate=0.05, num_fields=4, vocab_size=50, embed_dim=4, mlp_dims=(8,))
        out.append((name, main, startup, f["loss"].name))
    return out


@pytest.mark.parametrize("name", ZOO)
def test_port_builds_the_zoo_like_the_jax_package(name):
    """The port's own build equals the JAX package's, `to_dict` for
    `to_dict`: ops, attrs and every var with its shape and dtype, main and
    startup.  No difference is left."""
    got = _both(lambda pkg: [(p.to_dict()) for p in _zoo(pkg, name)[0][1:3]])
    for t, j in zip(got["torch"], got["jax"]):
        assert t == j
    if name == "bert_clip_decay":
        types = [op["type"] for op in got["torch"][0]["blocks"][0]["ops"]]
        n_params = types.count("adam")
        assert types.count("square") == types.count("reduce_sum") == n_params
        assert types.count("sqrt") == 1 and types.count("elementwise_max") == 1
        assert types.count("scale") >= n_params and types.count("sum") == n_params + 1


def test_zoo_infer_coverage():
    """Every op type of the zoo's programs that has a rule in the JAX
    package has one in the port."""
    for pkg in PKGS.values():
        pkg["cov"] = pkg["analysis"].infer_coverage([m for _, m, _, _ in _zoo(pkg)])
    assert PKGS["torch"]["cov"]["missing_types"] == PKGS["jax"]["cov"]["missing_types"]
    assert PKGS["torch"]["cov"]["frac"] == PKGS["jax"]["cov"]["frac"] >= 0.8


# --- the layers PR 11 ported: the same op, attrs and output var as the JAX package

LAYERS = {
    "fill_constant": lambda L, x, y, ids: L.fill_constant([2, 3], "float32", 0.5),
    "gaussian_random": lambda L, x, y, ids: L.gaussian_random([2, 3], mean=0.5, std=2.0, seed=3),
    "uniform_random": lambda L, x, y, ids: L.uniform_random([4], min=-2.0, max=2.0),
    "relu": lambda L, x, y, ids: L.relu(x),
    "gelu": lambda L, x, y, ids: L.gelu(x),
    "mul": lambda L, x, y, ids: L.mul(x, L.fill_constant([4, 5], "float32", 1.0)),
    "elementwise_mul": lambda L, x, y, ids: L.elementwise_mul(x, y),
    "elementwise_sub": lambda L, x, y, ids: L.elementwise_sub(x, y, axis=1),
    "sums": lambda L, x, y, ids: L.sums([x, x, x]),
    "sqrt": lambda L, x, y, ids: L.sqrt(x),
    "sign": lambda L, x, y, ids: L.sign(x),
    "elementwise_max": lambda L, x, y, ids: L.elementwise_max(x, y),
    "clip": lambda L, x, y, ids: L.clip(x, -0.5, 0.5),
    "clip_by_norm": lambda L, x, y, ids: L.clip_by_norm(x, 1.0),
    "square_error_cost": lambda L, x, y, ids: L.square_error_cost(x, x),
    "cross_entropy": lambda L, x, y, ids: L.cross_entropy(L.softmax(x), ids),
}


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_layer_builds_like_the_jax_package(layer):
    """The layer appends the same op with the same attrs and output var
    (name, shape, dtype) in both packages, and its output's values agree
    (random layers by shape only)."""
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(3, 4).astype("f4") + 0.1, "y": rng.rand(4).astype("f4"),
            "ids": rng.randint(0, 4, (3, 1)).astype(np.int64)}

    def run(pkg):
        fluid = pkg["fluid"]
        main, startup = fluid.Program(), fluid.Program()
        with pkg["unique"].guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [4])
            y = fluid.layers.data("y", [4], append_batch_size=False)
            ids = fluid.layers.data("ids", [1], dtype="int64")
            out = LAYERS[layer](fluid.layers, x, y, ids)
        (val,) = fluid.Executor(fluid.CPUPlace()).run(main, feed=feed, fetch_list=[out],
                                                      scope=fluid.Scope())
        return main.to_dict(), out.name, val

    got = _both(run)
    assert got["torch"][0] == got["jax"][0] and got["torch"][1] == got["jax"][1]
    t, j = np.asarray(got["torch"][2]), np.asarray(got["jax"][2])
    assert t.shape == j.shape and t.dtype == j.dtype
    if "random" not in layer:
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


def test_param_attr_regularizer_wins_and_clip_param_list_limits_the_clip():
    """A parameter's ParamAttr(regularizer=) replaces the optimizer's, and
    set_gradient_clip(param_list=) clips only the listed parameters: the
    same program in both packages."""
    def build(pkg):
        fluid = pkg["fluid"]
        main, startup = fluid.Program(), fluid.Program()
        with pkg["unique"].guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [4])
            h = fluid.layers.fc(x, 3, param_attr=fluid.ParamAttr(
                name="w_l1", regularizer=fluid.regularizer.L1Decay(0.1)))
            loss = fluid.layers.mean(fluid.layers.fc(h, 1, param_attr=fluid.ParamAttr(name="w2")))
            fluid.clip.set_gradient_clip(fluid.clip.GradientClipByValue(0.1), param_list=["w2"])
            fluid.optimizer.SGD(0.1, regularization=fluid.regularizer.L2Decay(0.5)).minimize(loss)
        return main

    progs = _both(lambda pkg: build(pkg).to_dict())
    assert progs["torch"] == progs["jax"]
    ops = progs["torch"]["blocks"][0]["ops"]
    sign_in = [op["inputs"]["X"] for op in ops if op["type"] == "sign"]
    clip_in = [op["inputs"]["X"] for op in ops if op["type"] == "clip"]
    assert sign_in == [["w_l1"]] and clip_in == [["w2@GRAD"]]
    # w_l1: its own L1Decay(0.1) on sign(w_l1); w2 and the biases: the optimizer's L2Decay(0.5)
    assert sorted(op["attrs"]["scale"] for op in ops if op["type"] == "scale") == [0.1, 0.5, 0.5, 0.5]


@pytest.mark.parametrize("keyword", ["initializer", "error_clip"])
def test_create_var_and_parameter_keep_initializer_and_error_clip(keyword):
    """ROADMAP C4: `Block.create_var` and `create_parameter` take
    `initializer=` and `error_clip=` and keep them as attributes, as the
    JAX package does; the programs' `to_dict` agree."""
    def build(pkg):
        fluid = pkg["fluid"]
        value = {"initializer": fluid.initializer.ConstantInitializer(0.5),
                 "error_clip": fluid.clip.ErrorClipByValue(1.0)}[keyword]
        main = fluid.Program()
        block = main.global_block()
        v = block.create_var(name="v", shape=[2, 3], dtype="float32", **{keyword: value})
        p = block.create_parameter("p", [3], "float32", **{keyword: value})
        assert getattr(v, keyword) is value and getattr(p, keyword) is value
        other = {"initializer": "error_clip", "error_clip": "initializer"}[keyword]
        assert getattr(v, other) is None and getattr(p, other) is None
        return main.to_dict()

    progs = _both(build)
    assert progs["torch"] == progs["jax"]


# --- checkpoints across the packages -------------------------------------------

def _fit_a_line(pkg, seed=0, lr=0.05):
    """The fit-a-line program of the verify skill: fc(13 -> 1), square error
    cost, SGD."""
    fluid = pkg["fluid"]
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with pkg["unique"].guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [13])
        y = fluid.layers.data("y", [1])
        loss = fluid.layers.mean(fluid.layers.square_error_cost(fluid.layers.fc(x, 1), y))
        fluid.optimizer.SGD(lr).minimize(loss)
    return main, startup, loss


def _line_batch(rng):
    xv = rng.rand(32, 13).astype("f4")
    return {"x": xv, "y": xv.sum(1, keepdims=True)}


def test_fit_a_line_trains_alike_in_both_packages():
    """50 SGD steps from the JAX package's initial weights: the loss falls
    and the two packages agree within 1e-5 at every step."""
    built = {n: _fit_a_line(p) for n, p in PKGS.items()}
    assert built["torch"][0].to_dict() == built["jax"][0].to_dict()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(built["jax"][1], scope=jscope)
    tscope = tfluid.Scope()
    tfluid.io.load_numpy_params(tscope, {v.name: np.asarray(jscope.find_var(v.name))
                                         for v in built["jax"][0].list_vars() if v.persistable})
    texe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(0)
    losses = {"jax": [], "torch": []}
    for _ in range(50):
        feed = _line_batch(rng)
        losses["jax"].append(float(jexe.run(built["jax"][0], feed=feed,
                                            fetch_list=[built["jax"][2]], scope=jscope)[0][0]))
        losses["torch"].append(float(texe.run(built["torch"][0], feed=feed,
                                              fetch_list=[built["torch"][2]],
                                              scope=tscope)[0][0]))
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5, atol=1e-5)
    assert np.mean(losses["torch"][-5:]) < 0.1 * np.mean(losses["torch"][:5])


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_checkpoint_saved_by_one_package_resumes_in_the_other(tmp_path, saver):
    """Two steps in the saving package, save_persistables, load_persistables
    in the other, one more step in each from there: the loaded state is the
    saved one bit for bit, and the next step agrees (losses and every
    persistable within 1e-6)."""
    loader = "torch" if saver == "jax" else "jax"
    rng = np.random.RandomState(3)
    feeds = [_line_batch(rng) for _ in range(3)]
    built = {n: _fit_a_line(p) for n, p in PKGS.items()}
    sf = PKGS[saver]["fluid"]
    smain, sstart, sloss = built[saver]
    sexe = sf.Executor(sf.CPUPlace())
    sscope = sf.Scope()
    sexe.run(sstart, scope=sscope)
    for feed in feeds[:2]:
        sexe.run(smain, feed=feed, fetch_list=[sloss], scope=sscope)
    sf.io.save_persistables(sexe, str(tmp_path), smain, sscope)
    lf = PKGS[loader]["fluid"]
    lmain, _, lloss = built[loader]
    lexe = lf.Executor(lf.CPUPlace())
    lscope = lf.Scope()
    loaded = lf.io.load_persistables(lexe, str(tmp_path), lmain, lscope)
    names = sorted(v.name for v in smain.list_vars() if v.persistable)
    assert sorted(loaded) == names
    for n in names:
        np.testing.assert_array_equal(np.asarray(lscope.find_var(n)),
                                      np.asarray(sscope.find_var(n)))
    s_out = sexe.run(smain, feed=feeds[2], fetch_list=[sloss], scope=sscope)[0]
    l_out = lexe.run(lmain, feed=feeds[2], fetch_list=[lloss], scope=lscope)[0]
    np.testing.assert_allclose(l_out, s_out, rtol=1e-6)
    for n in names:
        np.testing.assert_allclose(np.asarray(lscope.find_var(n)),
                                   np.asarray(sscope.find_var(n)), rtol=1e-6, atol=1e-7)


def test_save_and_load_params_carry_parameters_only(tmp_path):
    main, startup, loss = _fit_a_line(PKGS["torch"])
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    saved = tfluid.io.save_params(exe, str(tmp_path), main, scope)
    assert sorted(e["name"] for e in saved) == sorted(p.name for p in main.all_parameters())
    back = tfluid.Scope()
    tfluid.io.load_params(exe, str(tmp_path), main, back)
    for p in main.all_parameters():
        assert torch.equal(back.find_var(p.name), scope.find_var(p.name))
        assert back.find_var(p.name).device == exe.place.device
    with pytest.raises(KeyError, match="lacks"):
        tfluid.io.load_persistables(exe, str(tmp_path), main, tfluid.Scope())


def test_load_persistables_defaults_to_the_card(tmp_path, monkeypatch):
    main, startup, loss = _fit_a_line(PKGS["torch"])
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.io.save_persistables(exe, str(tmp_path), main, scope)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.io.load_persistables(None, str(tmp_path), main, tfluid.Scope())


def _dygraph_guard_place():
    """The place a `dygraph.guard()` without one runs on."""
    with tfluid.dygraph.guard():
        return SimpleNamespace(device=tfluid.dygraph.base.current_device())


@pytest.mark.parametrize("entry", ["Executor", "AnalysisConfig", "profile_program",
                                   "dygraph.guard"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Without a place, the entry points take CUDAPlace(0): on a machine with
    a card that is cuda:0, and without one they raise rather than fall back
    to the CPU."""
    main, _, _ = _fit_a_line(PKGS["torch"])
    make = {"Executor": lambda: tfluid.Executor().place,
            "AnalysisConfig": lambda: tfluid.inference.AnalysisConfig("model_dir").place,
            "profile_program": lambda: tfluid.profiler.profile_program(main, {}),
            "dygraph.guard": _dygraph_guard_place}[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    if entry != "profile_program":  # which would then run on the card
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert make().device == torch.device("cuda:0")


# --- what the port still lacks, pinned so that no later change loses a name ----

def test_registered_ops_the_port_lacks():
    """The JAX package's registered ops that have no lowering in the port.
    The count is an upper bound: a later slice lowers it, none raises it."""
    from paddle_tpu.core import registry as j_registry
    from paddle_tpu_torch.core import registry as t_registry

    jax_ops = set(j_registry.registered_ops())
    port_ops = set(t_registry.registered_ops())
    assert port_ops <= jax_ops, sorted(port_ops - jax_ops)
    missing = sorted(jax_ops - port_ops)
    assert len(missing) <= 2, missing  # of 305
    assert set(missing) <= {"pipeline", "ring_attention"}, missing
    assert {"sum", "sqrt", "sign", "elementwise_max", "clip", "clip_by_norm",
            "square_error_cost", "cross_entropy", "while", "lamb", "lars_momentum",
            "dynamic_rnn", "conditional_block", "array_write", "linear_chain_crf",
            "prior_box", "multiclass_nms", "ssd_loss", "yolov3_loss", "yolo_box",
            "detection_map", "generate_mask_labels", "deformable_psroi_pooling",
            "nearest_interp", "bilinear_interp", "depthwise_conv2d", "conv2d_transpose",
            "group_norm", "auc", "deformable_conv_v1", "print", "py_func"} <= port_ops


def _spec_names():
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "API.spec")) as f:
        return sorted({line.split(" ", 1)[0] for line in f if line.startswith("paddle_tpu.")})


def _resolves(dotted):
    obj = tfluid
    for part in dotted.split(".")[1:]:
        try:
            obj = getattr(obj, part)
        except AttributeError:
            return False
    return True


def test_public_names_of_the_api_spec_the_port_lacks():
    """API.spec's public names (read, never edited) that `paddle_tpu_torch`
    does not export under the same path.  The count is an upper bound."""
    names = _spec_names()
    missing = [n for n in names if not _resolves(n)]
    assert len(missing) <= 35, len(missing)  # of 1232
    # data parallelism and the gang (ROADMAP A10.1): nothing of parallel.*
    # but the model-parallel shard_parameters, of launch.* or of errors.*
    assert [n for n in missing if n.startswith(("paddle_tpu.parallel.", "paddle_tpu.launch.",
                                                "paddle_tpu.errors."))] == [
        "paddle_tpu.parallel.shard_parameters"]
    a101 = [n for n in names if n.startswith(("paddle_tpu.launch.", "paddle_tpu.errors.",
                                              "paddle_tpu.ParallelExecutor",
                                              "paddle_tpu.ExecutionStrategy"))
            or n in ("paddle_tpu.core.analysis.collective_signature",
                     "paddle_tpu.core.analysis.lint_collective_order",
                     "paddle_tpu.BuildStrategy.ReduceStrategy")]
    assert len(a101) >= 30 and [n for n in a101 if n in missing] == [], a101
    a96 = [n for n in names if n.startswith("paddle_tpu.core.resource_plan.")
           or n.startswith("paddle_tpu.DistributeTranspiler")
           or n in ("paddle_tpu.memory_optimize", "paddle_tpu.release_memory")]
    assert len(a96) >= 28 and [n for n in a96 if n in missing] == [], a96
    assert [n for n in missing if n.startswith("paddle_tpu.dygraph.")] == []
    assert [n for n in missing if n.startswith("paddle_tpu.param_server.")] == []
    assert [n for n in missing if n.startswith("paddle_tpu.layers.")] == [
        "paddle_tpu.layers.ring_attention"]
    for n in ("paddle_tpu.layers.square_error_cost", "paddle_tpu.layers.sums",
              "paddle_tpu.io.save_persistables", "paddle_tpu.io.load_persistables",
              "paddle_tpu.layers.clip", "paddle_tpu.layers.cross_entropy",
              "paddle_tpu.core.analysis.check_program",
              "paddle_tpu.CheckpointManager", "paddle_tpu.dataset.QueueDataset",
              "paddle_tpu.faults.FaultInjector", "paddle_tpu.integrity.StateDigester",
              "paddle_tpu.layers.concat", "paddle_tpu.layers.dynamic_lstm",
              "paddle_tpu.layers.reduce_mean", "paddle_tpu.nets.glu",
              "paddle_tpu.profiler.profiler", "paddle_tpu.profiler.cuda_profiler",
              "paddle_tpu.monitor.dump_blackbox", "paddle_tpu.optimizer.Lamb",
              "paddle_tpu.optimizer.LarsMomentum", "paddle_tpu.optimizer.ModelAverage",
              "paddle_tpu.layers.DynamicRNN",
              "paddle_tpu.layers.cond", "paddle_tpu.layers.cosine_decay",
              "paddle_tpu.layers.linear_lr_warmup", "paddle_tpu.LoDTensorArray",
              "paddle_tpu.layers.multi_box_head", "paddle_tpu.layers.detection_output",
              "paddle_tpu.layers.ssd_loss", "paddle_tpu.layers.yolov3_loss",
              "paddle_tpu.layers.resize_nearest", "paddle_tpu.layers.Print"):
        assert n in names and _resolves(n), n

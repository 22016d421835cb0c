"""The port's static resource planner and cost model
(paddle_tpu_torch/core/resource_plan.py) against the JAX package's on the
CPU: the tiny zoo's programs, built in the JAX package and carried over by
`Program.to_dict` / `from_dict`, plan row for row alike (op type, FLOPs,
bytes, grad factor, coverage) with equal totals and peaks; the roofline
follows from the rows and the port's chip model; the op types with a cost
rule are the JAX package's; and each case of tests/test_resource_plan.py
(the liveness defects, the cost model, the executor's pre-check, the
serving budget) gives the same plan, error and counters in both packages
under the same flags."""
import contextlib
import json
import os
import sys
from importlib import import_module
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu_torch.core import unique_name as t_unique

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

F4 = 4  # float32 bytes


def _pkg(fluid, unique):
    name = fluid.__name__
    return SimpleNamespace(
        fluid=fluid, unique=unique, layers=fluid.layers,
        rp=import_module(f"{name}.core.resource_plan"),
        registry=import_module(f"{name}.core.registry"),
        Operator=import_module(f"{name}.core.program").Operator,
        errors=fluid.errors, monitor=fluid.monitor, serving=fluid.serving)


PKGS = {"jax": _pkg(jfluid, j_unique), "torch": _pkg(tfluid, t_unique)}


def _both(fn):
    """fn(P) in each package, built under a fresh unique-name guard; the two
    results must be equal.  Returns the port's."""
    got = {}
    for name, P in PKGS.items():
        with P.unique.guard():
            got[name] = fn(P)
    assert got["torch"] == got["jax"], got
    return got["torch"]


@contextlib.contextmanager
def _flags(P, **values):
    old = P.fluid.get_flags(list(values))
    P.fluid.set_flags(values)
    try:
        yield
    finally:
        P.fluid.set_flags(old)


@pytest.fixture
def monitors():
    for P in PKGS.values():
        P.monitor.reset()
        P.monitor.enable()
    yield
    for P in PKGS.values():
        P.monitor.disable()
        P.monitor.reset()


def _rows(plan):
    return [(r.op_idx, r.op_type, r.flops, r.traffic_bytes, r.grad_factor, r.live_bytes,
             r.cost_covered) for r in plan.rows]


def _summary(plan):
    return {"rows": _rows(plan), "flops_total": plan.flops_total,
            "traffic_bytes_total": plan.traffic_bytes_total, "peak_bytes": plan.peak_bytes,
            "persistable_bytes": plan.persistable_bytes, "feed_bytes": plan.feed_bytes,
            "peak_temp_bytes": plan.peak_temp_bytes,
            "peak_op": (plan.peak_op_idx, plan.peak_op_type),
            "watermark": plan.watermark_ops(),
            "cost_coverage_frac": plan.cost_coverage_frac,
            "cost_missing_types": plan.cost_missing_types}


# --------------------------------------------------------------------------
# the tiny zoo, built once in the JAX package
# --------------------------------------------------------------------------

ZOO = ("mnist", "resnet50", "bert", "nmt", "deepfm", "bert_fused_bf16")


def _jax_zoo_program(name):
    """(program dict, feed shapes, fetch names) of a tiny zoo program built
    by the JAX package (tools/donation_audit.py build_zoo), or its BERT
    with bf16 fused attention."""
    if name == "bert_fused_bf16":
        from paddle_tpu.models import transformer

        with j_unique.guard():
            main, _, _, f = transformer.build_bert(
                with_optimizer=True, vocab_size=200, seq_len=16, d_model=32, n_layers=2,
                n_heads=2, d_ff=64, dtype="bfloat16", use_fused_attention=True)
        feed = dict(transformer.make_fake_batch(2, 16, 200, rng=np.random.RandomState(0)))
        fetches = [f["loss"].name]
    else:
        from tools.donation_audit import build_zoo

        with j_unique.guard():
            ((_, main, _, feed, fetches),) = build_zoo(tiny=True, only=name)
    return main.to_dict(), {n: tuple(np.shape(v)) for n, v in feed.items()}, list(fetches)


@pytest.mark.parametrize("name", ZOO)
def test_zoo_plans_equal_row_for_row(name):
    d, shapes, fetches = _jax_zoo_program(name)
    plans = {}
    for pkg, P in PKGS.items():
        program = P.fluid.Program.from_dict(json.loads(json.dumps(d)))
        plans[pkg] = P.rp.plan_program(program, shapes, fetches)
    jp, tp = plans["jax"], plans["torch"]
    assert _summary(tp) == _summary(jp)
    assert tp.cost_coverage_frac == 1.0 and tp.cost_missing_types == []
    assert tp.flops_total > 0 and tp.peak_bytes > 0
    # the roofline from the port's rows and the port's chip model
    rp = PKGS["torch"].rp
    roof = sum(max(r.flops * r.grad_factor / rp.CHIP_PEAK_FLOPS,
                   r.traffic_bytes * r.grad_factor / rp.CHIP_HBM_BANDWIDTH) for r in tp.rows)
    assert tp.roofline_step_s == pytest.approx(roof, rel=1e-12)
    assert tp.predicted_mfu == pytest.approx(
        tp.flops_total / (roof * rp.CHIP_PEAK_FLOPS), rel=1e-12)
    assert json.loads(json.dumps(tp.to_dict()))["flops_total"] == tp.flops_total


def test_chip_model_is_the_h100s():
    rp = PKGS["torch"].rp
    assert (rp.CHIP_PEAK_FLOPS, rp.CHIP_HBM_BANDWIDTH, rp.CHIP_HBM_BYTES) == (
        989e12, 3.35e12, 80e9)


def test_cost_rules_cover_the_jax_packages_op_types():
    def costed(P):
        return {t for t in P.registry.registered_ops()
                if P.registry.get_op_def(t).cost is not None}

    jax_types, port_types = costed(PKGS["jax"]), costed(PKGS["torch"])
    assert port_types == jax_types - {"ring_attention"}
    # the rules are the JAX package's: each type's rule prices a probe op alike
    assert len(port_types) == 156


def test_reregistration_keeps_the_cost_rule():
    reg = PKGS["torch"].registry
    d = reg.get_op_def("relu")
    rule, lower = d.cost, d.lower
    try:
        reg.register_op("relu")(lower)
        assert reg.get_op_def("relu").cost is rule
    finally:
        reg.get_op_def("relu").cost = rule
    with pytest.raises(KeyError):
        reg.set_cost("no_such_op", rule)


@pytest.mark.parametrize("name", ["mnist", "nmt"])
def test_cost_coverage_equal(name):
    d, _, _ = _jax_zoo_program(name)

    def case(P):
        return P.rp.cost_coverage([P.fluid.Program.from_dict(json.loads(json.dumps(d)))])

    got = _both(case)
    assert got["frac"] == 1.0 and got["missing_types"] == []


# --------------------------------------------------------------------------
# tests/test_resource_plan.py's cases, in both packages
# --------------------------------------------------------------------------

def test_leaked_live_range_names_consumer_and_def_op():
    def case(P):
        L = P.layers
        main, startup = P.fluid.Program(), P.fluid.Program()
        with P.fluid.program_guard(main, startup):
            x = L.data("x", [256, 256], dtype="float32")
            y = L.relu(x)
            z = L.relu(y)
            w = L.relu(z)
        feed = {"x": (4, 256, 256)}
        base = P.rp.plan_program(main, feed, [w.name])
        blk = main.global_block()
        blk.ops.append(P.Operator(blk, "elementwise_add", {"X": [w.name], "Y": [y.name]},
                                  {"Out": [blk.create_var(name="leak_out", shape=[-1, 256, 256],
                                                          dtype="float32").name]}))
        leaked = P.rp.plan_program(main, feed, ["leak_out"])
        ent = next(e for e in leaked.watermark if e["var"] == y.name)
        return (_summary(base), _summary(leaked), leaked.peak_bytes > base.peak_bytes,
                (ent["def_op_type"], ent["def_op_idx"]))

    got = _both(case)
    assert got[2] and got[3] == ("relu", 0)


def _param_program(P, writes):
    main = P.fluid.Program()
    blk = main.global_block()
    for n in ("w", "w2"):
        blk.create_parameter(n, shape=[512, 512], dtype="float32")
    blk.ops.append(P.Operator(blk, "scale", {"X": ["w"]}, {"Out": ["w"]}, {"scale": 1.1}))
    if writes:
        blk.ops.append(P.Operator(blk, "assign", {"X": ["w"]}, {"Out": ["w2"]}))
    return main


@pytest.mark.parametrize("writes", [False, True], ids=["donated_once", "copied_not_read"])
def test_inplace_update_and_double_buffer(writes):
    got = _both(lambda P: _summary(P.rp.plan_program(_param_program(P, writes))))
    W = 512 * 512 * F4
    assert got["persistable_bytes"] == 2 * W
    if writes:
        assert got["peak_bytes"] == 3 * W and got["peak_op"][1] == "assign"
    else:
        assert got["peak_bytes"] == 2 * W and got["peak_temp_bytes"] == 0


def _loop_program(P, body_big, backward):
    L = P.layers
    main, startup = P.fluid.Program(), P.fluid.Program()
    with P.fluid.program_guard(main, startup):
        x = L.data("x", [16], dtype="float32")
        y = L.relu(x)
    sub = main.create_block()
    if body_big:
        sub.create_var(name="sub_big", shape=[1024, 1024], dtype="float32")
        sub.create_var(name="sub_out", shape=[1024, 1024], dtype="float32")
        sub.ops.append(P.Operator(sub, "fill_constant", {}, {"Out": ["sub_big"]},
                                  {"shape": [1024, 1024], "value": 0.0, "dtype": "float32"}))
        sub.ops.append(P.Operator(sub, "relu", {"X": ["sub_big"]}, {"Out": ["sub_out"]}))
    else:
        sub.create_var(name="body_out", shape=[-1, 16], dtype="float32")
        sub.ops.append(P.Operator(sub, "relu", {"X": [y.name]}, {"Out": ["body_out"]}))
    main.rollback()
    blk = main.global_block()
    blk.create_var(name="loop_out", shape=[-1, 16], dtype="float32")
    blk.ops.append(P.Operator(blk, "while", {"X": [y.name]}, {"Out": ["loop_out"]},
                              {"sub_block": sub.idx}))
    if backward:
        blk.create_var(name="loss", shape=[1], dtype="float32")
        blk.ops.append(P.Operator(blk, "mean", {"X": ["loop_out"]}, {"Out": ["loss"]}))
        blk.ops.append(P.Operator(blk, "backward", {"Loss": ["loss"]}, {"Grads": []},
                                  {"loss_name": "loss", "param_names": [],
                                   "grad_names": []}))
        return P.rp.plan_program(main, {"x": (4, 16)}, ["loss"])
    blk.ops.append(P.Operator(blk, "relu", {"X": [y.name]},
                              {"Out": [blk.create_var(name="after", shape=[-1, 16],
                                                      dtype="float32").name]}))
    return P.rp.plan_program(main, {"x": (4, 16)}, ["after"])


def test_sub_block_peak_charged_to_owner_and_does_not_escape():
    got = _both(lambda P: _summary(_loop_program(P, body_big=True, backward=False)))
    MB4 = 1024 * 1024 * F4
    assert got["peak_op"][1] == "while" and got["peak_temp_bytes"] >= 2 * MB4
    assert any(w.startswith("sub_big") for w in got["watermark"])
    assert [r for r in got["rows"] if r[1] == "relu"][-1][5] < MB4


def test_sub_block_body_rows_inherit_owner_grad_factor():
    got = _both(lambda P: _summary(_loop_program(P, body_big=False, backward=True)))
    relu_rows = [r for r in got["rows"] if r[1] == "relu"]
    assert len(relu_rows) == 2 and all(r[4] == 3 for r in relu_rows)
    assert next(r for r in got["rows"] if r[1] == "while")[4] == 3


def test_persistable_written_late_is_resident_not_a_temp():
    def case(P):
        L = P.layers
        main, startup = P.fluid.Program(), P.fluid.Program()
        with P.fluid.program_guard(main, startup):
            x = L.data("x", [8], dtype="float32")
            y = L.relu(x)
        blk = main.global_block()
        blk.create_parameter("acc", shape=[1024, 256], dtype="float32")
        blk.ops.append(P.Operator(blk, "scale", {"X": ["acc"]}, {"Out": ["acc"]},
                                  {"scale": 0.9}))
        return _summary(P.rp.plan_program(main, {"x": (4, 8)}, [y.name]))

    got = _both(case)
    ACC = 1024 * 256 * F4
    assert got["persistable_bytes"] == ACC
    assert all(r[5] < ACC for r in got["rows"])


def _trained_fc(P, width, out, batch):
    L = P.layers
    main, startup = P.fluid.Program(), P.fluid.Program()
    with P.fluid.program_guard(main, startup):
        x = L.data("x", [width], dtype="float32")
        h = L.fc(x, width, act="relu") if out > 1 else x
        loss = L.mean(L.fc(h, out))
        P.fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return P.rp.plan_program(main, {"x": (batch, width)}, [loss.name])


def test_backward_extends_activations_and_defines_grads():
    got = _both(lambda P: _summary(_trained_fc(P, 64, 64, 8)))
    assert got["peak_op"][1] == "backward"
    assert any("@GRAD" in w for w in got["watermark"])


def test_grad_factor_3x_ahead_of_backward():
    got = _both(lambda P: _summary(_trained_fc(P, 16, 1, 2)))
    assert next(r for r in got["rows"] if r[1] == "mul")[4] == 3
    assert next(r for r in got["rows"] if r[1] == "sgd")[4] == 1


def test_matmul_cost_is_2mkn_and_coverage_complete():
    def case(P):
        L = P.layers
        main, startup = P.fluid.Program(), P.fluid.Program()
        with P.fluid.program_guard(main, startup):
            x = L.data("x", [32, 64], dtype="float32")
            y = L.fc(x, 128)
        return _summary(P.rp.plan_program(main, {"x": (4, 32, 64)}, [y.name]))

    got = _both(case)
    assert next(r for r in got["rows"] if r[1] == "mul")[2] == 2 * (4 * 32) * 64 * 128
    assert got["cost_coverage_frac"] == 1.0 and all(r[6] for r in got["rows"])


def test_plan_serialized_program_roundtrip():
    def case(P):
        L = P.layers
        main, startup = P.fluid.Program(), P.fluid.Program()
        with P.fluid.program_guard(main, startup):
            x = L.data("x", [4], dtype="float32")
            y = L.relu(x)
        clone = P.fluid.Program.parse_from_string(main.to_string())
        d = json.loads(json.dumps(P.rp.plan_program(clone, {"x": (2, 4)}, [y.name]).to_dict()))
        # the roofline and the MFU follow each package's own chip model
        return {k: v for k, v in d.items() if k not in ("roofline_step_s", "predicted_mfu")}

    got = _both(case)
    assert set(got) >= {"flops_total", "traffic_bytes_total", "cost_coverage_frac",
                        "cost_missing_types", "peak_bytes"}


# --- the executor's pre-check -------------------------------------------------

def _fc_relu(P, width):
    L = P.layers
    main, startup = P.fluid.Program(), P.fluid.Program()
    with P.fluid.program_guard(main, startup):
        x = L.data("x", [width], dtype="float32")
        y = L.fc(x, width, act="relu") if width > 8 else L.relu(x)
    exe = P.fluid.Executor(P.fluid.CPUPlace())
    scope = P.fluid.Scope()
    with _flags(P, FLAGS_resource_precheck="off"):
        exe.run(startup, scope=scope)
    return main, exe, scope, y


def test_over_budget_raises_resource_error_before_anything_runs(monitors):
    def case(P):
        main, exe, scope, y = _fc_relu(P, 256)
        c = P.monitor.counter
        miss0, rec0 = c("executor.cache_miss").value, c("executor.recompile").value
        cached0 = len(exe._cache)  # the startup's plan
        with _flags(P, FLAGS_resource_hbm_limit_mb=0.01):
            with pytest.raises(P.errors.ResourceError) as ei:
                exe.run(main, feed={"x": np.ones((4, 256), "f4")}, fetch_list=[y.name],
                        scope=scope)
        e = ei.value
        assert P.errors.classify(e) is e
        return {"class": type(e).__name__, "phase": e.phase, "needed": e.needed_bytes,
                "limit": e.limit_bytes, "watermark_ops": e.watermark_ops,
                "cache_miss": c("executor.cache_miss").value - miss0,
                "recompile": c("executor.recompile").value - rec0,
                "prechecks": c("analysis.resource_prechecks").value,
                "blocked": c("analysis.resource_blocked").value,
                "cached": len(exe._cache) - cached0}

    got = _both(case)
    assert got["needed"] > got["limit"] == 10000 and got["watermark_ops"]
    assert (got["cache_miss"], got["blocked"], got["cached"]) == (0, 1, 0)


@pytest.mark.parametrize("flags", [{"FLAGS_resource_hbm_limit_mb": 64.0},
                                   {"FLAGS_resource_precheck": "off",
                                    "FLAGS_resource_hbm_limit_mb": 0.0001}],
                         ids=["honest_limit", "off_flag"])
def test_precheck_passes_or_is_off(flags, monitors):
    def case(P):
        main, exe, scope, y = _fc_relu(P, 8)
        with _flags(P, **flags):
            out = exe.run(main, feed={"x": np.ones((2, 8), "f4")}, fetch_list=[y.name],
                          scope=scope)
        c = P.monitor.counter
        return (np.asarray(out[0]).tolist(), c("analysis.resource_prechecks").value,
                c("analysis.resource_blocked").value, c("executor.cache_miss").value)

    got = _both(case)
    assert np.allclose(got[0], 1.0) and got[2] == 0
    assert got[1] == (1 if flags.get("FLAGS_resource_precheck") != "off" else 0)


def test_precheck_without_a_limit_plans_nothing(monitors):
    """The CPU has no limit (XLA:CPU exposes none, the CPU device neither):
    with no flag the pre-check returns None and counts nothing."""
    def case(P):
        main, exe, scope, y = _fc_relu(P, 8)
        exe.run(main, feed={"x": np.ones((2, 8), "f4")}, fetch_list=[y.name], scope=scope)
        return P.monitor.counter("analysis.resource_prechecks").value

    assert _both(case) == 0
    assert PKGS["torch"].rp.device_hbm_limit("cpu") is None


def test_precheck_program_direct_and_device_limit():
    def case(P):
        main, _, _, y = _fc_relu(P, 256)
        plan = P.rp.precheck_program(main, {"x": (4, 256)}, [y.name], limit_bytes=10 ** 12)
        with pytest.raises(P.errors.ResourceError) as ei:
            P.rp.precheck_program(main, {"x": (4, 256)}, [y.name], limit_bytes=1000)
        with _flags(P, FLAGS_resource_hbm_limit_mb=2.5):
            flag_limit = P.rp.device_hbm_limit(None)
        return plan.peak_bytes, ei.value.needed_bytes, ei.value.limit_bytes, flag_limit

    got = _both(case)
    assert got[0] == got[1] and got[2] == 1000 and got[3] == 2500000


# --- the serving budget on plan bytes ----------------------------------------

def _save_serving_model(P, dirname, d_in=64, d_out=64):
    L = P.layers
    main, startup = P.fluid.Program(), P.fluid.Program()
    with P.fluid.program_guard(main, startup):
        x = L.data("x", [d_in], dtype="float32")
        out = L.fc(x, d_out, act="relu")
    exe = P.fluid.Executor(P.fluid.CPUPlace())
    scope = P.fluid.Scope()
    exe.run(startup, scope=scope)
    P.fluid.io.save_inference_model(dirname, ["x"], [out], exe, main, scope)
    return dirname


def test_plan_model_bytes_counts_activations_past_manifest(tmp_path):
    def case(P):
        d = _save_serving_model(P, str(tmp_path / P.fluid.__name__))
        return (P.serving.manifest_weight_bytes(d), P.serving.plan_model_bytes(d, 64),
                P.serving.plan_model_bytes(d, 256))

    manifest, plan64, plan256 = _both(case)
    assert 0 < manifest < plan64 < plan256


def test_serving_budget_refuses_on_plan_bytes_with_warm_buckets(tmp_path):
    def case(P):
        d = _save_serving_model(P, str(tmp_path / P.fluid.__name__))
        manifest = P.serving.manifest_weight_bytes(d)
        plan = P.serving.plan_model_bytes(d, 64)
        budget_mb = (manifest + (plan - manifest) * 0.5) / 1e6
        reg = P.serving.ModelRegistry(place=P.fluid.CPUPlace(), hbm_budget_mb=budget_mb)
        with pytest.raises(P.errors.ServingError) as ei:
            reg.load("m", d, warm_buckets=(64,))
        reg2 = P.serving.ModelRegistry(place=P.fluid.CPUPlace(), hbm_budget_mb=budget_mb)
        reg2.load("m", d)
        return ei.value.reason, sorted(reg2.models())

    assert _both(case) == ("hbm_budget", ["m"])


def test_unbudgeted_load_is_counted_and_evented(tmp_path, monitors):
    def case(P):
        d = _save_serving_model(P, str(tmp_path / P.fluid.__name__))
        path = os.path.join(d, P.fluid.io.MANIFEST)
        with open(path) as f:
            man = json.load(f)
        man["vars"] = []
        with open(path, "w") as f:
            json.dump(man, f)
        reg = P.serving.ModelRegistry(place=P.fluid.CPUPlace(), hbm_budget_mb=1.0)
        before = P.monitor.counter("serving.unbudgeted_loads").value
        reg.load("m", d)
        evs = [r for r in P.monitor.step_records()
               if r.get("kind") == "serving_event" and r.get("action") == "unbudgeted_load"]
        return (P.monitor.counter("serving.unbudgeted_loads").value - before,
                [e["model"] for e in evs])

    assert _both(case) == (1, ["m"])


# --- the CLI -------------------------------------------------------------------

def test_port_resource_plan_check_and_smoke():
    from tools import port_resource_plan as tool

    text, results = tool.render(tiny=True)
    assert results["_coverage"]["frac"] == 1.0
    assert tool.main(["--check", "--program", "mnist"]) == 0
    assert tool.main(["--check", "--program", "mnist", "--min-coverage", "1.01"]) == 1
    assert tool.main(["--check", "--program", "no_such_model"]) == 1

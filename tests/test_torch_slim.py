"""contrib.slim and int8 models (paddle_tpu_torch.contrib.slim,
io.save_quantized_inference_model) against the JAX package on the CPU.

Programs are built by the JAX package and shipped to the port through
`to_dict` / `from_dict` with the JAX package's startup state; each rewrite
(`quant_aware`, `convert_quant_model`) runs on each package's own copy and
must give the same program.  Weights are snapped to the int8 grid in numpy
in both packages, so scales, snapped weights and the saved int8 files are
compared bit for byte; float fetches within float32 rounding, training
steps within the port's float32 training tolerance (1e-5 of the tensor's
largest, at least 1e-5)."""
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.contrib import slim as jslim
from paddle_tpu.contrib.slim.quantization import convert_quant_model as j_convert
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu_torch.contrib import slim as tslim
from paddle_tpu_torch.contrib.slim.quantization import convert_quant_model as t_convert
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.ops import cuda_kernels as ck

PKGS = {"jax": (jfluid, jslim, j_convert), "torch": (tfluid, tslim, t_convert)}
TRAIN_TOL = 1e-5


@pytest.fixture(autouse=True)
def launches_unchanged():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before, "a CPU run must not count a kernel launch"


# --- the nets (the JAX package's test nets) -----------------------------------

def _conv_net(fluid):
    """tests/test_quantized_inference.py's net: conv 3x3 relu, pool, fc softmax."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [3, 8, 8], dtype="float32")
        c = layers.conv2d(x, num_filters=8, filter_size=3, padding=1, act="relu")
        p = layers.pool2d(c, pool_size=2, pool_stride=2)
        flat = layers.reshape(p, [-1, 8 * 4 * 4])
        out = layers.fc(flat, 10, act="softmax")
    return main, startup, out


def _shared_net(fluid):
    """Two fcs share a weight, two fcs share an activation, one matmul."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [6], dtype="float32")
        h = layers.fc(x, 6, param_attr=fluid.ParamAttr(name="shared.w"), bias_attr=False)
        h2 = layers.fc(h, 6, param_attr=fluid.ParamAttr(name="shared.w"), bias_attr=False)
        a = layers.fc(h2, 4, act="relu")
        b = layers.fc(h2, 4)
        out = layers.matmul(a, b, transpose_y=True)
    return main, startup, out


def _qat_net(fluid):
    """tests/test_slim_depth.py:123's channel-wise QAT net (Adam 0.01)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [1, 8, 8], dtype="float32")
        y = layers.data("y", [1], dtype="int64")
        c = layers.conv2d(x, 8, 3, padding=1, act="relu", param_attr=fluid.ParamAttr(name="qw"))
        logits = layers.fc(c, 4)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


def _prune_net(fluid):
    """tests/test_slim_depth.py's fc net for prune-retrain (Adam 0.01)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [16], dtype="float32")
        y = layers.data("y", [1], dtype="int64")
        h = layers.fc(x, 32, act="relu", param_attr=fluid.ParamAttr(name="fc1_w"))
        logits = layers.fc(h, 4, param_attr=fluid.ParamAttr(name="fc2_w"))
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


def _distill_net(fluid):
    """tests/test_slim_depth.py's teacher and student, trained on the three
    distillation losses, the teacher frozen; returns (main, startup,
    [total, l2, fsp, soft])."""
    layers = fluid.layers
    slim = PKGS["jax" if fluid is jfluid else "torch"][1]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [1, 8, 8], dtype="float32")
        t1 = layers.conv2d(x, 4, 3, padding=1, act="relu", param_attr=fluid.ParamAttr(name="t1w"))
        t2 = layers.conv2d(t1, 4, 3, padding=1, param_attr=fluid.ParamAttr(name="t2w"))
        t_logits = layers.fc(t2, 4, param_attr=fluid.ParamAttr(name="t3w"))
        s1 = layers.conv2d(x, 4, 3, padding=1, act="relu", param_attr=fluid.ParamAttr(name="s1w"))
        s2 = layers.conv2d(s1, 4, 3, padding=1, param_attr=fluid.ParamAttr(name="s2w"))
        s_logits = layers.fc(s2, 4, param_attr=fluid.ParamAttr(name="s3w"))
        l2 = slim.L2Distiller(s2, t2).distiller_loss()
        fsp = slim.FSPDistiller([(s1, s2)], [(t1, t2)]).distiller_loss()
        soft = slim.SoftLabelDistiller(s_logits, t_logits, student_temperature=1.0,
                                       teacher_temperature=2.0).distiller_loss()
        total = l2 + fsp + soft
        student = [main.global_block().var(n) for n in ("s1w", "s2w", "s3w")]
        fluid.optimizer.Adam(0.01).minimize(total, parameter_list=student)
    return main, startup, [total, l2, fsp, soft]


def _built(build, seed=3):
    """The JAX package's build and startup state, and each package's copy of
    the main program by to_dict / from_dict: (programs, fetch var or vars,
    state)."""
    with j_unique.guard():
        main, startup, fetch = build(jfluid)
    startup.random_seed = seed
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    state = {v.name: np.asarray(scope.find_var(v.name)).copy()
             for v in main.list_vars() if v.persistable}
    doc = main.to_dict()
    return ({"jax": jfluid.Program.from_dict(doc), "torch": tfluid.Program.from_dict(doc)},
            fetch, state)


def _scopes(state, dtypes=None):
    """A scope of each package holding `state` (weights cast to `dtypes`)."""
    dtypes = dtypes or {}
    js, ts = jfluid.Scope(), tfluid.Scope()
    for n, v in state.items():
        v = v.astype(dtypes[n]) if n in dtypes else v
        js.set_var(n, v)
    tfluid.io.load_numpy_params(ts, {n: js.find_var(n) for n in state})
    return {"jax": js, "torch": ts}


def _host(pkg, scope, name):
    v = scope.find_var(name)
    return scope.to_numpy(name).copy() if pkg == "torch" else np.asarray(v).copy()


def _bits_equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


def _names(fetch):
    return [f.name for f in (fetch if isinstance(fetch, list) else [fetch])]


# --- quant_aware ----------------------------------------------------------------

QUANT_AWARE = {
    "abs_max": (_conv_net, {}),
    "channel_wise": (_conv_net, {"weight_quantize_type": "channel_wise_abs_max"}),
    "weights_only_4bit": (_conv_net, {"quantize_activations": False, "weight_bits": 4}),
    "shared": (_shared_net, {}),
    "shared_channel_wise": (_shared_net, {"weight_quantize_type": "channel_wise_abs_max",
                                          "activation_bits": 6}),
    "only_mul": (_shared_net, {"quantizable_op_types": ["mul"]}),
    "after_minimize": (_qat_net, {"weight_quantize_type": "channel_wise_abs_max"}),
}


@pytest.mark.parametrize("case", list(QUANT_AWARE))
def test_quant_aware_rewrites_the_program_as_the_jax_package(case):
    """The same inserted ops, names, attrs, order and count, and the same
    declared shapes and dtypes of the @QUANT / @QSCALE vars."""
    build, kw = QUANT_AWARE[case]
    progs, _, _ = _built(build)
    counts = {p: PKGS[p][1].quant_aware(progs[p], **kw) for p in PKGS}
    assert counts["torch"] == counts["jax"] > 0
    assert progs["torch"].to_dict() == progs["jax"].to_dict()
    types = [op.type for op in progs["torch"].global_block().ops]
    if case.startswith("shared"):
        # one op for the shared weight, one for the shared activation
        assert sum("shared.w" in op.input("X") for op in progs["torch"].global_block().ops
                   if op.type.startswith("fake_")) == 1
        assert types.count("fake_quantize_abs_max") + types.count(
            "fake_channel_wise_quantize_abs_max") == counts["torch"]
    if "channel" in case:
        assert "fake_channel_wise_quantize_abs_max" in types


def test_quant_aware_refuses_an_unknown_weight_quantize_type():
    for name, (fluid, slim, _) in PKGS.items():
        unique = j_unique if name == "jax" else t_unique
        with unique.guard():
            main, _, _ = _conv_net(fluid)
        with pytest.raises(ValueError, match="unknown weight_quantize_type 'range_abs_max'"):
            slim.quant_aware(main, weight_quantize_type="range_abs_max")


def test_a_qat_program_passes_the_verifier_in_both():
    """The fake-quantize rules are registered with slim: a QAT program's
    check_program is clean and its declared vars agree."""
    progs, _, _ = _built(_qat_net)
    for p, (fluid, slim, _) in PKGS.items():
        slim.quant_aware(progs[p], weight_quantize_type="channel_wise_abs_max")
        fluid.analysis.check_program(progs[p], level="full")
    tb, jb = progs["torch"].global_block(), progs["jax"].global_block()
    for n in ("qw@QUANT", "qw@QSCALE"):
        assert (tb.var(n).shape, tb.var(n).dtype) == (jb.var(n).shape, jb.var(n).dtype)


# --- post_training_quantize and convert_quant_model ---------------------------

def _weights(progs):
    return sorted(p.name for p in progs["jax"].all_parameters())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_post_training_quantize_snaps_as_the_jax_package(dtype):
    """The same per-tensor scales and bitwise-equal snapped weights; each
    weight goes back as a new tensor of its dtype on its device, the old
    tensor untouched."""
    progs, _, state = _built(_conv_net)
    cast = {n: ml_dtypes.bfloat16 for n in _weights(progs)} if dtype == "bfloat16" else {}
    scopes = _scopes(state, cast)
    old = {n: scopes["torch"].find_var(n) for n in state}
    old_bits = {n: scopes["torch"].to_numpy(n).copy() for n in state}
    scales = {p: PKGS[p][1].post_training_quantize(scopes[p], progs[p]) for p in PKGS}
    assert scales["torch"] == scales["jax"]
    assert set(scales["torch"]) == {"conv2d_0.w_0", "fc_0.w_0"}
    for n in state:
        _bits_equal(_host("torch", scopes["torch"], n), _host("jax", scopes["jax"], n), n)
        new = scopes["torch"].find_var(n)
        assert isinstance(new, torch.Tensor) and new.dtype == old[n].dtype
        assert new.device == old[n].device
        _bits_equal(old[n].view(torch.int16).numpy() if dtype == "bfloat16" and old[n].dtype
                    == torch.bfloat16 else old[n].numpy(),
                    old_bits[n].view(np.int16) if old_bits[n].dtype == ml_dtypes.bfloat16
                    else old_bits[n], f"{n} (the old tensor)")
        if n in scales["torch"]:
            assert new is not old[n]
            w = _host("torch", scopes["torch"], n).astype(np.float32)
            q = w / scales["torch"][n] * 127.0
            np.testing.assert_allclose(q, np.round(q), atol=1e-3 if dtype == "float32" else 0.5)


@pytest.mark.parametrize("qtype", ["abs_max", "channel_wise_abs_max"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_quant_model_freezes_as_the_jax_package(qtype, dtype):
    """The freeze strips the fake-quantize ops (the same program), returns
    the same scales, axes and activation bits, and snaps the weights to
    bitwise-equal values."""
    progs, _, state = _built(_conv_net)
    cast = {n: ml_dtypes.bfloat16 for n in _weights(progs)} if dtype == "bfloat16" else {}
    scopes = _scopes(state, cast)
    man = {}
    for p, (_, slim, convert) in PKGS.items():
        slim.quant_aware(progs[p], weight_quantize_type=qtype)
        man[p] = convert(progs[p], scopes[p])
    assert progs["torch"].to_dict() == progs["jax"].to_dict()
    assert not [op for op in progs["torch"].global_block().ops if op.type.startswith("fake_")]
    assert man["torch"]["activations"] == man["jax"]["activations"] != {}
    assert sorted(man["torch"]["weights"]) == sorted(man["jax"]["weights"]) == [
        "conv2d_0.w_0", "fc_0.w_0"]
    for n, rec in man["torch"]["weights"].items():
        want = man["jax"]["weights"][n]
        assert rec["axis"] == want["axis"] == (0 if qtype.startswith("channel") and "conv" in n
                                               else 1 if qtype.startswith("channel") else None)
        _bits_equal(rec["scale"], want["scale"], f"{n} scale")
    for n in state:
        _bits_equal(_host("torch", scopes["torch"], n), _host("jax", scopes["jax"], n), n)


def test_convert_without_fake_quant_ops_changes_nothing():
    progs, _, state = _built(_conv_net)
    scopes = _scopes(state)
    for p, (_, _, convert) in PKGS.items():
        assert convert(progs[p], scopes[p]) == {"weights": {}, "activations": {}}
    assert progs["torch"].to_dict() == progs["jax"].to_dict()


def _square_net(fluid):
    """tests/test_quantized_inference.py:141: a square 16 x 16 weight with
    channel-wise scales."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [16], dtype="float32")
        h = layers.fc(x, 16, param_attr=fluid.ParamAttr(name="sq.w"), bias_attr=False)
        out = layers.fc(h, 4, act="softmax")
    return main, startup, out


def test_square_channel_wise_weight_keeps_its_axis(tmp_path):
    """Per-column magnitudes 0.01-10: the freeze stores axis 1, the files are
    byte-identical, and each package's predictor serves the other's dir
    within 1e-3 of the instrumented run (the JAX test's bound)."""
    progs, out, state = _built(_square_net, seed=9)
    state["sq.w"] = (state["sq.w"] * np.geomspace(0.01, 10.0, 16)[None, :]).astype("f4")
    scopes = _scopes(state)
    xv = np.random.RandomState(1).rand(8, 16).astype("f4")
    ref, dirs = {}, {}
    for p, (fluid, slim, _) in PKGS.items():
        slim.quant_aware(progs[p], weight_bits=8, quantize_activations=False,
                         weight_quantize_type="channel_wise_abs_max")
        exe = fluid.Executor(fluid.CPUPlace())
        (ref[p],) = exe.run(progs[p], feed={"x": xv}, fetch_list=[out.name], scope=scopes[p])
        dirs[p] = str(tmp_path / p)
        fluid.io.save_quantized_inference_model(dirs[p], ["x"], [out.name], exe, progs[p],
                                                scopes[p])
    np.testing.assert_allclose(ref["torch"], np.asarray(ref["jax"]), rtol=0, atol=1e-6)
    _same_files(dirs["jax"], dirs["torch"])
    assert json.load(open(os.path.join(dirs["torch"], "__quant__.json")))["weights"]["sq.w"][
        "axis"] == 1
    for p, (fluid, _, _) in PKGS.items():
        for d in dirs.values():
            pred = fluid.inference.Predictor(fluid.inference.AnalysisConfig(d, place=fluid.CPUPlace()))
            (got,) = pred.run({"x": xv})
            np.testing.assert_allclose(np.asarray(got), np.asarray(ref[p]), rtol=0, atol=1e-3)


# --- save_quantized_inference_model and the load ------------------------------

def _same_files(a, b):
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    assert fa == fb, (fa, fb)
    for f in fa:
        with open(os.path.join(a, f), "rb") as x, open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f


SAVES = {
    "ptq_float32": (None, None, None),
    "ptq_bf16_serve": (None, "bfloat16", None),
    "ptq_bf16_weights": (None, None, "bfloat16"),
    "qat_channel_wise": ("channel_wise_abs_max", None, None),
    "qat_abs_max_bf16_serve": ("abs_max", "bfloat16", None),
    "qat_channel_wise_bf16_weights": ("channel_wise_abs_max", "bfloat16", "bfloat16"),
}


def _save_both(tmp_path, case, weight_bits=8):
    qtype, serve, wdtype = SAVES[case]
    progs, out, state = _built(_conv_net)
    cast = {n: ml_dtypes.bfloat16 for n in _weights(progs)} if wdtype else {}
    scopes = _scopes(state, cast)
    dirs = {}
    for p, (fluid, slim, _) in PKGS.items():
        if qtype:
            slim.quant_aware(progs[p], weight_quantize_type=qtype, quantize_activations=False)
        dirs[p] = str(tmp_path / p)
        fluid.io.save_quantized_inference_model(dirs[p], ["x"], [out.name],
                                                fluid.Executor(fluid.CPUPlace()), progs[p],
                                                scopes[p], weight_bits=weight_bits,
                                                serve_dtype=serve)
    return dirs, scopes, state, progs, out


@pytest.mark.parametrize("case", list(SAVES))
def test_quantized_dirs_are_byte_identical_and_load_across(tmp_path, case):
    """The two packages write the same files (int8 payloads, __quant__.json,
    the re-stamped manifest, the model); each loads the other's dir to
    bitwise-equal dequantized weights in the record's dtype, and the digests
    verify."""
    dirs, _, state, _, _ = _save_both(tmp_path, case)
    _same_files(dirs["jax"], dirs["torch"])
    qman = json.load(open(os.path.join(dirs["torch"], "__quant__.json")))
    assert sorted(qman["weights"]) == ["conv2d_0.w_0", "fc_0.w_0"]
    for n in qman["weights"]:
        assert np.load(os.path.join(dirs["torch"], n + ".npy")).dtype == np.int8
    loaded = {}
    for p, (fluid, _, _) in PKGS.items():
        for src, d in dirs.items():
            scope = fluid.Scope()
            fluid.io.load_vars(d, None, scope, verify=True)
            loaded[(p, src)] = {n: _host(p, scope, n) for n in state}
    for n in state:
        ref = loaded[("jax", "jax")][n]
        want = qman["weights"].get(n, {}).get("dtype")
        if want:
            assert str(ref.dtype) == want
        for key, got in loaded.items():
            if want:
                _bits_equal(got[n], ref, f"{n} {key}")
            else:  # the JAX package's load_vars leaves a bf16 payload as its uint16 bits
                assert got[n].tobytes() == ref.tobytes(), (n, key)


def test_a_four_bit_dir_is_byte_identical(tmp_path):
    dirs, _, _, _, _ = _save_both(tmp_path, "qat_channel_wise", weight_bits=4)
    _same_files(dirs["jax"], dirs["torch"])
    q = np.load(os.path.join(dirs["torch"], "conv2d_0.w_0.npy"))
    assert q.dtype == np.int8 and -8 <= q.min() and q.max() <= 7


@pytest.mark.parametrize("child", [False, True], ids=["own_scope", "child_of_parent"])
def test_a_quantized_save_leaves_the_scope_bit_identical(tmp_path, child):
    """The freeze snaps weights while saving; the scope is restored by
    reference afterwards.  Saved through a child scope whose parameters live
    in its parent, the child keeps no shadow and the parent is untouched."""
    progs, out, state = _built(_qat_net)
    for p, (fluid, slim, _) in PKGS.items():
        slim.quant_aware(progs[p], weight_quantize_type="channel_wise_abs_max")
        holder = _scopes(state)[p]
        scope = holder.new_scope() if child else holder
        before = {n: _host(p, scope, n) for n in state}
        local = sorted(scope.local_var_names())
        fluid.io.save_quantized_inference_model(str(tmp_path / p), ["x"], [out.name],
                                                fluid.Executor(fluid.CPUPlace()), progs[p],
                                                scope)
        assert sorted(scope.local_var_names()) == local
        for n, b in before.items():
            _bits_equal(_host(p, scope, n), b, f"{p} {n}")
    _same_files(str(tmp_path / "jax"), str(tmp_path / "torch"))


@pytest.mark.parametrize("tamper", ["flip", "truncate"])
def test_a_tampered_int8_payload_raises_the_same_integrity_error(tmp_path, tamper):
    dirs, _, _, _, _ = _save_both(tmp_path, "qat_channel_wise")
    classes = {}
    for p, (fluid, _, _) in PKGS.items():
        victim = os.path.join(dirs[p], "conv2d_0.w_0.npy")
        with open(victim, "r+b") as f:
            if tamper == "truncate":
                f.truncate(os.path.getsize(victim) - 4)
            else:
                f.seek(-1, os.SEEK_END)
                last = f.read(1)
                f.seek(-1, os.SEEK_END)
                f.write(bytes([last[0] ^ 1]))
        with pytest.raises(fluid.errors.IntegrityError) as ei:
            fluid.io.load_inference_model(dirs[p], fluid.Executor(fluid.CPUPlace()),
                                          scope=fluid.Scope(), verify=True)
        classes[p] = (type(ei.value).__name__, ei.value.file, ei.value.phase)
    assert classes["torch"] == classes["jax"]
    assert classes["torch"][1] == "conv2d_0.w_0.npy"


# --- predictors -----------------------------------------------------------------

@pytest.mark.parametrize("case", ["ptq_float32", "ptq_bf16_serve", "qat_channel_wise"])
def test_int8_predictor_serves_the_jax_packages_fetches(tmp_path, case):
    """The JAX package's int8 dir through each package's Predictor: the same
    fetches on the same feeds (the probabilities within float32 rounding,
    bf16 weights within a bf16 product's)."""
    dirs, _, _, _, _ = _save_both(tmp_path, case)
    xv = np.random.RandomState(0).rand(4, 3, 8, 8).astype("f4")
    got = {}
    for p, (fluid, _, _) in PKGS.items():
        pred = fluid.inference.create_predictor(
            fluid.inference.AnalysisConfig(dirs["jax"], place=fluid.CPUPlace()))
        (got[p],) = pred.run({"x": xv})
    np.testing.assert_allclose(np.asarray(got["torch"], np.float32),
                               np.asarray(got["jax"], np.float32), rtol=0,
                               atol=1e-6 if SAVES[case][1] is None else 2e-3)
    np.testing.assert_allclose(np.asarray(got["torch"], np.float32).sum(-1), 1.0, rtol=1e-2)


def test_qat_deploy_matches_the_instrumented_run(tmp_path):
    """tests/test_quantized_inference.py's weight-only QAT deploy: the
    deployed int8 model reproduces the instrumented program within 1e-3 in
    each package, and the two packages' instrumented runs agree."""
    progs, out, state = _built(_conv_net)
    scopes = _scopes(state)
    xv = np.random.RandomState(0).rand(4, 3, 8, 8).astype("f4")
    ref = {}
    for p, (fluid, slim, _) in PKGS.items():
        assert slim.quant_aware(progs[p], weight_bits=8, quantize_activations=False) == 2
        exe = fluid.Executor(fluid.CPUPlace())
        (ref[p],) = exe.run(progs[p], feed={"x": xv}, fetch_list=[out.name], scope=scopes[p])
        d = str(tmp_path / p)
        fluid.io.save_quantized_inference_model(d, ["x"], [out.name], exe, progs[p], scopes[p])
        (got,) = fluid.inference.Predictor(
            fluid.inference.AnalysisConfig(d, place=fluid.CPUPlace())).run({"x": xv})
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref[p]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(ref["torch"], np.asarray(ref["jax"]), rtol=0, atol=1e-6)


# --- QAT training ----------------------------------------------------------------

def _train(progs, fetch, state, feeds, after_step=None):
    """One run a feed in each package from `state`; returns the fetches by
    package and the final states."""
    scopes = _scopes(state)
    got = {p: [] for p in PKGS}
    for p, (fluid, _, _) in PKGS.items():
        exe = fluid.Executor(fluid.CPUPlace())
        for feed in feeds:
            outs = exe.run(progs[p], feed=feed, fetch_list=_names(fetch), scope=scopes[p])
            got[p].append([float(np.asarray(o, np.float32).reshape(-1)[0]) for o in outs])
            if after_step is not None:
                after_step(p, scopes[p])
    final = {p: {n: _host(p, scopes[p], n) for n in state} for p in PKGS}
    return got, final, scopes


def _hold_training(got, final):
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=TRAIN_TOL, atol=TRAIN_TOL)
    for n, want in final["jax"].items():
        have = final["torch"][n]
        assert have.dtype == want.dtype and have.shape == want.shape, n
        tol = TRAIN_TOL * max(1.0, float(np.abs(want.astype(np.float32)).max()))
        err = float(np.abs(have.astype(np.float64) - want.astype(np.float64)).max())
        assert err <= tol, (n, err, tol)


@pytest.mark.parametrize("qtype", ["channel_wise_abs_max", "abs_max"])
def test_qat_steps_match_the_jax_package(qtype):
    """tests/test_slim_depth.py:123's net instrumented after minimize: the
    fake-quantize ops sit in the forward region the backward differentiates
    (straight through); 4 Adam steps give the JAX package's losses and
    parameters, and the weight's fake-quantized value lies on its grid."""
    progs, loss, state = _built(_qat_net)
    for p in PKGS:
        PKGS[p][1].quant_aware(progs[p], weight_quantize_type=qtype)
    rng = np.random.RandomState(2)
    xs = rng.rand(8, 1, 8, 8).astype("f4")
    ys = rng.randint(0, 4, (8, 1)).astype("int64")
    feeds = [{"x": xs, "y": ys}] * 4
    got, final, scopes = _train(progs, loss, state, feeds)
    _hold_training(got, final)
    losses = [g[0] for g in got["torch"]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    exe = tfluid.Executor(tfluid.CPUPlace())
    qw, sc = exe.run(progs["torch"], feed=feeds[0], fetch_list=["qw@QUANT", "qw@QSCALE"],
                     scope=scopes["torch"])
    sc = sc.reshape((-1,) + (1,) * (qw.ndim - 1)) if qtype.startswith("channel") else sc
    q = qw / np.maximum(sc, 1e-8) * 127.0
    np.testing.assert_allclose(q, np.round(q), atol=1e-3)


# --- pruning ---------------------------------------------------------------------

def test_structure_pruner_selects_and_prunes_as_the_jax_package():
    w = np.random.RandomState(0).randn(6, 8).astype("f4")
    for axis, ratio in ((0, 0.5), (1, 0.25), (1, 0.5)):
        got = {}
        for p, (_, slim, _) in PKGS.items():
            pr = slim.StructurePruner(pruning_axis={"*": axis}, criterions={"*": "l1_norm"})
            idx = pr.cal_pruned_idx("w", w, ratio, axis=axis)
            got[p] = (idx.tolist(), pr.prune_tensor(w, idx, axis, lazy=True),
                      pr.prune_tensor(w, idx, axis, lazy=False))
        assert got["torch"][0] == got["jax"][0]
        for k in (1, 2):
            _bits_equal(got["torch"][k], got["jax"][k], f"axis {axis} ratio {ratio}")
    for p, (_, slim, _) in PKGS.items():
        with pytest.raises(ValueError, match="unsupported criterion 'l2_norm'"):
            slim.StructurePruner(criterions={"*": "l2_norm"}).cal_pruned_idx("w", w, 0.5)


def test_prune_retrain_matches_the_jax_package():
    """prune_parameters gives the same masks, pruned values and sparsity; 4
    retraining steps with apply_masks after each give the JAX package's
    losses and parameters, the pruned groups staying 0."""
    progs, loss, state = _built(_prune_net, seed=9)
    rng = np.random.RandomState(0)
    y = rng.randint(0, 4, (64, 1)).astype("int64")
    x = (rng.rand(64, 16) * 0.2).astype("f4")
    x[np.arange(64), y[:, 0] * 4] += 2.0
    scopes = _scopes(state)
    masks = {}
    for p, (_, slim, _) in PKGS.items():
        masks[p] = slim.prune_parameters(progs[p], scopes[p], ["fc1_w", "fc2_w"], [0.5, 0.25],
                                         slim.StructurePruner(pruning_axis={"*": 1}))
        assert abs(slim.sparsity(scopes[p], masks[p]) - (16 * 16 + 32) / (16 * 32 + 32 * 4)) \
            < 1e-12
        assert isinstance(scopes["torch"].find_var("fc1_w"), torch.Tensor) or p == "jax"
    for n in ("fc1_w", "fc2_w"):
        _bits_equal(masks["torch"][n], masks["jax"][n], f"{n} mask")
        _bits_equal(_host("torch", scopes["torch"], n), _host("jax", scopes["jax"], n), n)
    pruned = {n: _host("jax", scopes["jax"], n) for n in state}

    def reapply(p, scope):
        PKGS[p][1].apply_masks(scope, masks[p])

    got, final, _ = _train(progs, loss, pruned, [{"x": x, "y": y}] * 4, reapply)
    _hold_training(got, final)
    for n in ("fc1_w", "fc2_w"):
        assert (final["torch"][n][masks["torch"][n] == 0] == 0).all()


# --- distillation ----------------------------------------------------------------

def test_distillers_give_the_jax_packages_losses_and_steps():
    """The L2, FSP and soft-label losses of one program (built by each
    package, equal by to_dict), then 4 Adam steps of the student on their
    sum: the same losses and parameters, the teacher frozen."""
    with j_unique.guard():
        jm, js, jf = _distill_net(jfluid)
    with t_unique.guard():
        tm, _, _ = _distill_net(tfluid)
    assert tm.to_dict() == jm.to_dict()
    js.random_seed = 4
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(js, scope=scope)
    state = {v.name: np.asarray(scope.find_var(v.name)).copy()
             for v in jm.list_vars() if v.persistable}
    xs = np.random.RandomState(1).rand(16, 1, 8, 8).astype("f4")
    got, final, _ = _train({"jax": jm, "torch": tm}, jf, state, [{"x": xs}] * 4)
    _hold_training(got, final)
    assert all(v > 0 for v in got["torch"][0])
    assert got["torch"][-1][0] < got["torch"][0][0]
    for n in ("t1w", "t2w", "t3w"):
        _bits_equal(final["torch"][n], state[n], f"teacher {n}")

"""The serving slice end to end on the CPU: the tiny zoo BERT (vocab 200,
seq 16, d 32, 2 layers, 2 heads, d_ff 64, fused attention), saved by one
package and served by the other's Predictor, must give the same logits
(float32 atol 1e-4, bfloat16 5e-2).  Parameters come from a numpy seed."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.models import transformer as j_transformer
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.models import transformer as t_transformer
from paddle_tpu_torch.ops import cuda_kernels as ck

TINY = dict(vocab_size=200, seq_len=16, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            use_fused_attention=True, with_optimizer=False)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
PASSES = ("fuse_ln_residual", "fuse_bias_act")


def _logits_name(main):
    return next(op for op in main.global_block().ops
                if op.type == "softmax_with_cross_entropy").input("Logits")[0]


def _build(pkg, dtype, passes, **config):
    """(main, startup, logits) of the tiny BERT built by `pkg` ("jax"/"torch")."""
    unique, transformer, fluid = ((j_unique, j_transformer, jfluid) if pkg == "jax"
                                  else (t_unique, t_transformer, tfluid))
    with unique.guard():
        main, startup, _, _ = transformer.build_bert(dtype=dtype, **dict(TINY, **config))
    logits = _logits_name(main)
    if passes:
        for p in PASSES:
            fluid.core.passes.apply_pass(main, p) if pkg == "jax" else fluid.passes.apply_pass(main, p)
    return main, startup, logits


def _numpy_params(main, seed=0):
    """Seeded parameters of a realistic scale: LN gains near 1, the rest N(0, 0.05)."""
    rng = np.random.RandomState(seed)
    out = {}
    for p in sorted(main.all_parameters(), key=lambda v: v.name):
        if p.name.endswith(("emb_ln.w", ".ln1.w", ".ln2.w")):
            arr = 1.0 + 0.1 * rng.randn(*p.shape)
        else:
            arr = 0.05 * rng.randn(*p.shape)
        out[p.name] = arr.astype(np.float32)
    return out


def _batch(n=3, seed=0):
    return t_transformer.make_fake_batch(n, TINY["seq_len"], TINY["vocab_size"],
                                         rng=np.random.RandomState(seed))


def _save_with_jax(dirname, dtype, passes, **config):
    main, startup, logits = _build("jax", dtype, passes, **config)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    for name, arr in _numpy_params(main).items():
        scope.set_var(name, jnp.asarray(arr))
    jfluid.io.save_inference_model(dirname, ["ids", "pos_ids"], [logits], exe, main, scope)


def _save_with_torch(dirname, dtype, passes):
    main, startup, logits = _build("torch", dtype, passes)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.io.load_numpy_params(scope, _numpy_params(main))
    tfluid.io.save_inference_model(dirname, ["ids", "pos_ids"], [logits], exe, main, scope)


def _serve_both(dirname, feed):
    jp = jfluid.inference.create_predictor(jfluid.inference.AnalysisConfig(dirname, jfluid.CPUPlace()))
    tp = tfluid.inference.create_predictor(tfluid.inference.AnalysisConfig(dirname, tfluid.CPUPlace()))
    want = np.asarray(jp.run(feed)[0]).astype(np.float32)
    before = dict(ck.LAUNCHES)
    got = tp.run(feed)[0]
    assert ck.LAUNCHES == before  # the CPU serves through the plain versions
    return want, got


@pytest.mark.parametrize("passes", [True, False], ids=["passes", "no_passes"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_saved_model_served_by_port(tmp_path, dtype, passes):
    _save_with_jax(str(tmp_path), dtype, passes)
    want, got = _serve_both(str(tmp_path), _batch())
    assert got.shape == want.shape == (3 * 16, 200)
    assert np.isfinite(got).all()
    assert np.abs(want).max() > 0.1  # the comparison is not between near-zeros
    assert np.abs(got - want).max() <= TOL[dtype]


def test_unfused_attention_model_served_by_port(tmp_path):
    """matmul + softmax attention (use_fused_attention=False) through both."""
    _save_with_jax(str(tmp_path), "float32", True, use_fused_attention=False)
    want, got = _serve_both(str(tmp_path), _batch())
    assert np.abs(got - want).max() <= TOL["float32"]


def test_pass_builder_matches_the_jax_passes():
    main, _, _ = _build("torch", "float32", passes=False)
    tfluid.passes.PassBuilder(["fuse_ln_residual"]).append_pass("fuse_bias_act").apply(main)
    jm, _, _ = _build("jax", "float32", passes=True)
    assert main.to_dict()["blocks"][0]["ops"] == jm.to_dict()["blocks"][0]["ops"]
    with pytest.raises(KeyError, match="unknown pass"):
        tfluid.passes.PassBuilder().append_pass("fuse_everything")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_saved_model_served_by_jax(tmp_path, dtype):
    _save_with_torch(str(tmp_path), dtype, passes=True)
    want, got = _serve_both(str(tmp_path), _batch(seed=1))
    assert np.abs(got - want).max() <= TOL[dtype]


@pytest.mark.parametrize("passes", [True, False], ids=["passes", "no_passes"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_program_dict_round_trips(dtype, passes):
    main, startup, _ = _build("jax", dtype, passes)
    for prog in (main, startup):
        d = prog.to_dict()
        assert TProgram.from_dict(d).to_dict() == d


@pytest.mark.parametrize("passes", [True, False], ids=["passes", "no_passes"])
def test_builders_emit_the_same_ops(passes):
    jm, js, _ = _build("jax", "bfloat16", passes)
    tm, ts, _ = _build("torch", "bfloat16", passes)
    for a, b in ((jm, tm), (js, ts)):
        da, db = a.to_dict()["blocks"][0], b.to_dict()["blocks"][0]
        assert da["ops"] == db["ops"]
        # shapes of auxiliary outputs (XShape, LN Mean/Variance) come from the JAX
        # package's shape inference, which the port has not yet
        assert [(v["name"], v["dtype"], v["persistable"]) for v in da["vars"]] == \
               [(v["name"], v["dtype"], v["persistable"]) for v in db["vars"]]


def test_passes_fuse_every_layer_norm_and_gelu():
    main, _, logits = _build("torch", "float32", passes=True)
    from paddle_tpu_torch.core.executor import _prune, _runnable_ops

    ops = _prune(_runnable_ops(main.global_block()), [logits], set())
    census = {}
    for op in ops:
        census[op.type] = census.get(op.type, 0) + 1
    assert census["layer_norm"] == 5 and census["fused_attention"] == 2
    assert all(op.inputs.get("Residual") for op in ops if op.type == "layer_norm")
    assert sum(op.attrs.get("fuse_act") == "gelu" for op in ops) == 2
    assert "gelu" not in census


def test_load_numpy_params_round_trip():
    import ml_dtypes

    rng = np.random.RandomState(0)
    params = {"w": rng.randn(3, 4).astype(np.float32),
              "ids": rng.randint(0, 9, (5,)).astype(np.int64),
              "h": rng.randn(6).astype(ml_dtypes.bfloat16)}
    scope = tfluid.Scope()
    tfluid.io.load_numpy_params(scope, params)
    assert scope.find_var("h").dtype == torch.bfloat16
    for name, arr in params.items():
        np.testing.assert_array_equal(scope.to_numpy(name), arr.astype(scope.to_numpy(name).dtype))


def test_bf16_vars_keep_their_bits_on_disk(tmp_path):
    scope = tfluid.Scope()
    t = torch.randn(4, 5).to(torch.bfloat16)
    scope.set_var("a/b", t)
    saved = tfluid.io.save_vars(str(tmp_path), ["a/b"], scope)
    assert saved[0]["dtype"] == "bfloat16"
    back = tfluid.Scope()
    tfluid.io.load_vars(str(tmp_path), None, back)
    assert torch.equal(back.find_var("a/b"), t)


def test_corrupted_parameter_file_fails_the_load(tmp_path):
    _save_with_torch(str(tmp_path), "float32", passes=True)
    victim = os.path.join(str(tmp_path), "bert.lm_head.b.npy")
    with open(victim, "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(b"\x00\x00\x80\x7f")
    with pytest.raises(tfluid.io.IntegrityError, match="bert.lm_head.b.npy"):
        tfluid.inference.create_predictor(
            tfluid.inference.AnalysisConfig(str(tmp_path), tfluid.CPUPlace()))


def test_places_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.inference.AnalysisConfig(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.Executor()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cfg = tfluid.inference.AnalysisConfig(str(tmp_path))
    assert isinstance(cfg.place, tfluid.CUDAPlace)
    assert cfg.place.device == torch.device("cuda:0")
    assert tfluid.TPUPlace is tfluid.CUDAPlace
    with pytest.raises(RuntimeError, match="only 1"):
        tfluid.CUDAPlace(1)


def test_predictor_handles_clone_and_lock(tmp_path):
    _save_with_torch(str(tmp_path), "float32", passes=True)
    p = tfluid.inference.create_predictor(
        tfluid.inference.AnalysisConfig(str(tmp_path), tfluid.CPUPlace()))
    feed = _batch(2)
    want = p.run(feed)[0]
    c = p.clone()
    assert c.scope is p.scope and c.exe is p.exe and c.lock() is not p.lock()
    with c.lock():
        for name in c.get_input_names():
            c.get_input_handle(name).copy_from_cpu(feed[name])
        assert c.run_zero_copy()
        out = c.get_output_handle(c.get_output_names()[0])
        assert isinstance(out.value(), torch.Tensor)
        np.testing.assert_array_equal(out.copy_to_cpu(), want)
    with pytest.raises(KeyError, match="pos_ids"):
        p.run({"ids": feed["ids"]})


def test_missing_startup_state_is_named(tmp_path):
    main, _, logits = _build("torch", "float32", passes=False)
    with pytest.raises(KeyError, match="bert.tok_emb"):
        tfluid.Executor(tfluid.CPUPlace()).run(main, feed=_batch(1), fetch_list=[logits],
                                               scope=tfluid.Scope())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_builders_emit_the_same_ops(dtype):
    """build_bert(with_optimizer=True): the same op types, slots and attrs in
    both packages, the backward op and the Adam updates and their startup
    fill_constants included."""
    config = dict(TINY, with_optimizer=True, use_fused_attention=False)
    progs = []
    for unique, transformer in ((j_unique, j_transformer), (t_unique, t_transformer)):
        with unique.guard():
            main, startup, _, _ = transformer.build_bert(dtype=dtype, **config)
        progs.append((main, startup))
    (jm, js), (tm, ts) = progs
    for a, b in ((jm, tm), (js, ts)):
        assert a.to_dict()["blocks"][0]["ops"] == b.to_dict()["blocks"][0]["ops"]
    types = [op.type for op in tm.global_block().ops]
    assert types.count("backward") == 1 and types.count("adam") == len(tm.all_parameters())


def test_training_program_is_refused():
    """A training program the port cannot run is refused, naming what is
    missing: an is_sparse embedding's SelectedRows gradient into an update
    without a sparse branch (RMSProp), as the JAX package's register_opt
    refuses it.  Under Adam the same embedding trains (ROADMAP A5,
    tests/test_torch_sparse.py): its gradient is a SelectedRows; and the AMP
    decorator's FoundInf, refused here until contrib.mixed_precision was
    ported (ROADMAP A9.1), is applied: a step with it set keeps the state."""
    def build(make_opt):
        main, startup = TProgram(), TProgram()
        with t_unique.guard(), tfluid.program_guard(main, startup):
            ids = tfluid.layers.data("ids", [4], dtype="int64")
            emb = tfluid.layers.embedding(ids, [10, 3], is_sparse=True)
            loss = tfluid.layers.mean(emb)
            make_opt().minimize(loss)
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        return main, loss, exe, scope

    feed = {"ids": np.zeros((2, 4), np.int64)}
    main, loss, exe, scope = build(lambda: tfluid.optimizer.Adam(0.1))
    grad = next(n for n in main.global_block().ops[-1].input("Grad"))
    (sr,) = exe.run(main, feed=feed, fetch_list=[grad], scope=scope, return_numpy=False)
    assert type(sr).__name__ == "SelectedRows" and tuple(sr.values.shape) == (8, 3)
    main.global_block().create_var("found_inf", shape=(1,), dtype="bool", is_data=True)
    main.global_block().ops[-1].inputs["FoundInf"] = ["found_inf"]
    names = [v.name for v in main.list_vars() if v.persistable]
    before = {n: scope.to_numpy(n).copy() for n in names}
    exe.run(main, feed=dict(feed, found_inf=np.array([True])), fetch_list=[loss], scope=scope)
    for n in names:
        np.testing.assert_array_equal(scope.to_numpy(n), before[n], err_msg=n)
    main, loss, exe, scope = build(lambda: tfluid.optimizer.RMSProp(0.1))
    with pytest.raises(NotImplementedError, match="SelectedRows"):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)


def test_host_arrays_in_scope_are_moved_to_the_place():
    main, startup, logits = _build("torch", "float32", passes=True)
    main = main.clone(for_test=True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    params = _numpy_params(main)
    for name, arr in params.items():
        scope.set_var(name, arr)  # numpy, as a caller may set it
    got = exe.run(main, feed=_batch(1), fetch_list=[logits], scope=scope)[0]
    assert isinstance(scope.find_var("bert.tok_emb"), torch.Tensor)
    tfluid.io.load_numpy_params(scope, params)
    want = exe.run(main, feed=_batch(1), fetch_list=[logits], scope=scope)[0]
    np.testing.assert_array_equal(got, want)

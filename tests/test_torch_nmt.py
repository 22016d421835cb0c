"""Transformer NMT on the ragged (LoD) path, the port against the JAX package
on the CPU.

The fixed model is the tiny NMT of tests/test_nmt.py (vocab 64 / 80, d 32,
2 heads, d_ff 64, 2 + 2 layers, dropout 0) with the full configuration's
schedule: Adam(noam_decay(d_model, 400, 2.0), beta2 0.997, epsilon 1e-9),
built by both packages under their unique-name guards.  Parameters come
from a numpy seed, and the JAX package's whole persistable state after its
startup goes to the port through `io.load_numpy_params`.

Tolerances: logits at the valid positions 1e-5, the loss 1e-5 relative;
training by the scheme of tests/test_torch_training.py: losses 1e-4, the
moments 1e-4 of the largest of their kind, the beta pows and the step
counter 1e-4 of themselves, parameters 1e-5 save the elements whose JAX
gradient is 0 to rounding (1e-6 of the model's largest) at some step, which
keep 2 * lr * steps + 1e-5.  The noam schedule's first step has lr 0, so it
leaves every parameter bit for bit unchanged while the moments move.  Beam
decoding: ids equal, scores within 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu import lod as j_lod
from paddle_tpu.lod import LoDTensor as JLoDTensor
from paddle_tpu.models import nmt as j_nmt
from paddle_tpu_torch.lod import LoDTensor, bucket_length
from paddle_tpu_torch.models import nmt as t_nmt
from paddle_tpu_torch.ops import cuda_kernels as ck

TINY = dict(src_vocab=64, tgt_vocab=80, d_model=32, n_layers=2, n_heads=2, d_ff=64)
TRAIN = dict(TINY, dropout=0.0, warmup_steps=400, learning_rate=2.0)
PASSES = ("fuse_ln_residual", "fuse_bias_act")
STEPS = 3
LENGTHS = ([5, 9, 3, 7], [6, 4, 8, 2])
LOSS_TOL = 1e-4
STATE_RTOL = 1e-4
PARAM_TOL = 1e-5
ZERO_GRAD = 1e-6
DECODE = dict(batch_size=3, src_len=7, max_len=8, bos=1, eos=2)


@pytest.fixture(autouse=True)
def launches_unchanged():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before, "a CPU run must not count a kernel launch"


def _build(pkg, builder="build_transformer_nmt", passes=False, **config):
    """(main, startup, feeds, fetches) built by `pkg` ("jax" or "torch")."""
    unique, nmt = (j_unique, j_nmt) if pkg == "jax" else (tfluid.unique_name, t_nmt)
    with unique.guard():
        main, startup, feeds, fetches = getattr(nmt, builder)(**config)
    if passes:
        keep = [v.name for v in fetches.values()]
        passes_of = jfluid.core.passes if pkg == "jax" else tfluid.passes
        for p in PASSES:
            passes_of.apply_pass(main, p, keep=keep)
    return main, startup, feeds, fetches


def _numpy_params(main, seed=0):
    """LN gains near 1, the rest N(0, 0.05)."""
    rng = np.random.RandomState(seed)
    out = {}
    for p in sorted(main.all_parameters(), key=lambda v: v.name):
        arr = 1.0 + 0.1 * rng.randn(*p.shape) if p.name.endswith(".ln.w") else 0.05 * rng.randn(*p.shape)
        out[p.name] = arr.astype(np.float32)
    return out


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _jax_scope(main, startup, params):
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    for name, arr in params.items():
        scope.set_var(name, jnp.asarray(arr))
    return exe, scope


def _feeds(seed=1, lengths=LENGTHS):
    """The same ragged batch as the JAX package's and the port's LoDTensors."""
    batch = t_nmt.make_fake_nmt_batch(*lengths, TINY["src_vocab"], TINY["tgt_vocab"], seed=seed)
    return ({k: JLoDTensor(v.sequences) for k, v in batch.items()}, batch)


def test_lod_tensor_buckets_like_jax():
    for n in (1, 7, 8, 9, 63, 64, 65, 100, 129):
        assert bucket_length(n) == j_lod.bucket_length(n)
    seqs = [np.arange(n).reshape(n, 1) for n in (3, 9, 1)]
    for bucket in (True, False, 24):
        got, want = LoDTensor(seqs).padded(bucket), JLoDTensor(seqs).padded(bucket)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert LoDTensor(seqs).lod() == JLoDTensor(seqs).lod()


def test_ragged_forward_matches_jax():
    """One ragged forward: the logits at the valid target positions within
    1e-5 and the loss within 1e-5 relative."""
    jm, js, _, jf = _build("jax", with_optimizer=False, **TRAIN)
    tm, _, _, tf = _build("torch", with_optimizer=False, **TRAIN)
    params = _numpy_params(jm)
    jexe, jscope = _jax_scope(jm, js, params)
    tscope = tfluid.Scope()
    tfluid.io.load_numpy_params(tscope, params)
    jfeed, tfeed = _feeds()
    want = jexe.run(jm, feed=jfeed, fetch_list=[jf["loss"], jf["logits"]], scope=jscope)
    got = tfluid.Executor(tfluid.CPUPlace()).run(tm, feed=tfeed, fetch_list=[tf["loss"], tf["logits"]],
                                                 scope=tscope)
    want_logits = np.asarray(want[1])
    assert got[1].shape == want_logits.shape == (4, 8, TINY["tgt_vocab"])
    for row, n in enumerate(LENGTHS[1]):
        np.testing.assert_allclose(got[1][row, :n], want_logits[row, :n], atol=1e-5, rtol=0)
    loss = float(np.asarray(want[0]).reshape(-1)[0])
    assert abs(float(got[0].reshape(-1)[0]) - loss) <= 1e-5 * abs(loss)


def _state_kind(name):
    for kind in ("moment1", "moment2", "beta1_pow_acc", "beta2_pow_acc"):
        if name.endswith(f"_{kind}_0"):
            return kind
    return "counter" if name == "@LR_DECAY_COUNTER@" else "param"


_TRAINED = {}


def _train_both(passes):
    if passes not in _TRAINED:
        jm, js, _, jf = _build("jax", passes=passes, **TRAIN)
        tm, _, _, tf = _build("torch", passes=passes, **TRAIN)
        jexe, jscope = _jax_scope(jm, js, _numpy_params(jm))
        state = {n: np.asarray(jscope.find_var(n)) for n in _persistables(jm)}
        tscope = tfluid.Scope()
        tfluid.io.load_numpy_params(tscope, state)
        texe = tfluid.Executor(tfluid.CPUPlace())
        jfeed, tfeed = _feeds()
        params = [p.name for p in jm.all_parameters()]
        run = dict(jm=jm, tm=tm, jscope=jscope, tscope=tscope, state=state, jl=[], tl=[],
                   jgrads=[], tparams_after_step1=None)
        for step in range(STEPS):
            out = jexe.run(jm, feed=jfeed, fetch_list=[jf["loss"]] + [f"{p}@GRAD" for p in params],
                           scope=jscope)
            run["jl"].append(float(np.asarray(out[0]).reshape(-1)[0]))
            run["jgrads"].append(dict(zip(params, (np.asarray(g, np.float32) for g in out[1:]))))
            run["tl"].append(float(texe.run(tm, feed=tfeed, fetch_list=[tf["loss"]],
                                            scope=tscope)[0].reshape(-1)[0]))
            if step == 0:
                run["tparams_after_step1"] = {p: tscope.to_numpy(p) for p in params}
        _TRAINED[passes] = run
    return _TRAINED[passes]


def _lr_of_step(step):
    """The noam learning rate of TRAIN's step `step` (1-based): the counter reads step - 1."""
    n = step - 1
    if n == 0:
        return 0.0
    return TRAIN["learning_rate"] * TRAIN["d_model"] ** -0.5 * min(
        n ** -0.5, n * TRAIN["warmup_steps"] ** -1.5)


@pytest.mark.parametrize("passes", [True, False], ids=["passes", "no_passes"])
def test_three_adam_steps_match_jax(passes):
    run = _train_both(passes)
    if passes:
        ln = [op for op in run["tm"].global_block().ops if op.type == "layer_norm"]
        assert len(ln) == 5 * TINY["n_layers"] and all(op.input("Residual") for op in ln)
    assert np.isfinite(run["tl"]).all()
    np.testing.assert_allclose(run["tl"], run["jl"], atol=LOSS_TOL, rtol=0)
    # step 1 runs at lr 0: parameters bit for bit unchanged, the moments moved
    for p, arr in run["tparams_after_step1"].items():
        np.testing.assert_array_equal(arr, run["state"][p], err_msg=p)
    names = _persistables(run["jm"])
    peak = {}
    for n in names:
        kind = _state_kind(n)
        peak[kind] = max(peak.get(kind, 0.0), float(np.abs(np.asarray(run["jscope"].find_var(n),
                                                                     np.float32)).max()))
    grad_peaks = [max(float(np.abs(g).max()) for g in step.values()) for step in run["jgrads"]]
    near_zero = {}  # param -> elements whose JAX gradient is 0 to rounding at some step
    for step, gpeak in zip(run["jgrads"], grad_peaks):
        for p, g in step.items():
            near_zero[p] = near_zero.get(p, False) | (np.abs(g) <= ZERO_GRAD * gpeak)
    # a parameter whose gradient is 0 to rounding everywhere (a key bias: the
    # softmax cancels it) may keep its value and moments
    quiet = {p for p, z in near_zero.items() if z.all()}
    flip_tol = 2 * max(_lr_of_step(s) for s in range(1, STEPS + 1)) * STEPS + PARAM_TOL
    for n in names:
        want = np.asarray(run["jscope"].find_var(n)).astype(np.float32)
        got = run["tscope"].to_numpy(n).astype(np.float32)
        assert got.shape == want.shape, n
        err = np.abs(got - want)
        kind = _state_kind(n)
        owner = n[:-len(f"_{kind}_0")] if kind not in ("param", "counter") else n
        moved = not np.array_equal(got, run["state"][n].astype(np.float32))
        assert moved or owner in quiet, f"{n} did not move"
        if kind == "param":
            assert err.max() <= flip_tol, (n, float(err.max()))
            held = err[~near_zero[n]]
            assert held.size == 0 or held.max() <= PARAM_TOL, (n, float(held.max()))
        elif kind.startswith("moment"):
            assert err.max() <= STATE_RTOL * peak[kind], (n, float(err.max()))
        else:  # beta pows and the step counter
            assert err.max() <= STATE_RTOL * float(np.abs(want).max()), (n, float(err.max()))
    assert run["tscope"].to_numpy("@LR_DECAY_COUNTER@")[0] == STEPS - 1


def test_padding_invariance():
    """The same pairs padded to two bucket lengths give the same loss (no
    padded position leaks into the attention or the loss), and the JAX
    package's loss."""
    tm, _, _, tf = _build("torch", with_optimizer=False, **TRAIN)
    jm, js, _, jf = _build("jax", with_optimizer=False, **TRAIN)
    params = _numpy_params(tm)
    scope = tfluid.Scope()
    tfluid.io.load_numpy_params(scope, params)
    exe = tfluid.Executor(tfluid.CPUPlace())
    _, batch = _feeds(seed=3, lengths=([3, 5], [4, 2]))

    def run(bucket_src, bucket_tgt):
        feed = {}
        for name, bucket in (("src_word", bucket_src), ("trg_word", bucket_tgt),
                             ("lbl_word", bucket_tgt)):
            feed[name], feed[name + "@LOD"] = batch[name].padded(bucket=bucket)
        return float(exe.run(tm, feed=feed, fetch_list=[tf["loss"]], scope=scope)[0].reshape(-1)[0])

    l8, l16 = run(8, 8), run(16, 24)
    np.testing.assert_allclose(l16, l8, rtol=1e-5)
    jexe, jscope = _jax_scope(jm, js, params)
    want = jexe.run(jm, feed={k: JLoDTensor(v.sequences) for k, v in batch.items()},
                    fetch_list=[jf["loss"]], scope=jscope)[0]
    np.testing.assert_allclose(l8, float(np.asarray(want).reshape(-1)[0]), rtol=1e-5)


def test_jax_program_runs_in_port():
    """The JAX package's program (passes applied, Adam and the noam schedule
    included), carried by to_dict / from_dict, trains in the port as the
    JAX package trains it: the lengths travel as explicit op inputs."""
    jm, js, _, jf = _build("jax", passes=True, **TRAIN)
    tm = tfluid.Program.from_dict(jm.to_dict())
    assert tm.global_block().var("src_word").lod_level == 1
    jexe, jscope = _jax_scope(jm, js, _numpy_params(jm))
    tscope = tfluid.Scope()
    tfluid.io.load_numpy_params(tscope, {n: np.asarray(jscope.find_var(n)) for n in _persistables(jm)})
    jfeed, tfeed = _feeds(seed=2)
    texe = tfluid.Executor(tfluid.CPUPlace())
    for _ in range(2):
        want = jexe.run(jm, feed=jfeed, fetch_list=[jf["loss"]], scope=jscope)[0]
        got = texe.run(tm, feed=tfeed, fetch_list=[jf["loss"].name], scope=tscope)[0]
        np.testing.assert_allclose(float(got.reshape(-1)[0]), float(np.asarray(want).reshape(-1)[0]),
                                   rtol=1e-5)
    np.testing.assert_allclose(tscope.to_numpy("proj.w_moment1_0"),
                               np.asarray(jscope.find_var("proj.w_moment1_0")), atol=1e-7)


def _decode_params(raise_eos):
    """The tiny model's seeded parameters; `raise_eos` lifts proj.b[eos] so
    that beams finish at different steps and the loop exits early."""
    tm, _, _, _ = _build("torch", with_optimizer=False, **TRAIN)
    params = _numpy_params(tm, seed=4)
    if raise_eos:
        params["proj.b"][DECODE["eos"]] += 1.5
    return params


def _src_batch(seed=3):
    rng = np.random.RandomState(seed)
    b, ts = DECODE["batch_size"], DECODE["src_len"]
    lens = rng.randint(3, ts + 1, b)
    rows = [rng.randint(3, TINY["src_vocab"], (n, 1)).astype("int64") for n in lens]
    padded = np.zeros((b, ts), "int64")
    for i, r in enumerate(rows):
        padded[i, :len(r)] = r[:, 0]
    return rows, padded, lens.astype("int32")


def _decode(pkg, params, beam, passes=False, extra_fetch=()):
    """(ids, scores, *extra) of the compiled beam decode built by `pkg`."""
    main, _, _, fetches = _build(pkg, "build_beam_decode", passes=passes, beam_size=beam,
                                 **TINY, **DECODE)
    fluid = jfluid if pkg == "jax" else tfluid
    scope = fluid.Scope()
    if pkg == "jax":
        for name, arr in params.items():
            scope.set_var(name, jnp.asarray(arr))
    else:
        tfluid.io.load_numpy_params(scope, params)
    _, padded, lens = _src_batch()
    out = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"src_word": padded, "src_len_vec": lens},
        fetch_list=[fetches["out_ids"], fetches["out_scores"], *extra_fetch], scope=scope)
    return [np.asarray(o) for o in out]


def _step_var(main):
    """The loop counter t: the var the sub-block's `increment` writes."""
    return next(op.output("Out")[0] for op in main.blocks[1].ops if op.type == "increment")


@pytest.mark.parametrize("raise_eos", [False, True], ids=["full_length", "early_exit"])
@pytest.mark.parametrize("beam", [1, 3])
def test_compiled_beam_decode_matches_jax(beam, raise_eos):
    params = _decode_params(raise_eos)
    tm, _, _, _ = _build("torch", "build_beam_decode", beam_size=beam, **TINY, **DECODE)
    want_ids, want_scores = _decode("jax", params, beam)
    got_ids, got_scores, t_end = _decode("torch", params, beam, extra_fetch=[_step_var(tm)])
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_scores, want_scores, atol=1e-5, rtol=0)
    assert got_ids.shape == (DECODE["batch_size"], DECODE["max_len"])
    assert (got_ids[:, 0] == DECODE["bos"]).all()
    # the loop runs to max_len, or leaves early once every beam has finished
    assert (int(t_end[0]) < DECODE["max_len"]) == raise_eos, int(t_end[0])


def test_passes_fold_both_blocks_and_keep_the_decode():
    """fuse_ln_residual and fuse_bias_act fold the encoder's adds in block 0
    and the decoder's in the While's block, and change no id."""
    params = _decode_params(False)
    main, _, _, _ = _build("torch", "build_beam_decode", passes=True, beam_size=3, **TINY,
                           **DECODE)
    for blk, layers in ((main.blocks[0], 2), (main.blocks[1], 3)):
        ln = [op for op in blk.ops if op.type == "layer_norm"]
        assert len(ln) == layers * TINY["n_layers"] and all(op.input("Residual") for op in ln)
        acts = [op for op in blk.ops if op.type == "elementwise_add" and op.attrs.get("fuse_act")]
        assert len(acts) == TINY["n_layers"]
    got = _decode("torch", params, 3, passes=True)
    want = _decode("jax", params, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)


def test_compiled_decode_equals_host_loop_and_beam_one_is_greedy():
    """The port's compiled decode against its own host-loop beam search
    (float64 scores over ragged prefixes: the reference test's tolerance),
    and beam 1 against the argmax of each step's logits."""
    params = _decode_params(False)
    infer, _, _, ifetch = _build("torch", "build_nmt_infer", **TINY)
    scope = tfluid.Scope()
    tfluid.io.load_numpy_params(scope, params)
    exe = tfluid.Executor(tfluid.CPUPlace())
    rows, _, _ = _src_batch()
    for beam in (1, 3):
        ids, scores = _decode("torch", params, beam)
        host_ids, host_scores = t_nmt.beam_search_decode(
            exe, infer, ifetch["logits"], scope, rows, bos=DECODE["bos"], eos=DECODE["eos"],
            beam_size=beam, max_len=DECODE["max_len"])
        np.testing.assert_array_equal(ids, host_ids)
        np.testing.assert_allclose(scores, host_scores, rtol=1e-3, atol=1e-4)
        if beam != 1:
            continue
        for t in range(1, DECODE["max_len"]):
            trg = LoDTensor([row[:t].reshape(-1, 1) for row in ids])
            feed = {"src_word": LoDTensor(rows), "trg_word": trg, "lbl_word": trg}
            (logits,) = exe.run(infer, feed=feed, fetch_list=[ifetch["logits"]], scope=scope)
            done = (ids[:, :t] == DECODE["eos"]).any(axis=1)  # a finished row keeps EOS
            np.testing.assert_array_equal(ids[:, t], np.where(done, DECODE["eos"],
                                                              logits[:, t - 1].argmax(-1)))

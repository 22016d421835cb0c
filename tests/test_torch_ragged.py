"""The rest of the ragged path on the CPU against the JAX package:
`DynamicRNN` / `StaticRNN` (the `dynamic_rnn` op), the CRF pair, `warpctc`,
`dynamic_gru`, `dynamic_lstmp` and `lstm` (cudnn_lstm) as layers, `cond` /
`conditional_block`, the tensor arrays, and Fluid's benchmark
seq2seq-with-attention (machine_translation) built by one function for both
packages.

Tolerances: forwards 1e-5 (1e-4 against brute-force enumerations in
float64 of float32 inputs); the seq2seq's 3 Adam steps hold the losses to
1e-5, the moments to 1e-5 of the largest of their kind, and every parameter
to 1e-5, save elements whose JAX gradient is within 1e-6 of the model's
largest at some step (Adam moves those by up to lr per step on rounding
alone), held to 2 * lr * steps + 1e-5."""
import itertools

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import LoDTensor as JLoD
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu_torch import LoDTensor as TLoD
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.ops import cuda_kernels as ck

PKGS = {"jax": (jfluid, j_unique, JLoD), "torch": (tfluid, t_unique, TLoD)}


@pytest.fixture(autouse=True)
def launches_unchanged():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before, "a CPU run must not count a kernel launch"


def _ragged(lens, feat, seed, dtype="float32"):
    r = np.random.RandomState(seed)
    return [r.randn(n, *feat).astype(dtype) for n in lens]


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _run_both(build, feed_of, fetch_names=None, steps=1, state_from_jax=True):
    """Build in each package (one unique-name guard each), run the JAX
    startup, load its state into the port, then `steps` runs of each;
    returns {pkg: [fetches per step]} and the two scopes."""
    out, scopes, progs = {}, {}, {}
    state = None
    for name in ("jax", "torch"):
        fluid, unique, lod = PKGS[name]
        with unique.guard():
            main, startup, fetches = build(fluid)
        progs[name] = main
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        if name == "jax" or not state_from_jax:
            exe.run(startup, scope=scope)
            if name == "jax":
                state = {n: np.asarray(scope.find_var(n)) for n in _persistables(main)
                         if scope.find_var(n) is not None}
        else:
            tfluid.io.load_numpy_params(scope, state)
        names = fetch_names or [f.name for f in fetches]
        out[name] = [exe.run(main, feed=feed_of(lod), fetch_list=names, scope=scope)
                     for _ in range(steps)]
        scopes[name] = scope
    assert progs["torch"].to_dict() == progs["jax"].to_dict()
    return out, scopes


def _close(got, want, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                   atol=atol, rtol=0)


# --- DynamicRNN / StaticRNN ----------------------------------------------------------

SEQS = _ragged([3, 5, 2], (6,), seed=7)


def _simple_rnn(fluid, h=4, reverse=False):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [6], dtype="float32", lod_level=1)
        drnn = layers.DynamicRNN(is_reverse=reverse)
        with drnn.block():
            word = drnn.step_input(x)
            prev = drnn.memory(shape=[h], value=0.0)
            hid = layers.fc([word, prev], h, act="tanh", bias_attr=False)
            drnn.update_memory(prev, hid)
            drnn.output(hid)
        out = drnn()
        final = layers.sequence_last_step(out)
    return main, startup, [out, final]


@pytest.mark.parametrize("reverse", [False, True])
def test_dynamic_rnn_matches_numpy_and_jax(reverse):
    """tests/test_sequence.py's simple RNN: against numpy's recurrence (outputs
    0 past each length) and against the JAX package, forward and reversed."""
    out, scopes = _run_both(lambda f: _simple_rnn(f, reverse=reverse),
                            lambda lod: {"x": lod(SEQS)})
    (o, f), = out["torch"]
    _close([o, f], out["jax"][0], 1e-5)
    with t_unique.guard():
        main = _simple_rnn(tfluid, reverse=reverse)[0]
    sub = main.blocks[[op for op in main.global_block().ops
                       if op.type == "dynamic_rnn"][0].attrs["sub_block"]]
    w1, w2 = (scopes["torch"].to_numpy(op.inputs["Y"][0]) for op in sub.ops if op.type == "mul")
    for i, s in enumerate(SEQS):
        hprev = np.zeros(4, "f4")
        for t in (reversed(range(len(s))) if reverse else range(len(s))):
            hprev = np.tanh(s[t] @ w1 + hprev @ w2)
            np.testing.assert_allclose(o[i, t], hprev, rtol=1e-4, atol=1e-5)
        assert np.all(o[i, len(s):] == 0)
        if not reverse:
            np.testing.assert_allclose(f[i], hprev, rtol=1e-4, atol=1e-5)


def _rnn_regression(fluid):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [6], dtype="float32", lod_level=1)
        y = layers.data("y", [1], dtype="float32")
        drnn = layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(x)
            prev = drnn.memory(shape=[8], value=0.0)
            hid = layers.fc([word, prev], 8, act="tanh")
            drnn.update_memory(prev, hid)
            drnn.output(hid)
        last = layers.sequence_last_step(drnn())
        loss = layers.mean(layers.square_error_cost(layers.fc(last, 1), y))
        fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return main, startup, [loss]


def test_dynamic_rnn_trains_as_in_jax():
    """tests/test_sequence.py's trainable RNN: gradients flow through the
    per-step body; 30 Adam steps from the JAX package's state halve the
    loss, and the first 5 losses equal the JAX package's within 1e-5."""
    seqs = _ragged([3, 5, 2, 4], (6,), seed=1)
    tgt = np.array([[0.5], [-0.3], [0.1], [0.9]], dtype="float32")
    out, _ = _run_both(_rnn_regression, lambda lod: {"x": lod(seqs), "y": tgt}, steps=5)
    losses = {k: [float(np.asarray(v[0]).reshape(-1)[0]) for v in runs]
              for k, runs in out.items()}
    np.testing.assert_allclose(losses["torch"], losses["jax"], atol=1e-5, rtol=0)
    with t_unique.guard():
        main, startup, (loss,) = _rnn_regression(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": TLoD(seqs), "y": tgt}
    got = [float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0].reshape(-1)[0])
           for _ in range(30)]
    assert got[-1] < got[0] * 0.5


def _static_rnn(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [5, 4], dtype="float32")
        rnn = fluid.layers.StaticRNN()
        with rnn.step():
            step = rnn.step_input(x)
            acc = rnn.memory(shape=[4], value=0.0)
            new = acc + step
            rnn.update_memory(acc, new)
            rnn.step_output(new)
        out = rnn()
    return main, startup, [out]


def test_static_rnn_cumsum():
    """tests/test_ops_round3b.py's running sum over a dense [b, T, f] input."""
    xv = np.random.RandomState(0).rand(3, 5, 4).astype("float32")
    out, _ = _run_both(_static_rnn, lambda lod: {"x": xv})
    np.testing.assert_allclose(out["torch"][0][0], np.cumsum(xv, axis=1), atol=1e-5)
    _close(out["torch"][0], out["jax"][0], 1e-6)


def _dropout_rnn(fluid):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [6], dtype="float32", lod_level=1)
        drnn = layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(x)
            prev = drnn.memory(shape=[8], value=0.0)
            hid = layers.fc([layers.dropout(word, 0.5, dropout_implementation="upscale_in_train"),
                             prev], 8, act="tanh")
            drnn.update_memory(prev, hid)
            drnn.output(hid)
        loss = layers.mean(layers.sequence_last_step(drnn()))
        params_grads = fluid.append_backward(loss)
    main.random_seed = startup.random_seed = 0
    return main, startup, loss, [g for _, g in params_grads]


def test_remat_repeats_the_dropout_masks_of_a_body():
    """A random op inside a DynamicRNN body draws from the run's generator,
    so remat's recompute (a rerun generator in the step's starting state,
    rerun_generators_needed) repeats its masks: the gradients with
    memory_optimize equal those without, bit for bit, and the masks differ
    from step to step."""
    with t_unique.guard():
        main, startup, loss, grads = _dropout_rnn(tfluid)
    feed = {"x": TLoD(_ragged([3, 5, 2], (6,), seed=3))}
    strategy = tfluid.BuildStrategy()
    strategy.memory_optimize = True
    runs = []
    for program in (main, tfluid.CompiledProgram(main, strategy)):
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        runs.append([exe.run(program, feed=feed, fetch_list=[loss] + grads, scope=scope)
                     for _ in range(2)])
    for a, b in zip(*runs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert not np.array_equal(runs[0][0][0], runs[0][1][0])


# --- the CRF, CTC and the other recurrences as layers --------------------------------

CRF_ROWS = [np.random.RandomState(7).randn(n, 3).astype("f4") for n in (4, 2, 3)]
CRF_LBLS = [np.array([[0], [2], [1], [1]], "int64"), np.array([[1], [0]], "int64"),
            np.array([[2], [2], [0]], "int64")]
CRF_W = (np.random.RandomState(8).randn(5, 3) * 0.8).astype("f4")


def _crf(fluid, with_label=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        emis = fluid.layers.data("emis", [3], dtype="float32", lod_level=1)
        label = fluid.layers.data("label", [1], dtype="int64", lod_level=1)
        attr = fluid.ParamAttr(name="crfw")
        nll = fluid.layers.linear_chain_crf(emis, label, param_attr=attr)
        path = fluid.layers.crf_decoding(emis, param_attr=attr,
                                         label=label if with_label else None)
        (gw,) = fluid.calc_gradient(fluid.layers.mean(nll), [main.global_block().var("crfw")])
    return main, startup, [nll, path, gw]


def _score(x, w, path):
    s = w[0, path[0]] + w[1, path[-1]] + sum(x[t, p] for t, p in enumerate(path))
    return s + sum(w[2 + path[t - 1], path[t]] for t in range(1, len(path)))


def _paths(x):
    return list(itertools.product(range(x.shape[1]), repeat=x.shape[0]))


@pytest.mark.parametrize("with_label", [False, True])
def test_crf_matches_brute_force_and_jax(with_label):
    """The NLL against enumeration of every path (1e-4) and the JAX package
    (1e-5, its gradient by the transition too); the Viterbi paths (or, with
    a label, the 0/1 agreement) equal both, 0 past each length."""
    def feed(lod):
        return {"emis": lod(CRF_ROWS), "label": lod(CRF_LBLS)}

    def build(fluid):
        main, startup, f = _crf(fluid, with_label)
        startup.global_block().ops = [op for op in startup.global_block().ops
                                      if "crfw" not in op.output_arg_names]
        startup.global_block().append_op("assign_value", outputs={"Out": ["crfw"]},
                                         attrs={"values": CRF_W, "dtype": "float32",
                                                "shape": list(CRF_W.shape)})
        return main, startup, f

    out, _ = _run_both(build, feed, state_from_jax=False)
    nll, path, gw = out["torch"][0]
    _close([nll, gw], [out["jax"][0][0], out["jax"][0][2]], 1e-5)
    np.testing.assert_array_equal(path, out["jax"][0][1])
    for i, (x, l) in enumerate(zip(CRF_ROWS, CRF_LBLS)):
        scores = np.array([_score(x, CRF_W.astype(np.float64), p) for p in _paths(x)])
        log_z = scores.max() + np.log(np.exp(scores - scores.max()).sum())
        np.testing.assert_allclose(nll[i, 0], log_z - _score(x, CRF_W, l[:, 0]), atol=1e-4)
        best = list(_paths(x)[int(np.argmax(scores))])
        want = (np.array(best) == l[:, 0]).astype(np.int64) if with_label else best
        assert path[i, :len(x)].tolist() == list(want) and (path[i, len(x):] == 0).all()


def _ctc_brute(logits, labels, blank=0):
    m = logits.max(-1, keepdims=True)
    logp = logits - m - np.log(np.exp(logits - m).sum(-1, keepdims=True))
    total = -np.inf
    for path in itertools.product(range(logits.shape[1]), repeat=logits.shape[0]):
        collapsed = [s for k, s in enumerate(path) if k == 0 or s != path[k - 1]]
        if [s for s in collapsed if s != blank] == list(labels):
            total = np.logaddexp(total, sum(logp[t, path[t]] for t in range(len(path))))
    return -total


def _ctc(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        logits = fluid.layers.data("logits", [3], dtype="float32", lod_level=1)
        label = fluid.layers.data("label", [1], dtype="int64", lod_level=1)
        loss = fluid.layers.warpctc(logits, label)
        (g,) = fluid.calc_gradient(fluid.layers.mean(loss), [logits])
    return main, startup, [loss, g]


def test_warpctc_matches_brute_force_and_jax():
    rows = [np.random.RandomState(0).randn(4, 3).astype("f4"),
            np.random.RandomState(1).randn(3, 3).astype("f4")]
    lbls = [np.array([[1], [2]], "int64"), np.array([[2]], "int64")]
    out, _ = _run_both(_ctc, lambda lod: {"logits": lod(rows), "label": lod(lbls)})
    _close(out["torch"][0], out["jax"][0], 1e-5)
    for i, (row, lab) in enumerate(zip(rows, lbls)):
        np.testing.assert_allclose(out["torch"][0][0][i, 0], _ctc_brute(row, lab[:, 0]),
                                   atol=1e-4)


def _recurrences(fluid):
    """dynamic_gru, dynamic_lstmp and lstm (cudnn_lstm) as a user builds
    them, with one mean loss over their outputs and its gradients."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [6], dtype="float32", lod_level=1)
        dense = layers.data("dense", [4, 3], dtype="float32")
        h0 = layers.data("h0", [2, 3], dtype="float32", append_batch_size=False)
        gru = layers.dynamic_gru(layers.fc(x, 12, num_flatten_dims=2), 4, is_reverse=True)
        proj, cell = layers.dynamic_lstmp(layers.fc(x, 16, num_flatten_dims=2), 16, 3)
        init = layers.transpose(layers.reshape(h0, [2, 1, 3]), [1, 0, 2])
        out, last_h, last_c = layers.lstm(dense, init, init, 4, 3, 1)
        parts = [layers.reduce_sum(v) for v in (gru, proj, cell, out, last_h, last_c)]
        loss = layers.sums(parts)
        grads = fluid.calc_gradient(loss, [p for p in main.all_parameters()])
    return main, startup, [gru, proj, cell, out, last_h, last_c] + list(grads)


def test_recurrence_layers_match_jax():
    """Forward and every parameter's gradient within 1e-5 * (1 + max|ref|)."""
    r = np.random.RandomState(3)
    seqs = _ragged([5, 2, 4], (6,), seed=4)
    dense = r.randn(2, 4, 3).astype("f4")
    h0 = r.randn(2, 3).astype("f4")
    out, _ = _run_both(_recurrences, lambda lod: {"x": lod(seqs), "dense": dense, "h0": h0})
    for g, w in zip(out["torch"][0], out["jax"][0]):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(np.asarray(g, np.float64), w, rtol=0,
                                   atol=1e-5 * (1 + np.abs(w).max()))


# --- cond, conditional_block and the tensor arrays -----------------------------------

def _cond(fluid):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [3], dtype="float32")
        flag = layers.data("flag", [1], dtype="bool", append_batch_size=False)
        out = layers.cond(flag, lambda: layers.scale(x, 2.0), lambda: layers.scale(x, -1.0))
    return main, startup, [out]


def _fresh_on_false(fluid):
    """A conditional_block whose body writes a var that exists nowhere else:
    zeros of the true branch's shape when the predicate is false."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [3], dtype="float32")
        flag = layers.data("flag", [1], dtype="bool", append_batch_size=False)
        out = layers.cond(flag, lambda: layers.elementwise_add(x, x))
    return main, startup, [out]


@pytest.mark.parametrize("flag", [True, False])
@pytest.mark.parametrize("build", [_cond, _fresh_on_false], ids=["two_branches", "fresh_var"])
def test_cond_matches_jax(build, flag):
    xv = np.array([[1.0, -2.0, 3.0], [0.5, 0.0, -1.5]], np.float32)
    out, _ = _run_both(build, lambda lod: {"x": xv, "flag": np.array([flag])})
    (got,), = out["torch"]
    np.testing.assert_array_equal(got, out["jax"][0][0])
    want = (xv * 2.0 if flag else -xv) if build is _cond else (xv + xv if flag else 0 * xv)
    np.testing.assert_array_equal(got, want)


def _arrays(fluid):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [3], dtype="float32")
        i0 = layers.fill_constant([1], "int64", 0)
        i2 = layers.fill_constant([1], "int64", 2)
        arr = layers.array_write(x, i0)
        layers.array_write(layers.scale(x, 3.0), i2, array=arr)
        n = layers.array_length(arr)
        back = layers.array_read(arr, i2)
    return main, startup, [n, back]


def test_tensor_arrays_match_jax():
    """create_array / array_write / array_read / array_length; the array itself
    fetches as a LoDTensorArray (a list of arrays) in the port."""
    xv = np.arange(6, dtype=np.float32).reshape(2, 3)
    out, _ = _run_both(_arrays, lambda lod: {"x": xv})
    (n, back), = out["torch"]
    _close([n, back], out["jax"][0], 0.0)
    assert n.tolist() == [3]
    np.testing.assert_array_equal(back, xv * 3.0)
    with t_unique.guard():
        main, startup, _ = _arrays(tfluid)
    arr_name = next(op for op in main.global_block().ops if op.type == "create_array").output(
        "Out")[0]
    exe = tfluid.Executor(tfluid.CPUPlace())
    (arr,) = exe.run(main, feed={"x": xv}, fetch_list=[arr_name], scope=tfluid.Scope())
    assert isinstance(arr, tfluid.LoDTensorArray) and len(arr) == 3
    np.testing.assert_array_equal(arr[0], xv)
    assert arr[1] is None
    np.testing.assert_array_equal(arr[2], xv * 3.0)


def test_graph_refusals_name_the_host_reads():
    """A conditional_block plan and a tensor-array plan are refused a CUDA
    graph, each with its reason; so is one whose DynamicRNN body holds a
    conditional_block; the seq2seq's DynamicRNN alone is not refused."""
    with t_unique.guard():
        cond_main = _cond(tfluid)[0]
        arr_main = _arrays(tfluid)[0]
        rnn_main = _simple_rnn(tfluid)[0]
    refusal = lambda m: t_executor._graph_refusal(m.global_block().ops)  # noqa: E731
    assert "conditional_block" in refusal(cond_main) and "predicate" in refusal(cond_main)
    assert "array_write reads its index on the host" in refusal(arr_main)
    assert refusal(rnn_main) is None
    sub = rnn_main.blocks[1]
    sub.append_op("conditional_block", inputs={"Cond": []}, outputs={},
                  attrs={"sub_block": 0})
    assert "conditional_block" in refusal(rnn_main)


def test_parameter_read_only_inside_a_body_is_kept_and_updated():
    """_effective_io folds a dynamic_rnn's sub-block in: the fc weights the
    body alone reads are in the plan's state and move under SGD."""
    with t_unique.guard():
        main, startup, (loss,) = _rnn_regression(tfluid)
    body_params = {op.input("Y")[0] for op in main.blocks[1].ops if op.type == "mul"}
    ops = main.global_block().ops
    forward = ops[:[op.type for op in ops].index("backward")]
    assert body_params and not body_params & {n for op in forward for n in op.input_arg_names}
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    before = {n: scope.to_numpy(n).copy() for n in body_params}
    seqs = _ragged([3, 5], (6,), seed=2)
    exe.run(main, feed={"x": TLoD(seqs), "y": np.ones((2, 1), "f4")}, fetch_list=[loss],
            scope=scope)
    assert body_params <= set(exe.last_plan.state_names)
    assert all(np.abs(scope.to_numpy(n) - before[n]).max() > 0 for n in body_params)
    # an inference program whose only reader of a parameter is the body
    infer = main.clone(for_test=True)
    (o,) = exe.run(infer, feed={"x": TLoD(seqs), "y": np.ones((2, 1), "f4")},
                   fetch_list=[loss], scope=scope)
    assert np.isfinite(o).all() and body_params <= set(exe.last_plan.state_names)


# --- Fluid's benchmark seq2seq with attention -------------------------------------

def build_seq2seq(fluid, src_vocab, tgt_vocab, emb_dim, enc_dim, dec_dim, learning_rate=1e-3):
    """benchmark/fluid/models/machine_translation.py of the reference on a
    padded ragged batch: a bidirectional LSTM encoder (fc(tanh) ->
    dynamic_lstm, no peepholes, one reversed), a tanh boot state from the
    reverse LSTM's first step, and a DynamicRNN decoder with Bahdanau
    attention (fc -> sequence_expand -> concat -> fc(1, tanh) ->
    sequence_softmax -> scale -> sequence_pool(sum)) and a hand-written LSTM
    step (four fc's over [h, x], sums) under a softmax fc over the target
    vocabulary; cross_entropy, token-masked mean, Adam.  The lengths
    companion is set by hand where a layer does not carry it, and concat
    takes axis 2 on padded ragged values."""
    layers = fluid.layers
    seq = fluid.layers.sequence
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = layers.data("src_word", [1], dtype="int64", lod_level=1)
        tgt = layers.data("trg_word", [1], dtype="int64", lod_level=1)
        lbl = layers.data("lbl_word", [1], dtype="int64", lod_level=1)
        src_lod, tgt_lod = seq._lod_of(src), seq._lod_of(tgt)
        src_emb = seq._set_lod(layers.embedding(src, [src_vocab, emb_dim]), src_lod)

        def encoder_lstm(reverse):
            proj = seq._set_lod(layers.fc(src_emb, enc_dim * 4, num_flatten_dims=2, act="tanh",
                                          bias_attr=False), src_lod)
            return layers.dynamic_lstm(proj, enc_dim * 4, use_peepholes=False,
                                       is_reverse=reverse)[0]

        fwd, rev = encoder_lstm(False), encoder_lstm(True)
        enc_vec = seq._set_lod(layers.concat([fwd, rev], axis=2), src_lod)
        enc_proj = seq._set_lod(layers.fc(enc_vec, dec_dim, num_flatten_dims=2, bias_attr=False),
                                src_lod)
        boot = layers.fc(layers.sequence_first_step(rev), dec_dim, act="tanh", bias_attr=False)
        tgt_emb = seq._set_lod(layers.embedding(tgt, [tgt_vocab, emb_dim]), tgt_lod)
        rnn = layers.DynamicRNN()
        with rnn.block():
            word = rnn.step_input(tgt_emb)
            h_prev = rnn.memory(init=boot)
            c_prev = rnn.memory(shape=[dec_dim], value=0.0)
            state = layers.fc(h_prev, dec_dim, bias_attr=False)
            expanded = layers.sequence_expand(state, enc_proj)
            scores = seq._set_lod(layers.fc(layers.concat([enc_proj, expanded], axis=2), 1,
                                            num_flatten_dims=2, act="tanh", bias_attr=False),
                                  src_lod)
            weights = layers.sequence_softmax(scores)
            context = layers.sequence_pool(
                seq._set_lod(layers.elementwise_mul(enc_vec, weights), src_lod), "sum")
            x = layers.concat([context, word], axis=1)
            f, i, o = (layers.sigmoid(layers.fc([h_prev, x], dec_dim)) for _ in range(3))
            cand = layers.tanh(layers.fc([h_prev, x], dec_dim))
            c = layers.sums([layers.elementwise_mul(f, c_prev), layers.elementwise_mul(i, cand)])
            h = layers.elementwise_mul(o, layers.tanh(c))
            rnn.update_memory(h_prev, h)
            rnn.update_memory(c_prev, c)
            rnn.output(layers.fc(h, tgt_vocab, act="softmax"))
        pred = rnn()
        ce = seq._set_lod(layers.cross_entropy(pred, lbl), tgt_lod)
        ntok = layers.reduce_sum(layers.cast(tgt_lod, "float32"))
        loss = layers.elementwise_div(layers.reduce_sum(layers.sequence_pool(ce, "sum")), ntok)
        fluid.optimizer.Adam(learning_rate).minimize(loss)
    return main, startup, {"loss": loss, "pred": pred}


def seq2seq_feed(lod_cls, n_pairs, min_len, max_len, src_vocab, tgt_vocab, seed):
    """`n_pairs` ragged pairs, lengths uniform in [min_len, max_len]; the
    labels are the targets shifted by one."""
    r = np.random.RandomState(seed)
    src, tgt, lbl = [], [], []
    for _ in range(n_pairs):
        ns, nt = r.randint(min_len, max_len + 1, 2)
        src.append(r.randint(2, src_vocab, (ns, 1)).astype(np.int64))
        t = r.randint(2, tgt_vocab, (nt + 1, 1)).astype(np.int64)
        tgt.append(t[:-1])
        lbl.append(t[1:])
    return {"src_word": lod_cls(src), "trg_word": lod_cls(tgt), "lbl_word": lod_cls(lbl)}


S2S = dict(src_vocab=50, tgt_vocab=60, emb_dim=16, enc_dim=16, dec_dim=16)
S2S_LR, S2S_STEPS = 1e-3, 3


def test_seq2seq_three_adam_steps_match_jax():
    """The tiny seq2seq: the same program (to_dict), then 3 Adam steps from
    the JAX package's startup state on 4 ragged pairs of 3-9 tokens; the
    losses (near ln 60 per token) and every persistable, held as the
    module's docstring says."""
    built = {}
    for name, (fluid, unique, _) in PKGS.items():
        with unique.guard():
            built[name] = build_seq2seq(fluid, learning_rate=S2S_LR, **S2S)
    jm, js, jf = built["jax"]
    tm, _, tf = built["torch"]
    assert tm.to_dict() == jm.to_dict()
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    state = {n: np.asarray(jscope.find_var(n)) for n in _persistables(jm)}
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.load_numpy_params(tscope, state)
    params = [p.name for p in jm.all_parameters()]
    near_zero = {p: np.zeros(state[p].shape, bool) for p in params}
    jl, tl = [], []
    for _ in range(S2S_STEPS):
        out = jexe.run(jm, feed=seq2seq_feed(JLoD, 4, 3, 9, S2S["src_vocab"], S2S["tgt_vocab"], 0),
                       fetch_list=[jf["loss"].name] + [f"{p}@GRAD" for p in params],
                       scope=jscope)
        peak = max(float(np.abs(g).max()) for g in out[1:])
        for p, g in zip(params, out[1:]):
            near_zero[p] |= np.abs(np.asarray(g)) <= 1e-6 * peak
        jl.append(float(np.asarray(out[0]).reshape(-1)[0]))
        feed = seq2seq_feed(TLoD, 4, 3, 9, S2S["src_vocab"], S2S["tgt_vocab"], 0)
        tl.append(float(texe.run(tm, feed=feed, fetch_list=[tf["loss"].name],
                                 scope=tscope)[0].reshape(-1)[0]))
    assert abs(tl[0] - np.log(S2S["tgt_vocab"])) < 0.5, tl
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    peak_of = {}
    for n in state:
        kind = next((k for k in ("moment1", "moment2") if n.endswith(f"_{k}_0")), None)
        if kind:
            peak_of[kind] = max(peak_of.get(kind, 0.0), float(np.abs(jscope.find_var(n)).max()))
    for n in state:
        want = np.asarray(jscope.find_var(n))
        got = tscope.to_numpy(n)
        assert got.dtype == want.dtype and got.shape == want.shape, n
        err = np.abs(got.astype(np.float64) - want)
        if n in near_zero:
            assert err.max() <= 2 * S2S_LR * S2S_STEPS + 1e-5, n
            held = err[~near_zero[n]]
            assert held.size == 0 or held.max() <= 1e-5, (n, float(held.max()))
        else:
            kind = next((k for k in ("moment1", "moment2") if n.endswith(f"_{k}_0")), None)
            tol = 1e-5 * (peak_of[kind] if kind else max(1.0, float(np.abs(want).max())))
            assert err.max() <= tol, (n, float(err.max()), tol)

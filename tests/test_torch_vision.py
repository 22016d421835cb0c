"""The fluid_benchmark model family on the CPU against the JAX package:
`nets`, `models/vision.py` (VGG-16, SE-ResNeXt-50, the stacked dynamic LSTM,
word2vec) and the `dynamic_lstm` op.

Builds: `nets.*` and the four builders give the JAX package's programs,
`to_dict` for `to_dict` (every var with its shape and dtype).
`dynamic_lstm`: forward and every gradient within 1e-5 of the JAX lowering
on ragged lengths, with and without peepholes, in reverse, with H0 / C0.
The conv nets: the test-mode forward from the JAX package's startup state,
logits within 1e-4 of their largest magnitude, at a size whose last stage is
not 1 x 1 at batch 2 (64 x 64 images: a 1 x 1 stage normalizes each batch
norm over two values, which turns rounding into O(1) differences -- see
tests/test_torch_resnet.py); and training held teacher-forced as
tests/test_torch_resnet.py holds ResNet-50: each step starts both packages
from the JAX package's state and is held by that file's bounds (loss 2e-4,
running statistics 1e-3 of their move, each update and accumulator 0.2 in
L2, accumulators' cosine 0.99), dropout 0.  The stacked LSTM and word2vec
train 3 Adam steps freely from the JAX package's startup, under the bounds
tests/test_torch_training.py holds BERT to (loss 1e-4; moments 1e-4 of the
largest of their kind; parameters 1e-5, or 2 * lr * steps + 1e-5 where a
gradient is within 1e-6 of 0)."""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import nets as j_nets
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.models import vision as j_vision
from paddle_tpu_torch import nets as t_nets
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.models import vision as t_vision
from paddle_tpu_torch.ops import cuda_kernels as ck

PKGS = {"jax": dict(fluid=jfluid, nets=j_nets, vision=j_vision, unique=j_unique),
        "torch": dict(fluid=tfluid, nets=t_nets, vision=t_vision, unique=t_unique)}


@pytest.fixture(autouse=True)
def launches_unchanged():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before, "a CPU run must not count a kernel launch"


def _both(fn):
    return {name: fn(pkg) for name, pkg in PKGS.items()}


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _jax_startup(main, startup):
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(startup, scope=scope)
    return exe, scope, {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}


def _port(state):
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.load_numpy_params(scope, state)
    return exe, scope


# --- builds -------------------------------------------------------------------------

def _nets_program(pkg, which):
    fluid, nets = pkg["fluid"], pkg["nets"]
    main, startup = fluid.Program(), fluid.Program()
    with pkg["unique"].guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data("img", [3, 16, 16], dtype="float32")
        seq = fluid.layers.data("seq", [6], dtype="float32", lod_level=1)
        x = fluid.layers.data("x", [5, 8], dtype="float32")
        if which == "simple_img_conv_pool":
            nets.simple_img_conv_pool(img, 4, 3, 2, 2, conv_padding=1, act="relu")
        elif which == "img_conv_group":
            nets.img_conv_group(img, [4, 4], 2, conv_act="relu", conv_with_batchnorm=True,
                                conv_batchnorm_drop_rate=0.1, pool_stride=2)
        elif which == "sequence_conv_pool":
            nets.sequence_conv_pool(seq, 5, 3, act="tanh", pool_type="max")
        elif which == "glu":
            nets.glu(x, dim=-1)
        else:
            nets.scaled_dot_product_attention(x, x, x, num_heads=int(which[-1]))
    return main, startup


NETS = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool", "glu",
        "scaled_dot_product_attention_1", "scaled_dot_product_attention_2"]
BUILDERS = {"vgg": ("build_vgg", {}),
            "se_resnext": ("build_se_resnext", dict(class_dim=10, image_shape=(3, 64, 64))),
            "stacked_dynamic_lstm": ("build_stacked_dynamic_lstm", {}),
            "word2vec": ("build_word2vec", {})}


@pytest.mark.parametrize("which", NETS + list(BUILDERS))
def test_builds_equal_the_jax_package(which):
    """Main and startup programs, `to_dict` for `to_dict`: ops, attrs and
    every var with its shape and dtype."""
    if which in BUILDERS:
        fn, kw = BUILDERS[which]

        def build(pkg):
            with pkg["unique"].guard():
                return getattr(pkg["vision"], fn)(**kw)[:2]
    else:
        def build(pkg):
            return _nets_program(pkg, which)
    got = _both(lambda pkg: [p.to_dict() for p in build(pkg)])
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["blocks"][0]["ops"]


# --- dynamic_lstm -------------------------------------------------------------------

D, B, T = 5, 4, 7
LENS = np.array([7, 3, 1, 5], np.int32)


def _lstm_program(pkg, peep, rev, init):
    fluid = pkg["fluid"]
    main, startup = fluid.Program(), fluid.Program()
    with pkg["unique"].guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4 * D], dtype="float32", lod_level=1)
        x.stop_gradient = False
        h0 = c0 = None
        if init:
            h0 = fluid.layers.data("h0", [D], dtype="float32")
            c0 = fluid.layers.data("c0", [D], dtype="float32")
            h0.stop_gradient = c0.stop_gradient = False
        hidden, cell = fluid.layers.dynamic_lstm(x, 4 * D, h_0=h0, c_0=c0, use_peepholes=peep,
                                                 is_reverse=rev)
        wh = fluid.layers.data("wh", [T, D], dtype="float32")
        wc = fluid.layers.data("wc", [T, D], dtype="float32")
        loss = fluid.layers.sums([fluid.layers.mean(fluid.layers.elementwise_mul(hidden, wh)),
                                  fluid.layers.mean(fluid.layers.elementwise_mul(cell, wc))])
        wrt = [p.name for p in main.all_parameters()] + ["x"] + (["h0", "c0"] if init else [])
        grads = fluid.append_backward(loss, parameter_list=wrt)
    return main, startup, [hidden.name, cell.name] + [g.name for _, g in grads]


@pytest.mark.parametrize("init", [False, True], ids=["zero_state", "h0_c0"])
@pytest.mark.parametrize("rev", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("peep", [True, False], ids=["peepholes", "no_peepholes"])
def test_dynamic_lstm_matches_the_jax_lowering(peep, rev, init):
    """Hidden, cell and the gradients of the input, the weight, the bias
    (its peephole tail included) and H0 / C0 on ragged lengths: the memories
    freeze and the outputs are 0 past each row's length."""
    r = np.random.RandomState(3)
    feed = {"x": r.randn(B, T, 4 * D).astype(np.float32), "x@LOD": LENS,
            "wh": r.randn(B, T, D).astype(np.float32), "wc": r.randn(B, T, D).astype(np.float32)}
    if init:
        feed.update(h0=r.randn(B, D).astype(np.float32), c0=r.randn(B, D).astype(np.float32))
    jm, js, fetch = _lstm_program(PKGS["jax"], peep, rev, init)
    tm, _, tfetch = _lstm_program(PKGS["torch"], peep, rev, init)
    assert tfetch == fetch and tm.to_dict() == jm.to_dict()
    jexe, jscope, state = _jax_startup(jm, js)
    # a non-zero bias, so its peephole tail takes part
    state = {n: (v + 0.3 * r.randn(*v.shape)).astype(v.dtype) for n, v in state.items()}
    for n, v in state.items():
        jscope.set_var(n, v)
    want = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
    texe, tscope = _port(state)
    got = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
    for name, w, g in zip(fetch, want, got):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)
    hidden = got[0]
    for row, n in enumerate(LENS):
        assert not hidden[row, n:].any()


# --- the conv nets: test-mode forward and teacher-forced steps ----------------------

CONV = {"se_resnext": ("build_se_resnext", dict(class_dim=10, image_shape=(3, 64, 64))),
        "vgg": ("build_vgg", dict(class_dim=10, image_shape=(3, 64, 64)))}


def _conv_feed(batch, seed=0):
    r = np.random.RandomState(seed)
    return {"img": r.rand(batch, 3, 64, 64).astype(np.float32),
            "label": r.randint(0, 10, (batch, 1)).astype(np.int64)}


@pytest.mark.parametrize("model", list(CONV))
def test_conv_net_test_mode_forward_matches(model):
    """Batch 2 in test mode (running statistics), from the JAX package's
    startup: the JAX program through to_dict / from_dict, logits within 1e-4
    of their largest magnitude."""
    fn, kw = CONV[model]
    with j_unique.guard():
        jm, js, _, fetches = getattr(j_vision, fn)(with_optimizer=False, is_test=True, **kw)
    logits = next(op.input("Logits")[0] for op in jm.global_block().ops
                  if op.type == "softmax_with_cross_entropy")
    jexe, jscope, state = _jax_startup(jm, js)
    feed = _conv_feed(2)
    want = np.asarray(jexe.run(jm, feed=feed, fetch_list=[logits], scope=jscope)[0])
    texe, tscope = _port(state)
    got = texe.run(TProgram.from_dict(jm.to_dict()), feed=feed, fetch_list=[logits],
                   scope=tscope)[0]
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


LOSS_RTOL, STAT_SHARE, UPDATE_L2, COSINE = 2e-4, 1e-3, 0.2, 0.99
ADAM_LR = 0.01  # build_vgg's
ACCUMULATORS = ("_velocity_0", "_moment1_0", "_moment2_0")


def _l2_share(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _check_step(tm, before, jl, tl, jax_after, port_after, zero_grad):
    """One teacher-forced step by tests/test_torch_resnet.py's bounds.  An
    element whose gradient is 0 in exact arithmetic (`zero_grad` masks them:
    the bias a batch norm right after removes, and elements within 1e-6 of
    the step's largest gradient) moves by Adam's +-lr on rounding alone: it
    is held to 2 * lr + 1e-5, and the update's L2 share over the others."""
    params = {p.name for p in tm.all_parameters() if p.trainable}
    stats = {op.input(s)[0] for op in tm.global_block().ops if op.type == "batch_norm"
             for s in ("Mean", "Variance")}
    assert abs(tl - jl) <= LOSS_RTOL * max(1.0, abs(jl)), (tl, jl)
    dot = nj = nt = 0.0
    for name, want in jax_after.items():
        got, prev = port_after[name], before[name].astype(np.float32)
        assert got.shape == want.shape, name
        if name in stats:
            moved = float(np.abs(want - prev).max())
            assert moved > 0 and float(np.abs(got - want).max()) <= STAT_SHARE * moved, name
        elif name.endswith(ACCUMULATORS) and zero_grad.get(name[:name.rindex("_", 0, -2)],
                                                           np.zeros(1, bool)).all():
            # a removed bias's moment holds only rounding noise: the BERT
            # rule, 1e-4 of the largest accumulator of its kind
            kind = name[name.rindex("_", 0, -2):]
            peak = max(float(np.abs(v).max()) for n, v in jax_after.items() if n.endswith(kind))
            assert float(np.abs(got - want).max()) <= 1e-4 * peak, name
        elif name.endswith(ACCUMULATORS):
            assert _l2_share(got, want) <= UPDATE_L2, (name, _l2_share(got, want))
            if not name.endswith("_moment2_0"):
                dot += float(np.sum(got.astype(np.float64) * want))
                nj += float(np.sum(want.astype(np.float64) ** 2))
                nt += float(np.sum(got.astype(np.float64) ** 2))
        elif name in params:
            keep = ~zero_grad[name]
            assert np.abs(got - want)[~keep].max(initial=0.0) <= 2 * ADAM_LR + 1e-5, name
            share = _l2_share((got - prev)[keep], (want - prev)[keep])
            assert share <= UPDATE_L2, (name, share)
        else:  # the learning rate and Adam's beta pows
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
    assert dot / np.sqrt(nj * nt) >= COSINE


@pytest.mark.parametrize("model", list(CONV))
def test_conv_net_teacher_forced_steps_match(model):
    """3 training steps at batch 4 (SE-ResNeXt-50 Momentum 0.1 / 0.9, VGG-16
    Adam), dropout 0, the JAX program through to_dict / from_dict, each
    step from the JAX package's state, held per step (the module's
    docstring)."""
    fn, kw = CONV[model]
    with j_unique.guard():
        jm, js, _, fetches = getattr(j_vision, fn)(**kw)
    for op in jm.global_block().ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0
    loss = fetches["loss"].name
    tm = TProgram.from_dict(jm.to_dict())
    jexe, jscope, _ = _jax_startup(jm, js)
    texe = tfluid.Executor(tfluid.CPUPlace())
    names = _persistables(jm)
    params = [p.name for p in jm.all_parameters() if p.trainable]
    ops = jm.global_block().ops
    bn_inputs = {op.input("X")[0] for op in ops if op.type == "batch_norm"}
    removed = {op.input("Y")[0] for op in ops
               if op.type == "elementwise_add" and op.output("Out")[0] in bn_inputs}
    assert model != "vgg" or len(removed) == 14  # 13 conv biases and one fc's
    feed = _conv_feed(4)
    losses = []
    for _ in range(3):
        before = {n: np.asarray(jscope.find_var(n)) for n in names}
        tscope = tfluid.Scope()
        tfluid.io.load_numpy_params(tscope, before)
        out = jexe.run(jm, feed=feed, fetch_list=[loss] + [f"{p}@GRAD" for p in params],
                       scope=jscope)
        jl = float(np.asarray(out[0]).reshape(-1)[0])
        grads = [np.abs(np.asarray(g, np.float32)) for g in out[1:]]
        peak = max(float(g.max()) for g in grads)
        zero_grad = {p: (g <= 1e-6 * peak) | (p in removed) for p, g in zip(params, grads)}
        assert all(zero_grad[p].all() for p in removed)
        del out, grads
        tl = float(texe.run(tm, feed=feed, fetch_list=[loss], scope=tscope)[0].reshape(-1)[0])
        _check_step(tm, before, jl, tl, {n: np.asarray(jscope.find_var(n), np.float32)
                                         for n in names},
                    {n: tscope.to_numpy(n).astype(np.float32) for n in names}, zero_grad)
        losses.append(jl)
    assert np.isfinite(losses).all() and losses[-1] != losses[0]


# --- the stacked LSTM and word2vec: 3 free Adam steps -------------------------------

LR, STEPS, PARAM_TOL, ZERO_GRAD, STATE_RTOL = 0.01, 3, 1e-5, 1e-6, 1e-4


def _lstm_feed(vocab, seed=0):
    r = np.random.RandomState(seed)
    lens = np.array([9, 4, 12, 1, 7, 12], np.int32)
    words = np.zeros((len(lens), 12, 1), np.int64)
    for i, n in enumerate(lens):
        words[i, :n, 0] = r.randint(0, vocab, n)
    return {"words": words, "words@LOD": lens,
            "label": r.randint(0, 2, (len(lens), 1)).astype(np.int64)}


def _w2v_feed(vocab, n=4, seed=0):
    r = np.random.RandomState(seed)
    feed = {f"w{i}": r.randint(0, vocab, (16, 1)).astype(np.int64) for i in range(n - 1)}
    feed["target"] = r.randint(0, vocab, (16, 1)).astype(np.int64)
    return feed


FREE = {"stacked_dynamic_lstm": ("build_stacked_dynamic_lstm",
                                 dict(vocab_size=60, emb_dim=16, hidden_dim=16, stacked_num=3,
                                      learning_rate=LR), lambda: _lstm_feed(60)),
        "word2vec": ("build_word2vec", dict(dict_size=60, embed_size=8, hidden_size=16,
                                            learning_rate=LR), lambda: _w2v_feed(60))}


@pytest.mark.parametrize("model", list(FREE))
def test_three_free_adam_steps_match(model):
    fn, kw, make_feed = FREE[model]
    built = {}
    for name, pkg in PKGS.items():
        with pkg["unique"].guard():
            built[name] = getattr(pkg["vision"], fn)(**kw)
    jm, js, _, jf = built["jax"]
    tm, _, _, tf = built["torch"]
    assert tm.to_dict() == jm.to_dict()
    loss = jf["loss"].name
    jexe, jscope, state = _jax_startup(jm, js)
    texe, tscope = _port(state)
    feed = make_feed()
    params = [p.name for p in jm.all_parameters()]
    jl, tl, peaks, near_zero = [], [], [], {p: np.zeros(state[p].shape, bool) for p in params}
    for _ in range(STEPS):
        out = jexe.run(jm, feed=feed, fetch_list=[loss] + [f"{p}@GRAD" for p in params],
                       scope=jscope)
        grads = dict(zip(params, (np.asarray(g, np.float32) for g in out[1:])))
        peak = max(float(np.abs(g).max()) for g in grads.values())
        for p in params:
            near_zero[p] |= np.abs(grads[p]) <= ZERO_GRAD * peak
        jl.append(float(np.asarray(out[0]).reshape(-1)[0]))
        tl.append(float(texe.run(tm, feed=feed, fetch_list=[tf["loss"].name],
                                 scope=tscope)[0].reshape(-1)[0]))
    assert np.isfinite(tl).all() and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    peak_of = {}
    for n in state:
        kind = next((k for k in ("moment1", "moment2") if n.endswith(f"_{k}_0")), None)
        if kind:
            peak_of[kind] = max(peak_of.get(kind, 0.0), float(np.abs(jscope.find_var(n)).max()))
    for n in state:
        want = np.asarray(jscope.find_var(n), np.float32)
        got = tscope.to_numpy(n).astype(np.float32)
        err = np.abs(got - want)
        if n in near_zero:
            assert err.max() <= 2 * LR * STEPS + 1e-5, n
            held = err[~near_zero[n]]
            assert held.size == 0 or held.max() <= PARAM_TOL, (n, float(held.max()))
        else:
            kind = next((k for k in ("moment1", "moment2") if n.endswith(f"_{k}_0")), None)
            tol = STATE_RTOL * (peak_of[kind] if kind else float(np.abs(want).max()))
            assert err.max() <= tol, (n, float(err.max()), tol)

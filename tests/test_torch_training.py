"""The training slice on the CPU against the JAX package.

The fixed model is the tiny zoo BERT (vocab 200, seq 16, d 32, 2 layers, 2
heads, d_ff 64, unfused attention, dropout 0, Adam lr 1e-3), built by both
packages, with the fusion passes on and off, in float32 and bfloat16.  The
JAX package's whole persistable state after its startup (parameters from a
numpy seed, Adam's moments and beta pows, the learning rate) goes to the
port through `io.load_numpy_params`; both then train 3 steps on the same
feeds.  Tolerances: losses float32 1e-4, bfloat16 5e-2; other state than
parameters 1e-4 (float32) or 5e-2 (bfloat16) of its largest magnitude.
Parameters: Adam's first step moves a weight by lr * g / (|g| + eps), +-lr
wherever |g| > eps, so where a gradient is 0 to rounding the summation order
can flip the step's sign.  In float32 every parameter agrees to 1e-5, save
the elements whose JAX gradient lies within 1e-6 of the model's largest at
some step, which keep the bound 2*lr*steps + 1e-5.  In bfloat16 the
gradients themselves differ by the activations' rounding, so elementwise
only that bound holds, and the whole update (parameters after minus before)
must agree to 10% in L2.  The same rule holds the tiny BERT trained with
each regularizer and gradient clip (CLIP_DECAY), built as a user would.
The kernels' plain versions are held against the Pallas kernels run in
interpret mode, in float32, bfloat16 and float16 (float16's tolerances:
a float16 output 6.25e-3 of the largest, bfloat16's 5e-2 scaled by the 2^-3
of float16's three more bits; a float32 one float32's; Adam's float16
parameter one float16 step, tests/test_torch_kernels.one_float16_step)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.models import transformer as j_transformer
from paddle_tpu.ops import pallas_kernels as jpk
from paddle_tpu_torch.core.dtypes import to_tensor
from paddle_tpu_torch.models import transformer as t_transformer
from paddle_tpu_torch.ops import cuda_kernels as ck
from test_torch_kernels import one_float16_step

LR = 1e-3
STEPS = 3
TINY = dict(vocab_size=200, seq_len=16, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            use_fused_attention=False, dropout_prob=0.0, learning_rate=LR, with_optimizer=True)
LOSS_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
STATE_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}
PARAM_TOL = 1e-5  # float32
SIGN_FLIP_TOL = 2 * LR * STEPS + 1e-5
ZERO_GRAD = 1e-6  # of the model's largest gradient at the step
UPDATE_RTOL_BF16 = 0.1
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
PASSES = ("fuse_ln_residual", "fuse_bias_act")


@pytest.fixture(autouse=True)
def launches_unchanged():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before, "a CPU run must not count a kernel launch"


# regularizers and gradient clips on the tiny BERT's Adam, each built as a user
# would (`regularization=` / `set_gradient_clip`): the clips' thresholds lie
# below the tiny BERT's gradients (global norm ~0.45, per-parameter norms up
# to ~0.33, elements up to ~0.08), so every clip scales or cuts some of them
CLIP_DECAY = {
    "l2decay": lambda f: (f.regularizer.L2Decay(0.01), None),
    "l1decay": lambda f: (f.regularizer.L1Decay(1e-3), None),
    "clip_by_value": lambda f: (None, f.clip.GradientClipByValue(0.02)),
    "clip_by_norm": lambda f: (None, f.clip.GradientClipByNorm(0.05)),
    "clip_by_global_norm": lambda f: (f.regularizer.L2Decay(0.01),
                                      f.clip.GradientClipByGlobalNorm(0.2)),
}


def _build(pkg, dtype, passes, clip_decay=None, **config):
    """(main, startup, loss name) of the tiny BERT with Adam built by `pkg`,
    with a regularizer and gradient clip of CLIP_DECAY when named."""
    unique, transformer, fluid = ((j_unique, j_transformer, jfluid) if pkg == "jax"
                                  else (tfluid.unique_name, t_transformer, tfluid))
    with unique.guard():
        if clip_decay is None:
            main, startup, _, fetches = transformer.build_bert(dtype=dtype, **dict(TINY, **config))
        else:
            main, startup, _, fetches = transformer.build_bert(
                dtype=dtype, **dict(TINY, **config, with_optimizer=False))
            regularization, clip = CLIP_DECAY[clip_decay](fluid)
            with fluid.program_guard(main, startup):
                if clip is not None:
                    fluid.clip.set_gradient_clip(clip)
                fluid.optimizer.Adam(LR, regularization=regularization).minimize(fetches["loss"])
    loss = fetches["loss"].name
    if passes:
        for p in PASSES:
            if pkg == "jax":
                jfluid.core.passes.apply_pass(main, p, keep=[loss])
            else:
                tfluid.passes.apply_pass(main, p, keep=[loss])
    return main, startup, loss


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


def _batch(n=4, seed=1):
    return t_transformer.make_fake_batch(n, TINY["seq_len"], TINY["vocab_size"],
                                         rng=np.random.RandomState(seed))


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _jax_state(main, startup):
    """The JAX package's executor and scope after its startup, parameters
    replaced by the numpy seed; plus the whole persistable state as numpy."""
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    for name, arr in _numpy_params(main).items():
        scope.set_var(name, jnp.asarray(arr))
    return exe, scope, {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}


def _state_kind(name):
    for kind in ("moment1", "moment2", "beta1_pow_acc", "beta2_pow_acc"):
        if name.endswith(f"_{kind}_0"):
            return kind
    return "learning_rate" if name.startswith("learning_rate") else "param"


def _state_tols(names, dtype, scope):
    """name -> tolerance of the state other than parameters.  Moments:
    relative to the largest moment of the same kind in the model (a
    parameter whose exact gradient is 0, like an attention key bias, holds
    only rounding noise of the others).  Beta pows and the learning rate:
    relative to themselves."""
    peak = {}
    for n in names:
        kind = _state_kind(n)
        peak[kind] = max(peak.get(kind, 0.0), float(np.abs(np.asarray(scope.find_var(n),
                                                                      np.float32)).max()))
    tols = {}
    for n in names:
        kind = _state_kind(n)
        if kind == "param":
            continue
        if kind.startswith("moment"):
            tols[n] = STATE_RTOL[dtype] * peak[kind]
        else:
            tols[n] = STATE_RTOL[dtype] * float(np.abs(np.asarray(scope.find_var(n))).max())
    return tols


_TRAINED = {}


def _train_both(dtype, passes, fused=False, clip_decay=None):
    """Train 3 steps in both packages from the same state (cached per config):
    returns the per-step losses and the programs, executors and scopes.
    `fused` builds the attention as the fused_attention op (the JAX package
    runs its composite on the CPU, the port its plain forward and backward);
    `clip_decay` names a CLIP_DECAY variant."""
    key = (dtype, passes, fused, clip_decay)
    if key not in _TRAINED:
        jm, js, jl = _build("jax", dtype, passes, clip_decay, use_fused_attention=fused)
        tm, ts, tl = _build("torch", dtype, passes, clip_decay, use_fused_attention=fused)
        jexe, jscope, state = _jax_state(jm, js)
        texe = tfluid.Executor(tfluid.CPUPlace())
        tscope = tfluid.Scope()
        tfluid.io.load_numpy_params(tscope, state)
        feed = _batch()
        params = [p.name for p in jm.all_parameters()]
        jl_steps, tl_steps, jgrads = [], [], []
        for _ in range(STEPS):
            out = jexe.run(jm, feed=feed, fetch_list=[jl] + [f"{p}@GRAD" for p in params],
                           scope=jscope)
            jl_steps.append(float(np.asarray(out[0]).reshape(-1)[0]))
            jgrads.append(dict(zip(params, (np.asarray(g, np.float32) for g in out[1:]))))
            tl_steps.append(float(
                texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope)[0].reshape(-1)[0]))
        _TRAINED[key] = dict(jl=jl_steps, tl=tl_steps, jm=jm, tm=tm, jexe=jexe, texe=texe,
                             jscope=jscope, tscope=tscope, state=state, jgrads=jgrads)
    return _TRAINED[key]


def _check_params(run, dtype):
    """The port's parameters after the steps against the JAX package's, by
    the rule in the module's docstring."""
    params = [p.name for p in run["jm"].all_parameters()]
    peaks = [max(float(np.abs(g).max()) for g in step.values()) for step in run["jgrads"]]
    sq_diff = sq_update = 0.0
    for name in params:
        before = run["state"][name].astype(np.float32)
        want = np.asarray(run["jscope"].find_var(name), np.float32)
        got = run["tscope"].to_numpy(name).astype(np.float32)
        err = np.abs(got - want)
        assert err.max() <= SIGN_FLIP_TOL, (name, float(err.max()))
        if dtype == "float32":
            near_zero = np.zeros(err.shape, bool)
            for step, peak in zip(run["jgrads"], peaks):
                near_zero |= np.abs(step[name]) <= ZERO_GRAD * peak
            held = err[~near_zero]
            assert held.size == 0 or held.max() <= PARAM_TOL, (name, float(held.max()))
        sq_diff += float(np.sum((got - want) ** 2))
        sq_update += float(np.sum((want - before) ** 2))
    if dtype == "bfloat16":
        assert np.sqrt(sq_diff / sq_update) <= UPDATE_RTOL_BF16, np.sqrt(sq_diff / sq_update)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused_attention", "fused_attention"])
@pytest.mark.parametrize("passes", [True, False], ids=["passes", "no_passes"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_adam_steps_match_jax(dtype, passes, fused):
    run = _train_both(dtype, passes, fused)
    if fused:
        assert "fused_attention" in [op.type for op in run["tm"].global_block().ops]
    _check_run(run, dtype)


def _clip_is_active(run, clip_decay):
    """The JAX package's raw gradients of the first step reach the clip."""
    g = run["jgrads"][0]
    norms = [float(np.linalg.norm(v)) for v in g.values()]
    return {"clip_by_value": max(float(np.abs(v).max()) for v in g.values()) > 0.02,
            "clip_by_norm": max(norms) > 0.05 > min(norms),
            "clip_by_global_norm": float(np.sqrt(np.sum(np.square(norms)))) > 0.2,
            }.get(clip_decay, True)


@pytest.mark.parametrize("clip_decay", sorted(CLIP_DECAY))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_adam_steps_with_clip_and_decay_match_jax(dtype, clip_decay):
    """The tiny BERT with a regularizer and/or gradient clip on its Adam,
    the JAX package's state carried across: the same rule and tolerances as
    test_three_adam_steps_match_jax."""
    run = _train_both(dtype, True, True, clip_decay)
    types = [op.type for op in run["tm"].global_block().ops]
    assert types == [op.type for op in run["jm"].global_block().ops]
    first = {"l2decay": "scale", "l1decay": "sign", "clip_by_value": "clip",
             "clip_by_norm": "clip_by_norm", "clip_by_global_norm": "sqrt"}[clip_decay]
    assert first in types
    assert _clip_is_active(run, clip_decay)
    _check_run(run, dtype)


def _check_run(run, dtype):
    assert np.isfinite(run["tl"]).all() and run["tl"][-1] < run["tl"][0]
    np.testing.assert_allclose(run["tl"], run["jl"], atol=LOSS_TOL[dtype], rtol=0)
    names = _persistables(run["jm"])
    tols = _state_tols(names, dtype, run["jscope"])
    for name in names:
        want = np.asarray(run["jscope"].find_var(name)).astype(np.float32)
        got = run["tscope"].to_numpy(name).astype(np.float32)
        assert got.shape == want.shape, name
        if name in tols:
            err = float(np.abs(got - want).max())
            assert err <= tols[name], (name, err, tols[name])
        # the port's steps moved every parameter and accumulator
        moved = not np.array_equal(got, run["state"][name].astype(np.float32))
        assert moved == (_state_kind(name) != "learning_rate"), name
    _check_params(run, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clone_for_test_of_trained_program_gives_same_logits(dtype):
    run = _train_both(dtype, True)
    feed = {k: v for k, v in _batch(seed=2).items() if k != "labels"}
    out = []
    for main, exe, scope in ((run["jm"], run["jexe"], run["jscope"]),
                             (run["tm"], run["texe"], run["tscope"])):
        test = main.clone(for_test=True)
        logits = next(op for op in test.global_block().ops
                      if op.type == "softmax_with_cross_entropy").input("Logits")[0]
        assert not [op for op in test.global_block().ops if op.type in ("backward", "adam")]
        out.append(np.asarray(exe.run(test, feed=feed, fetch_list=[logits], scope=scope)[0])
                   .astype(np.float32))
    assert out[0].shape == (4 * 16, 200) and np.abs(out[0]).max() > 0.1
    np.testing.assert_allclose(out[1], out[0], atol=LOSS_TOL[dtype], rtol=0)


def test_param_grads_can_be_fetched():
    jm, js, jl = _build("jax", "float32", True)
    tm, _, tl = _build("torch", "float32", True)
    jexe, jscope, state = _jax_state(jm, js)
    tscope = tfluid.Scope()
    tfluid.io.load_numpy_params(tscope, state)
    fetch = [jl, "bert.lm_head.b@GRAD", "bert.l0.ffn1.w@GRAD", "bert.tok_emb@GRAD"]
    want = jexe.run(jm, feed=_batch(), fetch_list=fetch, scope=jscope)
    got = tfluid.Executor(tfluid.CPUPlace()).run(tm, feed=_batch(), fetch_list=fetch,
                                                 scope=tscope)
    for name, w, g in zip(fetch, want, got):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= 1e-4 * (1 + np.abs(w).max()), name
    assert np.abs(got[1]).max() > 0


def _small_program(fluid, unique):
    """x [4, 8] -> fc(3) -> mean: calc_gradient of the loss w.r.t. the fc
    weight and x, then Adam.minimize of the same loss: two backward regions."""
    main, startup = fluid.Program(), fluid.Program()
    with unique.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [8], dtype="float32")
        y = fluid.layers.fc(x, 3, param_attr=fluid.ParamAttr(name="w"),
                            bias_attr=fluid.ParamAttr(name="b"))
        loss = fluid.layers.mean(fluid.layers.elementwise_add(y, y))
        grads = fluid.calc_gradient(loss, [main.global_block().var("w"), x])
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss.name, [g.name for g in grads]


def test_calc_gradient_and_minimize_in_one_program():
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(4, 8).astype(np.float32)}
    params = {"w": rng.randn(8, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    results = []
    for fluid, unique in ((jfluid, j_unique), (tfluid, tfluid.unique_name)):
        main, startup, loss, grads = _small_program(fluid, unique)
        assert [op.type for op in main.global_block().ops].count("backward") == 2
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        for name, arr in params.items():
            scope.set_var(name, jnp.asarray(arr) if fluid is jfluid else to_tensor(arr).clone())
        out = exe.run(main, feed=feed, fetch_list=[loss] + grads, scope=scope)
        results.append([np.asarray(o) for o in out] + [np.asarray(scope.find_var("w"))])
    for want, got in zip(*results):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(results[1][1]).max() > 0 and np.abs(results[1][2]).max() > 0
    assert not np.allclose(results[1][-1], params["w"])  # the update ran after both regions


def test_port_startup_then_training_step():
    """The startup run's tensors stay trainable: none is an inference tensor,
    each takes requires_grad, a graph and an in-place update, and the
    port's own training step runs from the scope its startup filled."""
    exe = tfluid.Executor(tfluid.CPUPlace())
    # the parameters a startup run creates take requires_grad, a graph and an
    # in-place update (the serving program's startup, as a training loop
    # written by hand would use it)
    sm, ss, _ = _build("torch", "float32", True, with_optimizer=False)
    scope = tfluid.Scope()
    exe.run(ss, scope=scope)
    for p in sm.all_parameters():
        t = scope.find_var(p.name)
        assert isinstance(t, torch.Tensor) and not t.is_inference(), p.name
        leaf = t.detach().requires_grad_(True)
        (g,) = torch.autograd.grad((leaf * leaf).sum(), leaf)
        with torch.no_grad():
            t.sub_(0.1 * g)
    # the port's own training step from the scope its startup filled
    tm, ts, tl = _build("torch", "float32", True)
    scope = tfluid.Scope()
    exe.run(ts, scope=scope)
    for name in _persistables(tm):
        assert not scope.find_var(name).is_inference(), name
    before = {n: scope.to_numpy(n) for n in _persistables(tm)}
    losses = [float(exe.run(tm, feed=_batch(), fetch_list=[tl], scope=scope)[0][0])
              for _ in range(2)]
    assert np.isfinite(losses).all()
    for p in tm.all_parameters():
        t = scope.find_var(p.name)
        assert not t.is_inference() and not t.requires_grad, p.name
        # a key bias adds the same score to every key of a query, which the
        # softmax cancels: its gradient is exactly 0 and Adam leaves it
        if not p.name.endswith(".attn.k.b"):
            assert not np.array_equal(scope.to_numpy(p.name), before[p.name]), p.name
    assert scope.to_numpy("bert.lm_head.b_beta1_pow_acc_0")[0] == pytest.approx(0.9 ** 3)


def test_dropout_in_training_mode_by_moments():
    """Both packages keep each element with probability 1 - p; the kept ones
    scale by 1 / (1 - p) under upscale_in_train; Mask marks them.  The port's
    generator advances from run to run and a fixed seed repeats."""
    p = 0.3
    x = np.ones((400, 250), np.float32)
    for fluid in (jfluid, tfluid):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            xv = fluid.layers.data("x", [250], dtype="float32")
            up = fluid.layers.dropout(xv, p, dropout_implementation="upscale_in_train")
            down = fluid.layers.dropout(xv, p)
        mask_name = main.global_block().ops[-1].output("Mask")[0]
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        a, b, mask = (np.asarray(o) for o in exe.run(
            main, feed={"x": x}, fetch_list=[up, down, mask_name], scope=scope))
        for out, kept in ((a, 1.0 / (1.0 - p)), (b, 1.0)):
            assert abs((out == 0).mean() - p) < 0.01
            np.testing.assert_allclose(out[out != 0], kept, rtol=1e-6)
        assert abs(a.mean() - 1.0) < 0.02
        np.testing.assert_array_equal(mask, (b != 0).astype(np.float32))
        again = np.asarray(exe.run(main, feed={"x": x}, fetch_list=[up], scope=scope)[0])
        assert not np.array_equal(again, a)
    seeded = tfluid.Program()
    with tfluid.program_guard(seeded, tfluid.Program()):
        out = tfluid.layers.dropout(tfluid.layers.data("x", [250], dtype="float32"), p, seed=7)
    exe = tfluid.Executor(tfluid.CPUPlace())
    first, second = (exe.run(seeded, feed={"x": x}, fetch_list=[out], scope=tfluid.Scope())[0]
                     for _ in range(2))
    np.testing.assert_array_equal(first, second)


# --------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------


def _t(a, grad=False):
    t = to_tensor(np.asarray(a)).clone()
    return t.requires_grad_(True) if grad else t


def _close(name, got, want, dtype):
    """Scale-aware: 1e-4 * (1 + max|ref|) in float32, as the Pallas grad
    tests; 5e-2 of max|ref| in bfloat16; in float16 6.25e-3 of max|ref|
    for a float16 output, float32's rule for a float32 one (the column
    sums)."""
    if dtype == "float16" and isinstance(got, torch.Tensor) and got.dtype == torch.float32:
        dtype = "float32"
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    peak = float(np.abs(want).max())
    tol = (1e-4 * (1.0 + peak) if dtype == "float32"
           else {"bfloat16": 5e-2, "float16": 6.25e-3}[dtype] * max(peak, 1e-6))
    err = float(np.abs(got.astype(np.float32) - want).max())
    assert err <= tol, f"{name}: {err} > {tol}"


def _xent_example(dtype):
    logits, labels = jpk.FUSED_KERNELS["softmax_xent"]["example"](JDT[dtype])
    labels = np.asarray(labels).copy()
    labels[::3] = -100  # ignored rows
    labels[1], labels[2] = 0, logits.shape[1] - 1
    return logits, jnp.asarray(labels)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("kernel", ["softmax_xent", "adam_slab"])
def test_plain_forward_matches_pallas(kernel, dtype):
    spec = jpk.FUSED_KERNELS[kernel]
    if kernel == "softmax_xent":
        args = _xent_example(dtype)
        want = spec["fused"](args, interpret=True)
        got = ck.fused_softmax_xent(_t(args[0]), _t(args[1]), -100)
        assert got.shape == tuple(want.shape) and got.dtype == torch.float32
        outs = [(got, want)]
    else:
        args = spec["example"](JDT[dtype])
        want = spec["fused"](args, interpret=True)
        got = ck.fused_adam(*(_t(a) for a in args), torch.tensor([1e-3]), 0.9, 0.999, 1e-8)
        outs = list(zip(got, want))
        if dtype == "float16":  # the parameter float16, its moments float32
            one_float16_step(want[0], got[0])
            outs = outs[1:]
    for g, w in outs:
        assert float(np.abs(g.float().numpy() - np.asarray(w, np.float32)).max()) \
            <= spec["tol"]["float32" if dtype == "float16" else dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("kernel", ["ln_residual", "bias_act", "softmax_xent"])
def test_plain_backward_matches_pallas_vjp(kernel, dtype):
    """The explicit plain backward against jax.vjp through the Pallas custom
    VJP (interpret mode), and against autograd of the plain forward."""
    spec = jpk.FUSED_KERNELS[kernel]
    rng = np.random.RandomState(3)
    if kernel == "ln_residual":
        args = spec["example"](JDT[dtype])
        g = jnp.asarray(rng.randn(*args[0].shape), JDT[dtype])
        _, vjp = jax.vjp(lambda x, r, s, b: jpk.fused_ln_residual(x, r, s, b, 1e-5, True), *args)
        jdx, jdres, jds, jdb = vjp(g)
        x, res, s, b = (_t(a, grad=True) for a in args)
        dx, ds, db = ck.ln_residual_bwd_plain(x.detach(), res.detach(), s.detach(), _t(g), 1e-5)
        pairs = [("dx", dx, jdx), ("dres", dx, jdres), ("dscale", ds, jds), ("dbias", db, jdb)]
        auto = torch.autograd.grad(ck.ln_residual_plain(x, res, s, b, 1e-5), (x, res, s, b), _t(g))
        pairs += [("autograd dx", dx, auto[0].float().numpy()),
                  ("autograd dscale", ds, auto[2].numpy()), ("autograd dbias", db, auto[3].numpy())]
    elif kernel == "bias_act":
        args = spec["example"](JDT[dtype])
        g = jnp.asarray(rng.randn(*args[0].shape), JDT[dtype])
        _, vjp = jax.vjp(lambda x, b: jpk.fused_bias_act(x, b, "gelu", True), *args)
        jdx, jdb = vjp(g)
        x, b = (_t(a, grad=True) for a in args)
        dx, db = ck.bias_act_bwd_plain(x.detach(), b.detach(), _t(g), "gelu")
        auto = torch.autograd.grad(ck.bias_act_plain(x, b, "gelu"), (x, b), _t(g))
        pairs = [("dx", dx, jdx), ("dbias", db, jdb), ("autograd dx", dx, auto[0].float().numpy()),
                 ("autograd dbias", db, auto[1].numpy())]
    else:
        logits, labels = _xent_example(dtype)
        g = jnp.asarray(1.0 + rng.rand(logits.shape[0], 1), jnp.float32)
        _, vjp = jax.vjp(lambda x: jpk.fused_softmax_xent(x, labels, -100, True), logits)
        (jdx,) = vjp(g)
        x = _t(logits, grad=True)
        loss, lse = ck.softmax_xent_fwd_plain(x, _t(labels), -100)
        dx = ck.softmax_xent_bwd_plain(x.detach(), _t(labels), lse.detach(), _t(g)[:, 0], -100)
        (auto,) = torch.autograd.grad(loss, x, _t(g)[:, 0])
        assert not dx[::3].any()  # ignored rows take no gradient
        pairs = [("dlogits", dx, jdx), ("autograd dlogits", dx, auto.float().numpy())]
    for name, got, want in pairs:
        _close(f"{kernel} {name}", got, want, dtype)

"""The other optimizers, the parameter averages, the learning-rate
schedules and `fluid.backward` on the CPU against the JAX package.

Each optimizer class builds, on one small MLP, the JAX package's program
(`to_dict` of main and startup: accumulator names, fills, ops and attrs);
5 steps from the JAX package's startup state then give the same
parameters and accumulators, dtypes included, each within 1e-6 of the
tensor's largest magnitude (float32; at least 1e-6).  RMSProp, Ftrl and
DecayedAdagrad divide the step by the root of a squared-gradient
accumulator: from 0 an element's first step is lr * g / |g| scaled, so
where g is 0 to rounding the two packages' float orders give different
steps; their accumulators start at 0.1 in both packages (WARM_START), which
makes the steps proportional to g, as chip_smoke's DeepFM parity starts
Adagrad's moment.  `dpsgd` draws its
noise from each package's own stream, so it is held by the noise's
moments.  The averages' `apply()` swaps the averaged values in and the
parameters back bit for bit, into the same tensors.  Each schedule's value
over 10 runs equals the JAX package's within 1e-6 of its largest."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.ops import cuda_kernels as ck

PKGS = {"jax": (jfluid, j_unique), "torch": (tfluid, t_unique)}
STEPS = 5


@pytest.fixture(autouse=True)
def launches_unchanged():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before, "a CPU run must not count a kernel launch"


# name -> (class name, args, kwargs); one fc is 128 x 128 (16384 elements),
# so DGCMomentum compresses it and passes the others through
OPTIMIZERS = {
    "rmsprop": ("RMSProp", (0.01,), {}),
    "rmsprop_centered_momentum": ("RMSProp", (0.01,), {"momentum": 0.5, "centered": True}),
    "adamax": ("Adamax", (0.01,), {}),
    "adadelta": ("Adadelta", (1.0,), {"rho": 0.9}),
    "ftrl": ("Ftrl", (0.05,), {"l1": 0.001, "l2": 0.01}),
    "lamb": ("Lamb", (0.01,), {"lamb_weight_decay": 0.01}),
    "lars_momentum": ("LarsMomentum", (0.1, 0.9), {"lars_coeff": 0.01,
                                                   "lars_weight_decay": 5e-4}),
    "decayed_adagrad": ("DecayedAdagrad", (0.01,), {}),
    "dgc_momentum": ("DGCMomentum", (0.01, 0.9), {"rampup_begin_step": 1, "rampup_step": 2,
                                                  "sparsity": [0.75, 0.9]}),
    "dpsgd_no_noise": ("Dpsgd", (0.05,), {"clip": 1.0, "batch_size": 16.0, "sigma": 0.0}),
    "adam": ("Adam", (0.01,), {}),
    "sgd_l2": ("SGD", (0.05,), {"regularization": "l2"}),
}


def _mlp(fluid, opt=None, extra=None):
    """x [8] -> fc 128 tanh -> fc 128 tanh -> fc 1, square error; `opt` an
    OPTIMIZERS key, `extra(fluid)` appended after the minimize (EMA, ...)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [8], dtype="float32")
        y = layers.data("y", [1], dtype="float32")
        h = layers.fc(layers.fc(x, 128, act="tanh"), 128, act="tanh")
        loss = layers.mean(layers.square_error_cost(layers.fc(h, 1), y))
        made = None
        if opt is not None:
            cls, args, kw = OPTIMIZERS[opt]
            kw = dict(kw)
            if kw.get("regularization") == "l2":
                kw["regularization"] = fluid.regularizer.L2Decay(0.01)
            made = getattr(fluid.optimizer, cls)(*args, **kw)
            made.minimize(loss)
        if extra is not None:
            made = extra(fluid)
    main.random_seed = startup.random_seed = 0
    return main, startup, loss, made


def _feed(seed=0, batch=16):
    r = np.random.RandomState(seed)
    x = r.randn(batch, 8).astype(np.float32)
    return {"x": x, "y": np.tanh(x.sum(1, keepdims=True)).astype(np.float32)}


def _builds(opt, extra=None):
    out = {}
    for name, (fluid, unique) in PKGS.items():
        with unique.guard():
            out[name] = _mlp(fluid, opt, extra)
    return out


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


# the squared-gradient accumulators (by their name's suffix) that start at 0.1
WARM_START = {"RMSProp": "_mean_square_0", "Ftrl": "_squared_0", "DecayedAdagrad": "_moment_0"}


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_program_equals_the_jax_package(opt):
    built = _builds(opt)
    for k in (0, 1):
        assert built["torch"][k].to_dict() == built["jax"][k].to_dict()
    ops = [op.type for op in built["torch"][0].global_block().ops]
    if opt == "dgc_momentum":
        assert ops.count("dgc") == 1  # the one 128 x 128 weight
    if opt == "adamax":
        assert ops.count("scale") >= 6  # each beta1 power advances by a scale op


def _run_steps(opt, steps=STEPS):
    """`steps` runs of each package from the JAX package's startup state;
    returns the losses and the final states by package."""
    built = _builds(opt)
    (jm, js, jl, _), (tm, _, tl, _) = built["jax"], built["torch"]
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    state = {n: np.asarray(jscope.find_var(n)) for n in _persistables(jm)}
    warm = WARM_START.get(OPTIMIZERS[opt][0])
    for n in state:
        if warm and n.endswith(warm):
            state[n] = np.full_like(state[n], 0.1)
            jscope.set_var(n, state[n])
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.load_numpy_params(tscope, state)
    losses = {"jax": [], "torch": []}
    for step in range(steps):
        feed = _feed(step)
        losses["jax"].append(float(np.asarray(jexe.run(jm, feed=feed, fetch_list=[jl],
                                                       scope=jscope)[0]).reshape(-1)[0]))
        losses["torch"].append(float(texe.run(tm, feed=feed, fetch_list=[tl.name],
                                              scope=tscope)[0].reshape(-1)[0]))
    names = _persistables(jm)
    return (losses, {n: np.asarray(jscope.find_var(n)) for n in names},
            {n: tscope.to_numpy(n).copy() for n in names}, state)


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_five_steps_match_the_jax_package(opt):
    losses, want, got, start = _run_steps(opt)
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-6, atol=1e-7)
    moved = 0
    for n in want:
        assert got[n].dtype == want[n].dtype and got[n].shape == want[n].shape, n
        tol = 1e-6 * max(1.0, float(np.abs(want[n]).max()))
        err = float(np.abs(got[n].astype(np.float64) - want[n]).max())
        assert err <= tol, (n, err, tol)
        moved += not np.array_equal(want[n], start[n])
    assert moved >= 6  # the six parameters at least


def test_optimizer_surface_methods():
    """apply_optimize after backward builds minimize's program;
    get_opti_var_name_list names the accumulators; load puts values into
    the global scope by name; each as in the JAX package."""
    got = {}
    for name, (fluid, unique) in PKGS.items():
        with unique.guard():
            main, startup, loss, _ = _mlp(fluid)
            with fluid.program_guard(main, startup):
                opt = fluid.optimizer.Lamb(0.01)
                opt.apply_optimize(loss, startup, opt.backward(loss))
        names = opt.get_opti_var_name_list()
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            opt.load({names[0]: np.full((128,), 3.0, np.float32), "not_an_accumulator": 1})
        got[name] = (main.to_dict(), names, np.asarray(scope.find_var(names[0])),
                     scope.find_var("not_an_accumulator"))
    with t_unique.guard():
        ref = _mlp(tfluid, "lamb")[0].to_dict()
    assert got["torch"][0] == got["jax"][0] and got["torch"][1] == got["jax"][1]
    assert got["torch"][0] == ref  # the same program as minimize() builds
    np.testing.assert_array_equal(got["torch"][2], got["jax"][2])
    assert got["torch"][3] is None and got["jax"][3] is None


def _dpsgd(fluid):
    """One dpsgd op on a [400, 250] parameter whose gradient is 0: the update
    is -lr * sigma * clip * z / batch_size, z standard normal."""
    main, startup = fluid.Program(), fluid.Program()
    block = main.global_block()
    for n in ("p", "g", "lr"):
        block.create_var(n, shape=(1,) if n == "lr" else (400, 250), dtype="float32",
                         persistable=True)
    block.append_op("dpsgd", inputs={"Param": ["p"], "Grad": ["g"], "LearningRate": ["lr"]},
                    outputs={"ParamOut": ["p"]},
                    attrs={"clip": 2.0, "sigma": 1.5, "batch_size": 4.0})
    return main


def test_dpsgd_noise_moments():
    """mean 0 and std lr * sigma * clip / batch = 0.75 (lr 1) in both packages;
    the port's draws advance with its generator (two runs differ)."""
    zero = np.zeros((400, 250), np.float32)
    for name, (fluid, _) in PKGS.items():
        main = _dpsgd(fluid)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        draws = []
        for _ in range(2):
            scope.set_var("p", zero.copy())
            scope.set_var("g", zero.copy())
            scope.set_var("lr", np.ones(1, np.float32))
            exe.run(main, scope=scope, fetch_list=["p"])
            draws.append(np.asarray(scope.find_var("p") if name == "jax"
                                    else scope.to_numpy("p")).copy())
        for d in draws:
            assert abs(d.mean()) < 0.01 and abs(d.std() - 0.75) < 0.01, (name, d.mean(), d.std())
        assert not np.array_equal(draws[0], draws[1])


def _ema(fluid):
    ema = fluid.optimizer.ExponentialMovingAverage(0.9)
    ema.update()
    return ema


def _model_average(fluid):
    avg = fluid.optimizer.ModelAverage(max_average_window=3)
    avg.update()
    return avg


@pytest.mark.parametrize("extra", [_ema, _model_average], ids=["ema", "model_average"])
def test_averages_apply_and_restore(extra):
    """SGD steps with the average's update ops (programs equal the JAX
    package's); apply() swaps in the same values as the JAX package's apply()
    (1e-6), into the tensors the scope holds (the same objects), and the exit
    copies the parameters back bit for bit."""
    built = {}
    for name, (fluid, unique) in PKGS.items():
        with unique.guard():
            main, startup, loss, _ = _mlp(fluid)
            with fluid.program_guard(main, startup):
                fluid.optimizer.SGD(0.05).minimize(loss)
                avg = extra(fluid)
        built[name] = (main, startup, loss, avg)
    assert built["torch"][0].to_dict() == built["jax"][0].to_dict()
    assert built["torch"][1].to_dict() == built["jax"][1].to_dict()
    (jm, js, jl, javg), (tm, _, tl, tavg) = built["jax"], built["torch"]
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    state = {n: np.asarray(jscope.find_var(n)) for n in _persistables(jm)}
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.load_numpy_params(tscope, state)
    for step in range(4):
        jexe.run(jm, feed=_feed(step), fetch_list=[jl], scope=jscope)
        texe.run(tm, feed=_feed(step), fetch_list=[tl.name], scope=tscope)
    params = [p.name for p in tm.all_parameters()]
    tensors = {n: tscope.find_var(n) for n in params}
    before = {n: t.clone() for n, t in tensors.items()}
    with javg.apply(jexe, jscope):
        swapped = {n: np.asarray(jscope.find_var(n)) for n in params}
    with tavg.apply(texe, tscope):
        for n in params:
            assert tscope.find_var(n) is tensors[n]
            np.testing.assert_allclose(tscope.to_numpy(n), swapped[n], rtol=0,
                                       atol=1e-6 * max(1.0, float(np.abs(swapped[n]).max())))
        assert any(not torch.equal(tensors[n], before[n]) for n in params)
    for n in params:
        assert tscope.find_var(n) is tensors[n] and torch.equal(tensors[n], before[n]), n
    tavg.restore(texe)


SCHEDULES = {
    "exponential": ("exponential_decay", (0.1, 3, 0.5), {}),
    "exponential_staircase": ("exponential_decay", (0.1, 3, 0.5), {"staircase": True}),
    "natural_exp": ("natural_exp_decay", (0.1, 4, 0.3), {"staircase": True}),
    "inverse_time": ("inverse_time_decay", (0.1, 2, 0.5), {}),
    "polynomial": ("polynomial_decay", (0.1, 6), {"end_learning_rate": 0.01, "power": 2.0}),
    "polynomial_cycle": ("polynomial_decay", (0.1, 4), {"end_learning_rate": 0.0, "cycle": True}),
    "piecewise": ("piecewise_decay", ([2, 5, 7], [1.0, 0.5, 0.1, 0.01]), {}),
    "cosine": ("cosine_decay", (0.1, 2, 5), {}),
    "warmup_float": ("linear_lr_warmup", (0.1, 4, 0.0, 0.1), {}),
    "warmup_polynomial": ("linear_lr_warmup", (None, 3, 0.0, 1e-3), {}),
}


def _schedule(fluid, which):
    fn, args, kw = SCHEDULES[which]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        if args[0] is None:  # BERT's LAMB schedule: warmup into polynomial decay
            inner = fluid.layers.polynomial_decay(1e-3, decay_steps=8, end_learning_rate=0.0,
                                                  power=1.0)
            args = (inner,) + args[1:]
        lr = getattr(fluid.layers, fn)(*args, **kw)
    return main, startup, lr


@pytest.mark.parametrize("which", list(SCHEDULES))
def test_schedule_values_match_the_jax_package(which):
    values = {}
    for name, (fluid, unique) in PKGS.items():
        with unique.guard():
            main, startup, lr = _schedule(fluid, which)
        values[name + "_prog"] = (main.to_dict(), startup.to_dict())
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        values[name] = [float(np.asarray(exe.run(main, fetch_list=[lr.name],
                                                 scope=scope)[0]).reshape(-1)[0])
                        for _ in range(10)]
    assert values["torch_prog"] == values["jax_prog"]
    peak = max(abs(v) for v in values["jax"])
    np.testing.assert_allclose(values["torch"], values["jax"], rtol=0, atol=1e-6 * peak)
    assert len(set(values["torch"])) > 1


def test_backward_module_gradients():
    """fluid.backward.gradients (calc_gradient over several targets, one
    weighted) against the JAX package."""
    grads = {}
    x = np.random.RandomState(5).randn(4, 3).astype(np.float32)
    tg = np.random.RandomState(6).randn(4, 2).astype(np.float32)
    for name, (fluid, unique) in PKGS.items():
        main, startup = fluid.Program(), fluid.Program()
        with unique.guard(), fluid.program_guard(main, startup):
            xv = fluid.layers.data("x", [3], dtype="float32")
            xv.stop_gradient = False
            w = fluid.layers.data("tg", [2], dtype="float32")
            a = fluid.layers.fc(xv, 2, act="tanh")
            b = fluid.layers.reduce_sum(fluid.layers.square(xv))
            (g,) = fluid.backward.gradients([a, b], [xv], target_gradients=[w, None])
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        if name == "jax":
            state = {p.name: np.asarray(scope.find_var(p.name)) for p in main.all_parameters()}
        else:
            tfluid.io.load_numpy_params(scope, state)
        grads[name] = np.asarray(exe.run(main, feed={"x": x, "tg": tg}, fetch_list=[g],
                                         scope=scope)[0])
    np.testing.assert_allclose(grads["torch"], grads["jax"], rtol=0, atol=1e-6)

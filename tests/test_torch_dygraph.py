"""The port's dygraph against the JAX package's, on the CPU: VarBase and the
tape, the 18 layers, the 20 functionals, the eager optimizer updates, the
LR schedules, the clips, the rnn cells, initial draws, checkpoints, the
Layer API and DataParallel's single-process hooks.  The same numpy inputs,
made from a seed, go through both packages; the port runs under
`dygraph.guard(CPUPlace())`, the JAX package under its own guard.  Weights
travel `jax_layer.state_dict()` -> `torch_layer.set_dict()`.  Float32
results are held to 1e-5 (relative and absolute) unless a case states
otherwise; random draws (Dropout's masks, NCE's negatives, SpectralNorm's
u and v, initial weights) are held bit for bit."""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.dygraph import layers as jlayers
from paddle_tpu_torch.dygraph import base as tbase
from paddle_tpu_torch.dygraph import layers as tlayers
from paddle_tpu_torch.models import dygraph_cases as cases
from paddle_tpu_torch.ops import cuda_kernels

TOL = dict(rtol=1e-5, atol=1e-5)
PKGS = {"jax": jfluid, "torch": tfluid}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Equal init counters, fresh names and no tape in both packages (the
    suite's conftest resets only the JAX package's globals)."""
    monkeypatch.setattr(jlayers._materialize_init, "_seed", 1234)
    monkeypatch.setattr(tlayers._materialize_init, "_seed", 1234)
    monkeypatch.setattr(tbase, "_dygraph_tracer", None)
    monkeypatch.setattr(tbase, "_device", None)
    with tfluid.unique_name.guard():
        yield


@pytest.fixture
def launches_unchanged():
    """No dygraph path launches a kernel of the port's own."""
    before = dict(cuda_kernels.LAUNCHES)
    yield
    assert dict(cuda_kernels.LAUNCHES) == before


def guard(fluid):
    return fluid.dygraph.guard(tfluid.CPUPlace() if fluid is tfluid else None)


def both(fn):
    """fn(fluid) under each package's guard; the two results."""
    out = {}
    for name, fluid in PKGS.items():
        with guard(fluid):
            out[name] = fn(fluid)
    return out["jax"], out["torch"]


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64),
                               **(tol or TOL))


# --------------------------------------------------------------------------
# VarBase
# --------------------------------------------------------------------------

def test_varbase_dtypes_follow_x32_and_numpy_types():
    import ml_dtypes

    def run(fluid):
        dy = fluid.dygraph
        vals = [np.ones(3, "float64"), np.ones(3, "int64"), np.ones(3, "int32"),
                np.ones(3, "float32"), np.ones(3, ml_dtypes.bfloat16), np.ones(3, "bool"),
                np.float16([1, 2])]
        vs = [dy.to_variable(v) for v in vals]
        return ([v.dtype for v in vs], [v.numpy().dtype for v in vs],
                [v.stop_gradient for v in vs], dy.VarBase(2.5).dtype, dy.VarBase(3).dtype)

    j, t = both(run)
    assert j == t
    assert j[0][:2] == ["float32", "int32"] and j[0][4] == "bfloat16"


def test_varbase_operator_sugar_astype_detach_and_set_value():
    rng = np.random.RandomState(0)
    a, b = rng.rand(3, 4).astype("f4") + 0.5, rng.rand(4, 2).astype("f4") + 0.5

    def run(fluid):
        dy = fluid.dygraph
        x = dy.VarBase(a)
        y = dy.to_variable(b)
        i = dy.to_variable(np.arange(6).reshape(2, 3))
        outs = [x + 1.5, 2.0 + x, x - 0.25, 3.0 - x, x * x, 0.5 * x, x / 2.0, x @ y, -x,
                x / x, i * 0.5, i + 2, i / 4, 1 - i, x.astype("float64"), i.astype("int64"),
                i.astype("float32")]
        d = x.detach()
        x.set_value(np.float64([[7.0]]))
        return ([(o.dtype, o.numpy()) for o in outs],
                (d.stop_gradient, d.name == x.name, d.numpy()),
                (x.dtype, x.numpy()))

    j, t = both(run)
    for (jd, jv), (td, tv) in zip(j[0], t[0]):
        assert jd == td
        close(jv, tv, rtol=1e-6, atol=1e-6)
    assert j[1][:2] == t[1][:2]
    close(j[1][2], t[1][2], rtol=0, atol=0)
    assert j[2][0] == t[2][0] == "float32"
    close(j[2][1], t[2][1], rtol=0, atol=0)
    # a Python scalar takes the int's dtype: int * 0.5 multiplies by 0
    assert not t[0][10][1].any()


# --------------------------------------------------------------------------
# the tape
# --------------------------------------------------------------------------

def _tape_case(fluid):
    dy = fluid.dygraph
    L = fluid.layers
    rng = np.random.RandomState(1)
    lin = dy.Linear(4, 3)
    lin.set_dict({"weight": rng.rand(4, 3).astype("f4"), "bias": rng.rand(3).astype("f4")})
    x = dy.VarBase(rng.rand(2, 4).astype("f4"))  # takes a gradient
    h = lin(x)
    loss = L.mean(L.square(h))
    loss.backward(retain_graph=True)
    first = {"w": lin.weight.gradient(), "x": x.gradient(), "h": h.gradient()}
    loss.backward(retain_graph=True)  # overwrites, does not add
    second = lin.weight.gradient()
    loss.backward()  # clears the tape
    third = lin.weight.gradient()
    loss.backward()  # nothing left: the grads stay
    fourth = lin.weight.gradient()
    prelu = dy.PRelu(mode="all")
    y = L.mean(prelu(dy.VarBase(np.ones((2, 3), "f4"))))
    y.backward()
    return first, second, third, fourth, loss.gradient(), prelu.weight.gradient()


def test_tape_overwrites_retains_clears_and_gives_intermediates_grads():
    j, t = both(_tape_case)
    for k in ("w", "x", "h"):
        assert j[0][k] is not None
        close(j[0][k], t[0][k])
    for a, b in zip(j[1:4], t[1:4]):
        close(a, b)
        close(b, t[0]["w"], rtol=0, atol=0)
    assert j[4] is None and t[4] is None  # the loss gets no .grad
    # a parameter an entry used that got a zero cotangent: zeros, not None
    np.testing.assert_array_equal(j[5], [0.0])
    np.testing.assert_array_equal(t[5], [0.0])


def test_a_call_recorded_by_hand_is_differentiated_at_backward():
    """Tape.record with a plain callable (not one `_apply` traced): the
    backward runs it again under autograd, as jax.vjp runs it."""
    xv = np.random.RandomState(3).rand(2, 3).astype("f4")

    def run(fluid):
        dy = fluid.dygraph
        x = dy.VarBase(xv)
        out = dy.VarBase(xv * xv * 3.0)
        square3 = (lambda v: v * v * 3.0)
        dy.base._tape().record(square3, [x], [out])
        fluid.layers.mean(out).backward()
        return x.gradient()

    j, t = both(run)
    close(j, t)
    close(t, xv * 6.0 / xv.size)


def test_backward_outside_a_guard_raises(monkeypatch):
    for fluid in PKGS.values():
        with guard(fluid):
            v = fluid.layers.mean(fluid.dygraph.VarBase(np.ones(3, "f4")))
        with pytest.raises(RuntimeError, match="outside fluid.dygraph.guard"):
            v.backward()


def test_guard_sets_dygraph_mode_and_the_device(monkeypatch):
    for fluid in PKGS.values():
        assert fluid.in_dygraph_mode() is False
        with guard(fluid):
            assert fluid.in_dygraph_mode() is True
        assert fluid.in_dygraph_mode() is False
    with tfluid.dygraph.guard(tfluid.CPUPlace()):
        lin = tfluid.dygraph.Linear(2, 2)
        assert lin.weight.value.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with tfluid.dygraph.guard():
            pass
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.dygraph.to_variable(np.ones(2))  # outside a guard: the card too


# --------------------------------------------------------------------------
# the 18 layers: forward and every gradient
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(cases.LAYER_CASES))
def test_layer_forward_and_gradients_match_the_jax_package(case, launches_unchanged):
    random_draws = case in ("dropout", "nce", "spectral_norm")
    with guard(jfluid):
        jinit, jouts, jgrads, jstate = cases.layer_run(jfluid, case, twice=random_draws)
    with guard(tfluid):
        tinit, touts, tgrads, tstate = cases.layer_run(tfluid, case, state=jinit, twice=random_draws)
    for n in jinit:  # the same draws from equal init counters
        np.testing.assert_array_equal(jinit[n], tinit[n])
    assert list(tstate) == list(jstate)
    for jo, to in zip(jouts, touts):
        assert jo.shape == to.shape and jo.dtype == to.dtype
        close(jo, to)
    assert sorted(tgrads) == sorted(jgrads)
    for n in jgrads:
        assert tgrads[n] is not None, n
        close(jgrads[n], tgrads[n], err_msg=n, **TOL)
    for n in jstate:  # running statistics, spectral norm's weights: as moved
        close(jstate[n], tstate[n])
    if case == "dropout":  # the masks bit for bit: the zeros at the same places
        for jo, to in zip(jouts, touts):
            np.testing.assert_array_equal(jo == 0, to == 0)


def test_batch_norm_eval_uses_the_running_statistics(launches_unchanged):
    x = cases.F32(4, 3, 5, 5)

    def run(fluid):
        dy = fluid.dygraph
        bn = dy.BatchNorm(3)
        bn(dy.to_variable(x))
        bn(dy.to_variable(x * 2))
        bn.eval()
        w = dy.VarBase(x)
        out = bn(w)
        fluid.layers.mean(out).backward()
        return out.numpy(), w.gradient(), bn.state_dict(), bn.training

    j, t = both(run)
    close(j[0], t[0])
    close(j[1], t[1])
    for n in j[2]:
        close(j[2][n], t[2][n])
    assert j[3] is t[3] is False


def test_spectral_norm_and_nce_draw_the_jax_packages_numbers():
    def run(fluid):
        sn = fluid.dygraph.SpectralNorm([3, 5])
        nce = fluid.dygraph.NCE(10, 2, num_neg_samples=3)
        return (np.asarray(sn._u.cpu() if hasattr(sn._u, "cpu") else sn._u),
                np.asarray(sn._v.cpu() if hasattr(sn._v, "cpu") else sn._v),
                nce._rng.randint(0, 10, 5))

    j, t = both(run)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the 20 functionals, inside a guard and outside one
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(cases.FUNCTIONAL_CASES))
def test_functional_through_fluid_layers_matches_the_jax_package(case, launches_unchanged):
    j, t = both(lambda fluid: cases.functional_run(fluid, case))
    assert j[0] == t[0]
    close(j[1], t[1])
    for jg, tg in zip(j[2], t[2]):
        assert (jg is None) == (tg is None)
        if jg is not None:
            close(jg, tg)


def test_functionals_build_the_graph_outside_a_guard():
    rng = np.random.RandomState(4)
    xv = rng.rand(3, 4).astype("f4") + 0.1
    lv = np.array([[1], [3], [0]], "int64")
    got = {}
    for name, fluid in PKGS.items():
        L = fluid.layers
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = L.data("x", [4], dtype="float32")
            lab = L.data("lab", [1], dtype="int64")
            parts = [L.mean(L.relu(x)), L.reduce_sum(L.sigmoid(x)), L.reduce_mean(L.tanh(x)),
                     L.mean(L.log(L.sqrt(L.square(L.exp(x))))),
                     L.reduce_sum(L.softmax(L.matmul(x, L.transpose(x, [1, 0])))),
                     L.reduce_sum(L.reshape(L.concat([x, x], axis=1), [-1, 2])),
                     L.mean(L.square_error_cost(x, x * 0.5)),
                     L.mean(L.cross_entropy(L.softmax(x), lab)),
                     L.mean(L.softmax_with_cross_entropy(x, lab)),
                     L.accuracy(L.softmax(x), lab, k=2),
                     L.reduce_sum(L.dropout(x, 0.3, is_test=True))]
            assert all(isinstance(p, fluid.Variable) for p in parts)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        got[name] = exe.run(main, feed={"x": xv, "lab": lv}, fetch_list=parts, scope=scope)
    for a, b in zip(got["jax"], got["torch"]):
        close(a, b)


# --------------------------------------------------------------------------
# the eager optimizer updates
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", sorted(cases.OPTIMIZERS))
def test_eager_update_rules_match_the_jax_package(which, launches_unchanged):
    j, t = both(lambda fluid: cases.train_linear(fluid, cases.OPTIMIZERS[which]))
    close(j[0], t[0], rtol=1e-5, atol=1e-6)
    for js, ts in zip(j[1], t[1]):
        for n in js:
            close(js[n], ts[n], rtol=1e-5, atol=1e-6)
    assert j[0][-1] < j[0][0]


@pytest.mark.parametrize("which", ["ftrl", "dpsgd", "model_average"])
def test_optimizers_without_an_eager_rule_refuse_alike(which):
    make = {"ftrl": lambda o: o.Ftrl(0.1), "dpsgd": lambda o: o.Dpsgd(0.1),
            "model_average": lambda o: o.ModelAverage(0.15)}[which]
    errors = []
    for fluid in PKGS.values():
        with guard(fluid):
            layer = fluid.dygraph.Linear(2, 1)
            loss = fluid.layers.mean(layer(fluid.dygraph.to_variable(np.ones((2, 2), "f4"))))
            loss.backward()
            with pytest.raises(NotImplementedError) as ei:
                make(fluid.optimizer).minimize(loss, parameter_list=layer.parameters())
            errors.append(str(ei.value))
    assert errors[0] == errors[1]
    for fluid in PKGS.values():
        with guard(fluid):
            with pytest.raises(ValueError, match="parameter_list"):
                fluid.optimizer.SGD(0.1).minimize(None)


# --------------------------------------------------------------------------
# the schedules, the clips, the rnn cells
# --------------------------------------------------------------------------

SCHEDULES = {
    "piecewise": lambda dy: dy.PiecewiseDecay([10, 30], [1.0, 0.5, 0.1]),
    "natural_exp": lambda dy: dy.NaturalExpDecay(0.5, 7, 0.3),
    "natural_exp_staircase": lambda dy: dy.NaturalExpDecay(0.5, 7, 0.3, staircase=True),
    "exponential": lambda dy: dy.ExponentialDecay(0.5, 7, 0.9, begin=3, step=2),
    "inverse_time": lambda dy: dy.InverseTimeDecay(0.5, 7, 0.2, staircase=True),
    "polynomial": lambda dy: dy.PolynomialDecay(0.5, 20, 0.01, power=2.0),
    "polynomial_cycle": lambda dy: dy.PolynomialDecay(0.5, 20, 0.01, cycle=True),
    "cosine": lambda dy: dy.CosineDecay(0.5, 5, 10),
    "noam": lambda dy: dy.NoamDecay(64, 10),
}


@pytest.mark.parametrize("which", sorted(SCHEDULES))
def test_schedules_are_exactly_the_jax_packages(which):
    j, t = (SCHEDULES[which](fluid.dygraph) for fluid in PKGS.values())
    jv, tv = [j() for _ in range(50)], [t() for _ in range(50)]
    assert jv == tv and all(type(v) is float for v in tv)


@pytest.mark.parametrize("which", sorted(cases.CLIPS))
def test_grad_clips_match_the_jax_package(which):
    j, t = both(lambda fluid: cases.clip_run(fluid, which))
    for (jp, jg), (tp, tg) in zip(j, t):
        assert jp == tp and (jg is None) == (tg is None)
        if jg is not None:
            close(jg, tg, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_cells_match_the_jax_package(cell, launches_unchanged):
    with guard(jfluid):
        j = cases.cell_run(jfluid, cell)
    with guard(tfluid):
        t = cases.cell_run(tfluid, cell, state=j[3])
    assert list(t[1]) == list(j[1])
    for a, b in zip(j[0], t[0]):
        close(a, b)
    for n in j[1]:
        close(j[1][n], t[1][n])
    for a, b in zip(j[2], t[2]):
        assert (a is None) == (b is None)
        if a is not None:
            close(a, b)


# --------------------------------------------------------------------------
# initial draws, checkpoints, the Layer API
# --------------------------------------------------------------------------

def _inits(fluid):
    I = fluid.initializer
    return [I.ConstantInitializer(0.5), I.UniformInitializer(-0.3, 0.7),
            I.NormalInitializer(0.1, 2.0), I.TruncatedNormalInitializer(0.0, 0.5),
            I.NumpyArrayInitializer(np.arange(12, dtype="float64").reshape(3, 4)),
            I.XavierInitializer(), I.XavierInitializer(uniform=False, fan_in=5, fan_out=7),
            I.MSRAInitializer(), I.MSRAInitializer(uniform=False, fan_in=9), None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_initial_draws_are_bitwise_the_jax_packages(dtype):
    def run(fluid):
        layer = fluid.dygraph.Layer("inits", dtype=dtype)
        ps = [layer.create_parameter([3, 4], attr=fluid.ParamAttr(initializer=init))
              for init in _inits(fluid)]
        ps.append(layer.create_parameter([2, 3, 3, 3], is_bias=False))
        ps.append(layer.create_parameter([6], is_bias=True))
        return [(p.name, p.dtype, p.numpy()) for p in ps]

    j, t = both(run)
    for (jn, jd, jv), (tn, td, tv) in zip(j, t):
        assert jn == tn and jd == td == "float32"  # low-precision params are f32 masters
        assert jv.dtype == tv.dtype
        np.testing.assert_array_equal(jv, tv)


def _net(fluid):
    dy = fluid.dygraph

    class Net(dy.Layer):
        def __init__(self):
            super().__init__("net")
            self.conv = dy.Conv2D(1, 2, 3)
            self.bn = dy.BatchNorm(2)
            self.head = dy.Linear(2, 3)
            self.scale = self.create_parameter([1], default_initializer=fluid.initializer.Constant(2.0))
            self.step = self.create_variable("step", persistable=True)
            self.other = self.create_variable()

        def forward(self, x):
            y = fluid.layers.reduce_mean(self.bn(self.conv(x)), dim=[2, 3])
            return self.head(y) * self.scale

    return Net()


def test_layer_api_matches_the_jax_package():
    def run(fluid):
        net = _net(fluid)
        out = {"names": [n for n, _ in net.named_parameters()],
               "params": [p.name for p in net.parameters()],
               "own": [p.name for p in net.parameters(include_sublayers=False)],
               "sublayers": [type(s).__name__ for s in net.sublayers()],
               "full_name": net.full_name(),
               "vars": [(v.name, v.persistable, v.dtype, v.stop_gradient)
                        for v in (net.step, net.other)]}
        net.eval()
        out["eval"] = [net.training] + [s.training for s in net.sublayers()]
        net.train()
        out["train"] = [net.training] + [s.training for s in net.sublayers()]
        with pytest.raises(ValueError, match="not implemented"):
            net.backward()
        return out

    j, t = both(run)
    assert j == t
    assert j["eval"] == [False] * 4 and j["train"] == [True] * 4


def test_checkpoint_dirs_are_byte_identical_and_load_in_both_directions(tmp_path):
    x = np.random.RandomState(12).rand(2, 1, 5, 5).astype("f4")
    dirs, state = {}, None
    for name, fluid in PKGS.items():
        with guard(fluid):
            net = _net(fluid)
            if state is None:
                net(fluid.dygraph.to_variable(x))  # moves the running statistics
                state = net.state_dict()
            net.set_dict(state)  # the same values: the files hold the format
            dirs[name] = str(tmp_path / name)
            fluid.dygraph.save_persistables(net, dirs[name])
            fluid.dygraph.save_persistables({"a/b": net.head.weight, "c": np.ones(2, "int32")},
                                            dirs[name] + "_dict")
    for suffix in ("", "_dict"):
        files = sorted(os.listdir(dirs["jax"] + suffix))
        assert files == sorted(os.listdir(dirs["torch"] + suffix))
        for f in files:
            with open(os.path.join(dirs["jax"] + suffix, f), "rb") as a, \
                    open(os.path.join(dirs["torch"] + suffix, f), "rb") as b:
                assert a.read() == b.read(), f
    for src, dst in (("jax", tfluid), ("torch", jfluid)):
        loaded = dst.dygraph.load_persistables(dirs[src])
        with guard(dst):
            net = _net(dst)
            net.set_dict(loaded)
            got = net.state_dict()
        assert list(got) == list(loaded)
        for n in loaded:
            np.testing.assert_array_equal(got[n], loaded[n])


# --------------------------------------------------------------------------
# DataParallel with one process
# --------------------------------------------------------------------------

def test_data_parallel_single_process_hooks_and_counter(launches_unchanged):
    def run(fluid):
        fluid.monitor.enable()
        fluid.monitor.reset()
        try:
            dy = fluid.dygraph
            layer = dy.Linear(4, 3)
            model = dy.parallel.DataParallel(layer)
            x = dy.to_variable(np.ones((2, 4), "f4"))
            loss = fluid.layers.mean(model(x))
            assert model.scale_loss(loss) is loss
            loss.backward()
            model.apply_collective_grads()
            assert dy.prepare_context("strategy") == "strategy"
            env = dy.parallel.prepare_context()
            return (fluid.monitor.counter("collective.grad_bytes").value,
                    fluid.monitor.json_snapshot()["spans"]["collective.apply_grads"]["calls"],
                    [p.name for p in model.parameters()], list(model.state_dict()),
                    env.nranks, env.local_rank)
        finally:
            fluid.monitor.disable()
            fluid.monitor.reset()

    j, t = both(run)
    assert j == t and j[0] == (12 + 3) * 4 and j[1] == 1


def test_data_parallel_refuses_a_mesh_and_more_trainers(monkeypatch):
    """A mesh with an axis besides the batch axis waits for the
    model-parallel paths (ROADMAP A10.3); more trainers than the gang holds
    need the gang first: DataParallel says so, the parallel module's
    prepare_context brings it up from the PADDLE_TRAINER_* environment (and
    raises without it), and dygraph.prepare_context, as the JAX package's,
    leaves a single process alone."""
    with tfluid.dygraph.guard(tfluid.CPUPlace()):
        layer = tfluid.dygraph.Linear(2, 2)
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
            tfluid.dygraph.DataParallel(layer, mesh=object())
        with pytest.raises(NotImplementedError, match="ROADMAP A10.3"):
            tfluid.dygraph.DataParallel(
                layer, mesh=tfluid.parallel.make_mesh((1, 2), ("dp", "tp"), [0, 1]))
        assert tfluid.dygraph.DataParallel(
            layer, mesh=tfluid.parallel.make_mesh())._layers is layer
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
        for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT"):
            monkeypatch.delenv(k, raising=False)
        with pytest.raises(RuntimeError, match="prepare_context"):
            tfluid.dygraph.DataParallel(layer)
        with pytest.raises(ValueError, match="trainer_endpoints"):
            tfluid.dygraph.parallel.prepare_context()
        assert tfluid.dygraph.prepare_context("strategy") == "strategy"
        assert not tfluid.parallel.distributed.is_initialized()

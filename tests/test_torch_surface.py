"""The front-end surface the port's earlier slices left, against the JAX
package on the CPU: Program.block / to_string / parse_from_string,
Variable.astype, name scopes and unique_name.switch, Scope children, the
LoDTensor re-segmenting methods, the top-level names (gradients,
WeightNormParamAttr, the place lists, CUDAPinnedPlace,
create_random_int_lodtensor, compiler, in_dygraph_mode), the flag
definitions, AnalysisConfig's knobs, the tensor and tail layers, the
numpy-only metrics / evaluator / debugger, and the layers over the last
op files (by `to_dict`)."""
import json
import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.ops import cuda_kernels as ck

PKGS = {"jax": (jfluid, j_unique), "torch": (tfluid, t_unique)}


@pytest.fixture(autouse=True)
def launches_unchanged():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before, "a CPU run must not count a kernel launch"


def _both(build):
    """build(fluid) in each package under a fresh name generator, inside a
    fresh program pair: {pkg: (main, startup, result)}."""
    out = {}
    for name, (fluid, uniq) in PKGS.items():
        main, startup = fluid.Program(), fluid.Program()
        with uniq.guard(), fluid.program_guard(main, startup):
            res = build(fluid)
        out[name] = (main, startup, res)
    return out


def _same_programs(built):
    (jm, js, _), (tm, ts, _) = built["jax"], built["torch"]
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()


def _fit_a_line(fluid):
    x = fluid.layers.data("x", [13])
    y = fluid.layers.data("y", [1])
    pred = fluid.layers.fc(x, 1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    fluid.optimizer.SGD(0.05).minimize(loss)
    return loss


# --- Program, Variable, names ----------------------------------------------------

def test_program_block_to_string_and_parse_from_string():
    """to_string is the JSON of to_dict in both packages; each parses the
    other's text to the same program; block(i) is blocks[i]."""
    built = _both(_fit_a_line)
    jm, tm = built["jax"][0], built["torch"][0]
    assert json.loads(tm.to_string()) == json.loads(jm.to_string())
    assert tfluid.Program.parse_from_string(jm.to_string()).to_dict() == jm.to_dict()
    assert jfluid.Program.parse_from_string(tm.to_string()).to_dict() == tm.to_dict()
    assert tm.block(0) is tm.global_block()
    sub = tm.create_block()
    assert tm.block(1) is sub and sub.parent_idx == 0


def test_variable_astype():
    def build(fluid):
        x = fluid.layers.data("x", [3])
        return x.astype("int32").astype("float64")

    built = _both(build)
    _same_programs(built)
    assert built["torch"][2].dtype == built["jax"][2].dtype


def test_nested_name_scopes_name_alike():
    """fluid.name_scope prefixes the generated names (nested scopes compose,
    a repeated sibling takes a suffix); unique_name.switch swaps the
    generator and returns the old one."""
    def build(fluid):
        x = fluid.layers.data("x", [4])
        with fluid.name_scope("a12_enc"):
            h = fluid.layers.fc(x, 4)
            with fluid.name_scope("a12_inner"):
                h = fluid.layers.relu(fluid.layers.fc(h, 4))
        with fluid.name_scope("a12_enc"):
            h = fluid.layers.fc(h, 2)
        with fluid.name_scope(None):
            h = fluid.layers.scale(h, scale=2.0)
        return h

    built = _both(build)
    _same_programs(built)
    names = [v.name for v in built["torch"][0].list_vars()]
    assert any(n.startswith("a12_enc/a12_inner/") for n in names)
    assert any(n.startswith("a12_enc_1/") for n in names)
    for _, uniq in PKGS.values():
        old = uniq.switch()
        try:
            assert uniq.generate("k") == "k_0" and uniq.generate("k") == "k_1"
            with uniq.name_scope_guard("a12_s"):
                assert uniq.generate("k") == "a12_s/k_2"
        finally:
            uniq.switch(old)


# --- Scope, LoDTensor ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["jax", "torch"])
def test_scope_children_erase_and_var_names(name):
    fluid = PKGS[name][0]
    root = fluid.Scope()
    root.set_var("a", np.ones(2, np.float32))
    root.set_var("b", np.zeros(1, np.float32))
    kid = root.new_scope()
    kid.set_var("c", np.ones(3, np.float32))
    assert kid in root.kids and kid.parent is root
    assert kid.find_var("a") is root.find_var("a")  # lookups fall through
    assert kid.var_names() == ["a", "b", "c"] and root.var_names() == ["a", "b"]
    kid.erase(["a", "c"])  # only the kid's own names go
    assert kid.var_names() == ["a", "b"] and root.has_var("a")
    root.erase(["a", "nope"])
    assert not kid.has_var("a") and root.var_names() == ["b"]


def test_lodtensor_set_lod_and_lengths_as_the_jax_package():
    seqs = [np.arange(6, dtype=np.float32).reshape(3, 2), np.ones((2, 2), np.float32)]
    got = {}
    for name, (fluid, _) in PKGS.items():
        t = fluid.LoDTensor([s.copy() for s in seqs])
        t.set_lod([[0, 1, 5]])
        a = ([s.tolist() for s in t.sequences], t.has_valid_recursive_sequence_lengths())
        t.set_recursive_sequence_lengths([[2, 2, 1]])
        got[name] = a + ([s.tolist() for s in t.sequences], t.recursive_sequence_lengths())
    assert got["torch"] == got["jax"]
    assert got["torch"][3] == [[2, 2, 1]]
    t = tfluid.LoDTensor([np.ones((2, 3)), np.ones((1, 3))])
    t.sequences.append(np.ones((1, 2)))  # a step of another width
    assert not t.has_valid_recursive_sequence_lengths()


# --- top level -------------------------------------------------------------------------

def test_gradients_at_the_top_level():
    def build(fluid):
        x = fluid.layers.data("x", [3])
        x.stop_gradient = False
        y = fluid.layers.reduce_sum(fluid.layers.square(x))
        return fluid.gradients([y], [x])

    built = _both(build)
    _same_programs(built)
    x = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    got = {}
    for name, (fluid, _) in PKGS.items():
        main, _, (g,) = built[name]
        got[name] = np.asarray(fluid.Executor(fluid.CPUPlace()).run(
            main, feed={"x": x}, fetch_list=[g], scope=fluid.Scope())[0])
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=1e-6)
    np.testing.assert_allclose(got["torch"], 2 * x, rtol=1e-6)


def test_weight_norm_param_attr_builds_the_same_fc():
    """WeightNormParamAttr is a ParamAttr with a dim in both packages: an fc
    built with it has the same program, and from the JAX package's
    parameters the same output."""
    def build(fluid):
        x = fluid.layers.data("x", [5])
        return fluid.layers.fc(x, 3, param_attr=fluid.WeightNormParamAttr(dim=0, name="wn_w"))

    built = _both(build)
    _same_programs(built)
    assert tfluid.WeightNormParamAttr(dim=1).dim == 1
    assert isinstance(tfluid.WeightNormParamAttr(), tfluid.ParamAttr)
    jm, js, jo = built["jax"]
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name)) for v in jm.list_vars() if v.persistable}
    assert "wn_w" in state
    tscope = tfluid.Scope()
    tfluid.io.load_numpy_params(tscope, state)
    x = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    want = jexe.run(jm, feed={"x": x}, fetch_list=[jo], scope=jscope)[0]
    tm, _, to = built["torch"]
    got = tfluid.Executor(tfluid.CPUPlace()).run(tm, feed={"x": x}, fetch_list=[to], scope=tscope)[0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_places_compiler_and_dygraph_mode(monkeypatch):
    monkeypatch.setenv("CPU_NUM", "3")
    for fluid, _ in PKGS.values():
        assert [type(p).__name__ for p in fluid.cpu_places()] == ["CPUPlace"] * 3
        assert len(fluid.cpu_places(2)) == 2
        assert [type(p).__name__ for p in fluid.cuda_pinned_places()] == ["CUDAPinnedPlace"] * 3
        assert fluid.compiler.CompiledProgram is fluid.CompiledProgram
        assert fluid.in_dygraph_mode() is False
        with fluid.dygraph.guard(fluid.CPUPlace()):
            assert fluid.in_dygraph_mode() is True
        assert fluid.in_dygraph_mode() is False
    import torch

    assert len(tfluid.cuda_places()) == torch.cuda.device_count()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CPUPlace"):
            tfluid.cuda_places([0])
    # a pinned place runs a program on the host, as CPUPlace does
    built = _both(lambda fluid: fluid.layers.scale(fluid.layers.data("x", [2]), scale=3.0))
    tm, _, out = built["torch"]
    got = tfluid.Executor(tfluid.CUDAPinnedPlace()).run(
        tm, feed={"x": np.ones((2, 2), np.float32)}, fetch_list=[out], scope=tfluid.Scope())[0]
    np.testing.assert_array_equal(got, np.full((2, 2), 3.0, np.float32))


def test_create_random_int_lodtensor():
    for fluid, _ in PKGS.values():
        np.random.seed(3)
        t = fluid.create_random_int_lodtensor([[2, 4, 1]], [3], fluid.CPUPlace(), 5, 9)
        assert t.recursive_sequence_lengths() == [[2, 4, 1]]
        assert all(s.shape[1:] == (3,) and s.dtype == np.int64 for s in t.sequences)
        flat = np.concatenate(t.sequences)
        assert flat.min() >= 5 and flat.max() <= 9
    np.random.seed(3)
    a = jfluid.create_random_int_lodtensor([[2, 4]], [3], None, 0, 100)
    np.random.seed(3)
    b = tfluid.create_random_int_lodtensor([[2, 4]], [3], None, 0, 100)
    for x, y in zip(a.sequences, b.sequences):
        np.testing.assert_array_equal(x, y)


def test_flag_definitions_and_init_from_env(monkeypatch):
    for fluid, _ in PKGS.values():
        fl = fluid.flags
        fl.DEFINE_bool("FLAGS_a12_bool", False, "a bool")
        fl.DEFINE_int("FLAGS_a12_int", 3)
        fl.DEFINE_float("FLAGS_a12_float", 0.5)
        fl.DEFINE_string("FLAGS_a12_str", "x")
        assert {"FLAGS_a12_bool", "FLAGS_a12_int", "FLAGS_check_nan_inf"} <= set(fl.all_flags())
        assert fl.all_flags() == sorted(fl.all_flags())
        monkeypatch.setenv("FLAGS_a12_bool", "on")
        monkeypatch.setenv("FLAGS_a12_int", "7")
        monkeypatch.setenv("FLAGS_a12_float", "2.25")
        fl.init_from_env()
        assert fluid.get_flags(["FLAGS_a12_bool", "FLAGS_a12_int", "FLAGS_a12_float",
                                "FLAGS_a12_str"]) == {
            "FLAGS_a12_bool": True, "FLAGS_a12_int": 7, "FLAGS_a12_float": 2.25,
            "FLAGS_a12_str": "x"}
        for n in ("FLAGS_a12_bool", "FLAGS_a12_int", "FLAGS_a12_float"):
            monkeypatch.delenv(n)


def test_analysis_config_knobs_and_summary(tmp_path):
    """The knobs the JAX package records are recorded and shown alike;
    disable_tpu / enable_tpu pick the CPU or the card."""
    built = _both(lambda fluid: fluid.layers.fc(fluid.layers.data("x", [4]), 2))
    sums = {}
    for name, (fluid, _) in PKGS.items():
        main, startup, out = built[name]
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        d = str(tmp_path / name)
        fluid.io.save_inference_model(d, ["x"], [out], exe, main_program=main, scope=scope)
        cfg = fluid.inference.AnalysisConfig(d, fluid.CPUPlace())
        assert cfg.disable_tpu() is cfg
        cfg.switch_ir_optim(False).enable_memory_optim(False)
        cfg.set_cpu_math_library_num_threads(4).enable_quantize(False)
        sums[name] = dict(cfg.summary(), model_dir=os.path.basename(cfg.model_dir))
        pred = fluid.inference.create_predictor(cfg)
        assert pred.run({"x": np.ones((2, 4), np.float32)})[0].shape == (2, 2)
        assert fluid.inference.PredictConfig is fluid.inference.AnalysisConfig
    assert dict(sums["torch"], model_dir="") == dict(sums["jax"], model_dir="")
    assert sums["torch"]["place"] == "CPUPlace" and sums["torch"]["threads"] == 4
    import torch

    cfg = tfluid.inference.AnalysisConfig(str(tmp_path / "torch"), tfluid.CPUPlace())
    if torch.cuda.is_available():
        assert type(cfg.enable_tpu(0).place).__name__ == "CUDAPlace"
    else:
        with pytest.raises(RuntimeError, match="CPUPlace"):
            cfg.enable_tpu(0)


# --- layers -------------------------------------------------------------------------------

def _run_both(built, feed, fetch):
    """Run each package's main (after its startup) and fetch fetch(result)."""
    got = {}
    for name, (fluid, _) in PKGS.items():
        main, startup, res = built[name]
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        got[name] = [np.asarray(v) for v in exe.run(main, feed=feed, fetch_list=fetch(res),
                                                    scope=scope)]
    return got


def test_tensor_and_tail_layers_build_and_run_alike():
    """zeros, ones, sum, rank, create_tensor, create_parameter,
    autoincreased_step_counter, dice_loss, npair_loss and pad_constant_like:
    the same programs, and from the same parameters the same values."""
    def build(fluid):
        L = fluid.layers
        x = L.data("x", [4])
        y = L.data("y", [4])
        lab = L.data("lab", [1], dtype="int64")
        z, o = L.zeros([2, 3], "float32"), L.ones([2, 3], "int32")
        s = L.sum([x, y, x])
        r = L.rank(x)
        t = L.create_tensor("float32", name="a12_tensor")
        p = L.create_parameter([4], "float32", name="a12_param",
                               default_initializer=fluid.initializer.ConstantInitializer(0.5))
        step = L.autoincreased_step_counter(begin=3, step=2)
        probs = L.softmax(x)
        dice = L.dice_loss(probs, L.cast(L.ones([5, 4], "float32"), "float32"))
        npair = L.npair_loss(x, y, lab)
        small = L.data("small", [2, 3], append_batch_size=False)
        padded = L.pad_constant_like(L.data("big", [4, 5], append_batch_size=False), small, 1.5)
        return [z, o, s, r, p, step, dice, npair, padded, L.elementwise_mul(x, p)], t

    built = _both(build)
    _same_programs(built)
    assert built["torch"][2][1].name == "a12_tensor"
    rng = np.random.RandomState(2)
    feed = {"x": rng.randn(5, 4).astype(np.float32), "y": rng.randn(5, 4).astype(np.float32),
            "lab": rng.randint(0, 3, (5, 1)).astype(np.int64),
            "small": rng.randn(2, 3).astype(np.float32), "big": np.zeros((4, 5), np.float32)}
    got = _run_both(built, feed, lambda res: res[0])
    for w, g in zip(got["jax"], got["torch"]):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=1e-5,
                                   atol=1e-6)
    assert int(got["torch"][5].reshape(-1)[0]) == 3


def test_reader_aliases_and_load():
    """layers.batch / shuffle / double_buffer are the reader decorators (the
    same batches in both packages); layers.load raises in both."""
    def reader():
        for i in range(7):
            yield (np.full((2,), i, np.float32),)

    outs = {}
    for name, (fluid, _) in PKGS.items():
        L = fluid.layers
        outs[name] = [[a.tolist() for (a,) in b] for b in L.double_buffer(L.batch(reader, 3))()]
        shuffled = [s[0].tolist() for s in L.shuffle(reader, 4)()]
        assert sorted(shuffled) == [[float(i)] * 2 for i in range(7)]
        with pytest.raises(NotImplementedError):
            L.load(None, "nowhere")
    assert outs["torch"] == outs["jax"]


def test_layers_re_exports():
    from paddle_tpu_torch.core.dtypes import canonical_dtype
    from paddle_tpu_torch.core.layer_helper import LayerHelper

    L = tfluid.layers
    assert L.Variable is tfluid.Variable and L.LayerHelper is LayerHelper
    assert L.canonical_dtype is canonical_dtype and L.canonical_dtype("int64") == "int64"
    L.dropout_prob_check(0.5)
    for p in (-0.1, 1.0):
        with pytest.raises(ValueError):
            L.dropout_prob_check(p)
        with pytest.raises(ValueError):
            jfluid.layers.dropout_prob_check(p)


# --- metrics, evaluator, debugger ---------------------------------------------------------

def test_metrics_give_the_same_values():
    rng = np.random.RandomState(5)
    preds = rng.rand(40, 2).astype(np.float32)
    labels = rng.randint(0, 2, (40, 1))
    vals = {}
    for name, (fluid, _) in PKGS.items():
        m = fluid.metrics
        acc, prec, rec, auc = m.Accuracy(), m.Precision(), m.Recall(), m.Auc(num_thresholds=200)
        ed, comp = m.EditDistance(), m.CompositeMetric()
        comp.add_metric(m.Precision())
        comp.add_metric(m.Recall())
        for k in range(4):
            sl = slice(10 * k, 10 * k + 10)
            acc.update(value=float(preds[sl, 1].mean()), weight=10)
            prec.update(preds[sl, 1], labels[sl])
            rec.update(preds[sl, 1], labels[sl])
            auc.update(preds[sl], labels[sl])
            comp.update(preds[sl, 1], labels[sl])
            ed.update(np.array([0.0, 2.0, 1.0]) * k, 3)
        vals[name] = [acc.eval(), prec.eval(), rec.eval(), auc.eval(), ed.eval(), comp.eval(),
                      m.edit_distance_np("kitten", "sitting")]
        prec.reset()
        assert prec.tp == 0.0 and prec.eval() == 0.0
        with pytest.raises(ValueError):
            m.Accuracy().eval()
        assert fluid.evaluator.Auc is m.Auc
        with pytest.raises(NotImplementedError):
            fluid.evaluator.ChunkEvaluator()
    assert vals["torch"] == vals["jax"]
    assert vals["torch"][-1] == 3


def test_debugger_draws_the_same_graph(tmp_path):
    built = _both(_fit_a_line)
    dots = {}
    for name, (fluid, _) in PKGS.items():
        main = built[name][0]
        dots[name] = fluid.debugger.draw_block_graphviz(
            main.global_block(), path=str(tmp_path / f"{name}.dot"), highlights=["x"])
        assert open(tmp_path / f"{name}.dot").read() == dots[name]
        assert set(fluid.debugger.draw_program(main)) == {0}
    assert dots["torch"] == dots["jax"] and dots["torch"].startswith("digraph G {")


# --- the layers over the last op files, by to_dict ------------------------------------------

def _x(fluid, shape, name="x", dtype="float32", lod_level=0):
    return fluid.layers.data(name, shape, dtype=dtype, lod_level=lod_level)


LAYER_BUILDS = {
    "losses": lambda f, L: [
        L.log_loss(L.sigmoid(_x(f, [1])), _x(f, [1], "y")),
        L.rank_loss(_x(f, [1], "l"), _x(f, [1], "a"), _x(f, [1], "b")),
        L.margin_rank_loss(_x(f, [1], "l2"), _x(f, [1], "a2"), _x(f, [1], "b2"), margin=0.2),
        L.bpr_loss(_x(f, [5], "p"), _x(f, [1], "lab", "int64")),
        L.kldiv_loss(_x(f, [5], "k1"), _x(f, [5], "k2"), reduction="sum"),
        L.hinge_loss(_x(f, [1], "h1"), _x(f, [1], "h2")),
        L.smooth_l1(_x(f, [3], "s1"), _x(f, [3], "s2"), sigma=2.0),
        L.teacher_student_sigmoid_loss(_x(f, [1], "t1"), _x(f, [1], "t2")),
        L.cos_sim(_x(f, [4], "c1"), _x(f, [4], "c2"))],
    "activations": lambda f, L: [
        L.selu(_x(f, [3])), L.brelu(_x(f, [3], "b"), t_min=1.0, t_max=5.0),
        L.soft_relu(_x(f, [3], "s"), threshold=10.0), L.thresholded_relu(_x(f, [3], "t")),
        L.lrn(_x(f, [6, 3, 3], "img"), n=3), L.maxout(_x(f, [6, 3, 3], "img2"), groups=2),
        L.affine_channel(_x(f, [3, 4, 4], "img3"), _x(f, [3], "sc", lod_level=0),
                         _x(f, [3], "bi"))],
    "tensors": lambda f, L: [
        L.multiplex([_x(f, [3], "m1"), _x(f, [3], "m2")], _x(f, [1], "ids", "int32")),
        L.reverse(_x(f, [4, 2]), [0, 2]), L.diag(_x(f, [5], "d", )),
        L.logical_xor(_x(f, [3], "b1", "bool"), _x(f, [3], "b2", "bool")),
        L.reduce_all(_x(f, [3], "b3", "bool"), dim=1), L.reduce_any(_x(f, [3], "b4", "bool")),
        L.has_inf(_x(f, [3], "f1")), L.has_nan(_x(f, [3], "f2")), L.is_empty(_x(f, [3], "f3")),
        L.pixel_shuffle(_x(f, [8, 2, 2], "ps"), 2), L.shuffle_channel(_x(f, [6, 2, 2], "sc"), 3),
        L.temporal_shift(_x(f, [8, 2, 2], "ts"), 2), L.fsp_matrix(_x(f, [3, 4, 4], "fa"),
                                                                  _x(f, [2, 4, 4], "fb")),
        L.unfold(_x(f, [3, 6, 6], "uf"), [2, 2], strides=2)],
    "spatial": lambda f, L: [
        L.conv3d(_x(f, [2, 4, 5, 5]), 3, 3, padding=1, act="relu"),
        L.pool3d(_x(f, [2, 4, 4, 4], "p3"), pool_size=2, pool_type="avg", pool_stride=2,
                 ceil_mode=True),
        L.affine_grid(_x(f, [2, 3], "theta"), [2, 1, 4, 5]),
        L.grid_sampler(_x(f, [3, 4, 5], "img"), _x(f, [4, 5, 2], "grid")),
        L.adaptive_pool2d(_x(f, [3, 7, 5], "ap"), [3, 2], pool_type="avg"),
        L.adaptive_pool3d(_x(f, [2, 5, 4, 6], "ap3"), [2, 2, 2]),
        L.im2sequence(_x(f, [2, 6, 6], "i2s"), filter_size=2, stride=2),
        L.spectral_norm(f.layers.create_parameter([6, 4], "float32", name="sn_w"), dim=0,
                        power_iters=2)],
    "sequences": lambda f, L: [
        L.row_conv(_x(f, [3], "rc", lod_level=1), 2),
        L.edit_distance(_x(f, [1], "hyp", "int64", 1), _x(f, [1], "ref", "int64", 1)),
        L.ctc_greedy_decoder(_x(f, [5], "ctc", lod_level=1), blank=0),
        L.chunk_eval(_x(f, [1], "inf", "int64", 1), _x(f, [1], "lab", "int64", 1), "IOB", 2),
        L.add_position_encoding(_x(f, [6, 4], "pe"), 0.5, 2.0)],
    "classifiers": lambda f, L: [
        L.nce(_x(f, [8]), _x(f, [1], "lab", "int64"), 20, num_neg_samples=5,
              sampler="log_uniform"),
        L.nce(_x(f, [8], "x2"), _x(f, [1], "lab2", "int64"), 20, num_neg_samples=3,
              custom_dist=np.full(20, 0.05, np.float32)),
        L.hsigmoid(_x(f, [8], "x3"), _x(f, [1], "lab3", "int64"), 11),
        L.sampled_softmax_with_cross_entropy(_x(f, [30], "lg"), _x(f, [1], "lab4", "int64"), 5),
        L.bilinear_tensor_product(_x(f, [3], "bx"), _x(f, [4], "by"), 2),
        L.tree_conv(_x(f, [6, 4], "nodes"), _x(f, [5, 2], "edges", "int32"), 3, num_filters=2,
                    max_depth=2),
        L.similarity_focus(_x(f, [3, 4, 5], "sf"), axis=1, indexes=[0]),
        L.hash(_x(f, [2], "hx", "int32"), hash_size=100, num_hash=2)],
    "fillers_and_norms": lambda f, L: [
        L.fill_constant_batch_size_like(_x(f, [3]), [-1, 5], "float32", 2.0),
        L.uniform_random_batch_size_like(_x(f, [3], "u"), [-1, 4]),
        L.gaussian_random_batch_size_like(_x(f, [3], "g"), [-1, 4], mean=1.0, std=0.5),
        L.sampling_id(L.softmax(_x(f, [6], "probs"))),
        L.random_crop(_x(f, [3, 6, 6], "rc"), [3, 4, 4]),
        L.continuous_value_model(_x(f, [5], "cv"), _x(f, [2], "cvm"), use_cvm=True),
        L.data_norm(_x(f, [4], "dn")),
        L.get_tensor_from_selected_rows(_x(f, [3], "sr")),
        L.merge_selected_rows(_x(f, [3], "sr2"))],
}


@pytest.mark.parametrize("group", sorted(LAYER_BUILDS))
def test_last_op_files_layers_build_the_same_programs(group):
    built = _both(lambda fluid: LAYER_BUILDS[group](fluid, fluid.layers))
    _same_programs(built)

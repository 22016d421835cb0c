"""The SelectedRows slice on the CPU against the JAX package (a twin of
tests/test_sparse_ctr.py).

An `is_sparse=True` embedding's gradient is a SelectedRows slab (rows and
one gradient row each), never a dense V x D tensor; the update ops merge
repeated rows and touch only those rows.  Programs are built by both
packages; the JAX package's persistable state after its startup goes to the
port through `io.load_numpy_params`, and both train on the same numpy feeds.
Tolerances: losses 1e-5; every persistable 1e-5 of max(1, its largest
magnitude) (float32 throughout; the two packages sum in other orders)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import lowering as j_lowering
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.core.selected_rows import SelectedRows as JSelectedRows
from paddle_tpu.models import deepfm as j_deepfm
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.models import deepfm as t_deepfm
from paddle_tpu_torch.ops import cuda_kernels as ck
from paddle_tpu_torch.ops import optimizer_ops

TOL = 1e-5
OPTS = ["sgd", "momentum", "adagrad", "adam"]


@pytest.fixture(autouse=True)
def launches_unchanged():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before, "a CPU run must not count a kernel launch"


def _pkg(name):
    return (jfluid, j_unique) if name == "jax" else (tfluid, tfluid.unique_name)


def _optimizer(fluid, name, lazy=False):
    return {"sgd": lambda: fluid.optimizer.SGD(0.1),
            "adagrad": lambda: fluid.optimizer.Adagrad(0.1),
            "momentum": lambda: fluid.optimizer.Momentum(0.1, 0.9),
            "adam": lambda: fluid.optimizer.Adam(0.05, lazy_mode=lazy)}[name]()


def _embedding_model(pkg, is_sparse, opt_name, lazy=False, vocab=50, dim=4, padding_idx=None,
                     n_ids=3):
    """ids [B, n_ids] -> embedding [vocab, dim] -> fc(1) -> mean squared error;
    returns (main, startup, loss name, table name)."""
    fluid, unique = _pkg(pkg)
    main, startup = fluid.Program(), fluid.Program()
    with unique.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", [n_ids], dtype="int64")
        label = fluid.layers.data("label", [1], dtype="float32")
        emb = fluid.layers.embedding(ids, size=[vocab, dim], is_sparse=is_sparse,
                                     padding_idx=padding_idx, param_attr=fluid.ParamAttr(name="tbl"))
        flat = fluid.layers.reshape(emb, [-1, n_ids * dim])
        pred = fluid.layers.fc(flat, 1, param_attr=fluid.ParamAttr(name="fcw"))
        loss = fluid.layers.mean(fluid.layers.square(pred - label))
        _optimizer(fluid, opt_name, lazy).minimize(loss)
    return main, startup, loss.name, "tbl"


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _jax_start(main, startup):
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    return exe, scope, {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}


def _torch_start(state):
    scope = tfluid.Scope()
    tfluid.io.load_numpy_params(scope, state)
    return tfluid.Executor(tfluid.CPUPlace()), scope


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= TOL * max(1.0, float(np.abs(want).max()) if want.size else 0.0), (what, err)


def _feeds(steps=6, batch=8, vocab=50, n_ids=3):
    """Id batches with heavy repetition (MergeAdd's work) and labels."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, vocab, size=(steps, batch, n_ids))
    ids[:, ::2, :] = ids[:, :1, :]
    labels = rng.rand(steps, batch, 1).astype("f4")
    return [{"ids": i, "label": lab} for i, lab in zip(ids, labels)]


def _train(pkg, main, loss, exe, scope, feeds):
    return [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0])
                  .reshape(-1)[0]) for f in feeds]


def test_selected_rows_merged_matches_jax():
    rows = np.array([5, 2, 5, 9, 2, 2, 10], np.int32)  # 10 == height: dropped
    vals = np.arange(14, dtype=np.float32).reshape(7, 2)
    want = np.asarray(JSelectedRows(jnp.asarray(rows), jnp.asarray(vals), 10).merged().to_dense())
    sr = SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals), 10)
    m = sr.merged()
    assert m.rows.tolist() == [2, 5, 9, 10] and m.rows.dtype == torch.int32
    np.testing.assert_array_equal(m.values.numpy(), [[20, 23], [4, 6], [6, 7], [12, 13]])
    np.testing.assert_allclose(m.to_dense().numpy(), want, atol=1e-6)
    np.testing.assert_allclose(np.asarray(sr), want, atol=1e-6)
    assert sr.shape == (10, 2)
    empty = SelectedRows(torch.zeros(0, dtype=torch.int32), torch.zeros(0, 2), 10)
    assert empty.merged() is empty and not empty.to_dense().any()


@pytest.mark.parametrize("opt_name", OPTS)
def test_sparse_training_matches_jax(opt_name):
    """Sparse tables in both packages: the same losses and the same state,
    duplicate-heavy ids included."""
    feeds = _feeds()
    jm, js, jl, tbl = _embedding_model("jax", True, opt_name)
    tm, _, tl, _ = _embedding_model("torch", True, opt_name)
    jexe, jscope, state = _jax_start(jm, js)
    texe, tscope = _torch_start(state)
    jlosses = _train("jax", jm, jl, jexe, jscope, feeds)
    tlosses = _train("torch", tm, tl, texe, tscope, feeds)
    assert j_lowering.LAST_TRACE_REPORT["sparse_grad_params"] == [tbl]
    np.testing.assert_allclose(tlosses, jlosses, atol=TOL, rtol=0)
    for name in _persistables(jm):
        _close(tscope.to_numpy(name), jscope.find_var(name), name)


@pytest.mark.parametrize("opt_name", ["sgd", "adagrad", "adam"])
def test_sparse_matches_dense_training(opt_name):
    """SGD and Adagrad leave a row with a zero gradient alone, and Adam
    densifies a SelectedRows gradient by default: sparse and dense tables
    train alike in the port."""
    feeds = _feeds()
    _, _, state = _jax_start(*_embedding_model("jax", False, opt_name)[:2])
    tables, losses = [], []
    for is_sparse in (False, True):
        tm, ts, tl, tbl = _embedding_model("torch", is_sparse, opt_name)
        texe, tscope = _torch_start(state)
        losses.append(_train("torch", tm, tl, texe, tscope, feeds))
        tables.append(tscope.to_numpy(tbl))
    np.testing.assert_allclose(losses[1], losses[0], atol=TOL, rtol=0)
    _close(tables[1], tables[0], "tbl")


@pytest.mark.parametrize("opt_name,lazy", [("momentum", False), ("adam", True)])
def test_lazy_updates_leave_untouched_rows(opt_name, lazy):
    """Sparse momentum and lazy_mode Adam update the touched rows only: the
    untouched rows of the table and of every accumulator keep their exact
    values; the beta powers advance."""
    jm, js, jl, tbl = _embedding_model("jax", True, opt_name, lazy)
    tm, _, tl, _ = _embedding_model("torch", True, opt_name, lazy)
    jexe, jscope, state = _jax_start(jm, js)
    texe, tscope = _torch_start(state)
    ids = np.array([[1, 2, 3], [1, 2, 7]], np.int64)
    feeds = [{"ids": ids, "label": np.ones((2, 1), "f4")}] * 3
    _train("jax", jm, jl, jexe, jscope, feeds)
    _train("torch", tm, tl, texe, tscope, feeds)
    touched = sorted(set(ids.reshape(-1).tolist()))
    untouched = [r for r in range(50) if r not in touched]
    row_state = [n for n in _persistables(tm) if n == tbl or n.startswith(tbl + "_")
                 and "pow" not in n]
    assert len(row_state) == (2 if opt_name == "momentum" else 3)
    for name in row_state:
        after = tscope.to_numpy(name)
        np.testing.assert_array_equal(after[untouched], state[name][untouched], err_msg=name)
        assert np.abs(after[touched] - state[name][touched]).max() > 1e-7, name
        _close(after, jscope.find_var(name), name)
    for name in _persistables(tm):
        if "pow" in name:
            _close(tscope.to_numpy(name), state[name] * 0.9 ** 3 if "beta1" in name
                   else state[name] * 0.999 ** 3, name)


def test_padding_idx_rows_get_no_gradient():
    """The tap precedes the padding mask: the gradient of padding_idx's row
    is 0, so SGD leaves it exactly; the fetched @GRAD is the JAX package's
    dense view, and without return_numpy the SelectedRows itself."""
    jm, js, jl, tbl = _embedding_model("jax", True, "sgd", padding_idx=0, vocab=20, n_ids=4)
    tm, _, tl, _ = _embedding_model("torch", True, "sgd", padding_idx=0, vocab=20, n_ids=4)
    jexe, jscope, state = _jax_start(jm, js)
    texe, tscope = _torch_start(state)
    feed = {"ids": np.array([[0, 1, 2, 0], [0, 3, 1, 0]], np.int64), "label": np.ones((2, 1), "f4")}
    for _ in range(2):
        want = jexe.run(jm, feed=feed, fetch_list=[jl, tbl + "@GRAD"], scope=jscope)
        got = texe.run(tm, feed=feed, fetch_list=[tl, tbl + "@GRAD"], scope=tscope)
        _close(got[0], want[0], "loss")
        assert got[1].shape == (20, 4)
        _close(got[1], np.asarray(want[1]), "tbl@GRAD")
        assert not got[1][0].any() and np.abs(got[1][1]).max() > 0
    after = tscope.to_numpy(tbl)
    np.testing.assert_array_equal(after[0], state[tbl][0])
    assert np.abs(after[1] - state[tbl][1]).max() > 1e-7
    (sr,) = texe.run(tm, feed=feed, fetch_list=[tbl + "@GRAD"], scope=tscope, return_numpy=False)
    assert isinstance(sr, SelectedRows)
    assert sr.rows.tolist() == feed["ids"].reshape(-1).tolist() and sr.values.shape == (8, 4)


def test_sparse_gradient_into_a_dense_only_update_raises():
    """An update op without a SelectedRows branch refuses one, as the JAX
    package's register_opt does (the port's only updates are all four
    sparse-capable, so the test registers a dense-only one)."""
    name = "dense_only_update_for_test"
    optimizer_ops.register_opt(name)(
        lambda ctx, op, ins: {"ParamOut": ins["Param"][0] - ins["Grad"][0]})
    try:
        tm, ts, tl, tbl = _embedding_model("torch", True, "sgd")
        for op in tm.global_block().ops:
            if op.type == "sgd" and op.input("Param") == [tbl]:
                op.type = name
        _, _, state = _jax_start(*_embedding_model("jax", True, "sgd")[:2])
        texe, tscope = _torch_start(state)
        with pytest.raises(NotImplementedError, match="SelectedRows"):
            _train("torch", tm, tl, texe, tscope, _feeds(steps=1))
    finally:
        registry._REGISTRY.pop(name)


def _wire_found_inf(main, op_types):
    """A fed bool [1] `found_inf` wired as FoundInf into every op of
    `op_types`, as contrib/mixed_precision's decorator wires its flag."""
    block = main.global_block()
    block.create_var("found_inf", shape=(1,), dtype="bool", is_data=True)
    wired = 0
    for op in block.ops:
        if op.type in op_types:
            op.inputs["FoundInf"] = ["found_inf"]
            wired += 1
    assert wired
    return main


@pytest.mark.parametrize("opt_name", OPTS)
def test_update_ops_apply_found_inf(opt_name):
    """AMP's FoundInf (contrib/mixed_precision) as the JAX package applies
    it: on a step with the flag set every output state (parameters,
    accumulators, beta powers) is bit for bit the input's, dense and
    SelectedRows gradients alike (the sparse branch of each update; Adam's
    lazy one, and the densifying one through the in-place kernel's plain
    version); with it clear the step is the JAX package's (TOL).  The flag
    is a device tensor: no host read."""
    for is_sparse, lazy in ((False, False), (True, False), (True, True)):
        if lazy and opt_name != "adam":
            continue
        models = {pkg: _wire_found_inf(_embedding_model(pkg, is_sparse, opt_name, lazy)[0],
                                       {opt_name})
                  for pkg in ("jax", "torch")}
        _, js, jl, _ = _embedding_model("jax", is_sparse, opt_name, lazy)
        _, _, tl, _ = _embedding_model("torch", is_sparse, opt_name, lazy)
        jexe, jscope, state = _jax_start(models["jax"], js)
        texe, tscope = _torch_start(state)
        names = _persistables(models["jax"])
        feeds = _feeds(steps=3)
        for step, (feed, skip) in enumerate(zip(feeds, (True, False, True))):
            before = {n: tscope.to_numpy(n).copy() for n in names}
            f = dict(feed, found_inf=np.array([skip]))
            jexe.run(models["jax"], feed=f, fetch_list=[jl], scope=jscope)
            texe.run(models["torch"], feed=f, fetch_list=[tl], scope=tscope)
            for n in names:
                got = tscope.to_numpy(n)
                assert got.dtype == before[n].dtype, n
                if skip:
                    np.testing.assert_array_equal(got, before[n], err_msg=f"{n} step {step}")
                _close(got, np.asarray(jscope.find_var(n)), f"{n} step {step}")
        assert any(not np.array_equal(tscope.to_numpy(n), state[n]) for n in names)


# the updates the JAX package registers with register_op, not register_opt,
# that an optimizer's apply_gradients returns: they ignore FoundInf there
# (ROADMAP C, "Reference-side defects"), and the port matches it
IGNORING = {"decayed_adagrad": (lambda fluid: fluid.optimizer.DecayedAdagrad(0.1),
                                {"decayed_adagrad"}),
            "dgc": (lambda fluid: fluid.optimizer.DGCMomentum(0.1, 0.9, rampup_begin_step=0,
                                                              sparsity=[0.9]),
                    {"dgc", "momentum"})}


@pytest.mark.parametrize("update", list(IGNORING))
def test_register_op_updates_apply_an_overflowed_step_as_the_jax_package(update):
    """decayed_adagrad and dgc with FoundInf set still apply their step, in
    both packages alike (the JAX package's register_op does not read the
    flag); dgc's momentum, a register_opt update, skips.  The table has
    16384 elements, so DGCMomentum compresses its gradient."""
    make, wire = IGNORING[update]
    models = {}
    for pkg in ("jax", "torch"):
        fluid, unique = _pkg(pkg)
        main, startup = fluid.Program(), fluid.Program()
        with unique.guard(), fluid.program_guard(main, startup):
            ids = fluid.layers.data("ids", [3], dtype="int64")
            label = fluid.layers.data("label", [1], dtype="float32")
            emb = fluid.layers.embedding(ids, size=[4096, 4],
                                         param_attr=fluid.ParamAttr(name="tbl"))
            pred = fluid.layers.fc(fluid.layers.reshape(emb, [-1, 12]), 1)
            loss = fluid.layers.mean(fluid.layers.square(pred - label))
            make(fluid).minimize(loss)
        models[pkg] = (_wire_found_inf(main, wire), startup, loss.name)
    assert update in [op.type for op in models["torch"][0].global_block().ops]
    jexe, jscope, state = _jax_start(*models["jax"][:2])
    texe, tscope = _torch_start(state)
    names = _persistables(models["jax"][0])
    for feed in _feeds(steps=2, vocab=4096):
        f = dict(feed, found_inf=np.array([True]))
        jexe.run(models["jax"][0], feed=f, fetch_list=[models["jax"][2]], scope=jscope)
        texe.run(models["torch"][0], feed=f, fetch_list=[models["torch"][2]], scope=tscope)
    moved = [n for n in names if not np.array_equal(tscope.to_numpy(n), state[n])]
    for n in names:
        _close(tscope.to_numpy(n), np.asarray(jscope.find_var(n)), n)
    assert moved, "the register_op update applied no step"
    if update == "dgc":  # momentum skipped: the parameters keep their bits
        np.testing.assert_array_equal(tscope.to_numpy("tbl"), state["tbl"])


def test_table_read_by_two_lookups_concatenates_and_an_unread_table_is_empty():
    """Two lookups of one table give one SelectedRows of both slabs; the
    gradient matches the JAX package's, and a sparse table the loss never
    reads gets an empty slab."""
    grads = []
    for pkg in ("jax", "torch"):
        fluid, unique = _pkg(pkg)
        main, startup = fluid.Program(), fluid.Program()
        with unique.guard(), fluid.program_guard(main, startup):
            a = fluid.layers.data("a", [2], dtype="int64")
            b = fluid.layers.data("b", [3], dtype="int64")
            attr = fluid.ParamAttr(name="shared")
            ea = fluid.layers.embedding(a, size=[10, 3], is_sparse=True, param_attr=attr)
            eb = fluid.layers.embedding(b, size=[10, 3], is_sparse=True, param_attr=attr)
            fluid.layers.embedding(b, size=[10, 3], is_sparse=True,
                                   param_attr=fluid.ParamAttr(name="unread"))
            loss = fluid.layers.mean(fluid.layers.elementwise_add(
                fluid.layers.reduce_sum(fluid.layers.square(ea), dim=[1]),
                fluid.layers.reduce_sum(eb, dim=[1])))
            fluid.optimizer.SGD(0.1).minimize(loss)
        if pkg == "jax":
            exe, scope, state = _jax_start(main, startup)
        else:
            exe, scope = _torch_start(state)
        feed = {"a": np.array([[1, 2], [2, 4]], np.int64), "b": np.array([[1, 5, 5], [9, 0, 1]],
                                                                         np.int64)}
        grads.append(exe.run(main, feed=feed, fetch_list=["shared@GRAD", "unread@GRAD"],
                             scope=scope, return_numpy=False))
    (js, ju), (ts, tu) = grads
    assert ts.rows.tolist() == [1, 2, 2, 4, 1, 5, 5, 9, 0, 1]
    _close(np.asarray(ts), np.asarray(js), "shared@GRAD")
    assert isinstance(tu, SelectedRows) and tu.rows.numel() == 0 and tu.values.shape == (0, 3)


_DEEPFM_TINY = dict(num_fields=4, vocab_size=50, embed_dim=4, mlp_dims=(8,))  # build_zoo(tiny=True)


def _deepfm(pkg, opt_name, lazy=False, clip_decay=False):
    """Tiny DeepFM with Adagrad(0.05), Adam(0.05) or lazy Adam(0.05); with
    `clip_decay`, L2Decay(0.01) and GradientClipByGlobalNorm(0.05) too."""
    fluid, unique = _pkg(pkg)
    deepfm = j_deepfm if pkg == "jax" else t_deepfm
    with unique.guard():
        main, startup, _, fetches = deepfm.build(learning_rate=0.05, with_optimizer=False,
                                                 **_DEEPFM_TINY)
        with fluid.program_guard(main, startup):
            kw = {}
            if clip_decay:
                fluid.clip.set_gradient_clip(fluid.clip.GradientClipByGlobalNorm(0.05))
                kw["regularization"] = fluid.regularizer.L2Decay(0.01)
            opt = (fluid.optimizer.Adagrad(0.05, **kw) if opt_name == "adagrad"
                   else fluid.optimizer.Adam(0.05, lazy_mode=lazy, **kw))
            opt.minimize(fetches["loss"])
    return main, startup, fetches["loss"].name


@pytest.mark.parametrize("opt_name,lazy", [("adagrad", False), ("adam", False), ("adam", True)],
                         ids=["adagrad", "adam", "lazy_adam"])
def test_tiny_deepfm_three_steps_match_jax(opt_name, lazy):
    """build_zoo(tiny=True)'s DeepFM (4 fields, vocab 50, embed 4, MLP 8),
    3 steps from one numpy state on one fixed batch: losses and every
    persistable agree, and only the touched rows of the tables move (dense
    Adam's zero gradient rows keep zero moments, so they stay too)."""
    jm, js, jl = _deepfm("jax", opt_name, lazy)
    tm, _, tl = _deepfm("torch", opt_name, lazy)
    assert [op.type for op in tm.global_block().ops] == [op.type for op in jm.global_block().ops]
    jexe, jscope, state = _jax_start(jm, js)
    texe, tscope = _torch_start(state)
    rng = np.random.RandomState(0)
    feed = {"feat_ids": rng.randint(0, 50, (4, 4)).astype("i4"),
            "label": (rng.rand(4, 1) < 0.3).astype("f4")}
    jlosses = _train("jax", jm, jl, jexe, jscope, [feed] * 3)
    tlosses = _train("torch", tm, tl, texe, tscope, [feed] * 3)
    assert sorted(j_lowering.LAST_TRACE_REPORT["sparse_grad_params"]) == ["deepfm_v", "deepfm_w"]
    np.testing.assert_allclose(tlosses, jlosses, atol=TOL, rtol=0)
    assert tlosses[-1] < tlosses[0]
    for name in _persistables(jm):
        _close(tscope.to_numpy(name), jscope.find_var(name), name)
    touched = sorted(set(feed["feat_ids"].reshape(-1).tolist()))
    untouched = [r for r in range(50) if r not in touched]
    for name in ("deepfm_w", "deepfm_v"):
        after = tscope.to_numpy(name)
        np.testing.assert_array_equal(after[untouched], state[name][untouched], err_msg=name)
        assert np.abs(after[touched] - state[name][touched]).max() > 1e-4, name
    (g,) = texe.run(tm, feed=feed, fetch_list=["deepfm_v@GRAD"], scope=tscope,
                    return_numpy=False)
    assert isinstance(g, SelectedRows) and g.values.shape == (16, 4)


@pytest.mark.parametrize("opt_name", ["adagrad", "adam"])
def test_tiny_deepfm_with_clip_and_decay_matches_jax(opt_name):
    """L2Decay and a global-norm clip on the tiny DeepFM: the dense
    gradients are clipped and decayed, the is_sparse tables' SelectedRows
    gradients bypass both, as in the JAX package (the same ops; the tables'
    updates read their raw gradients; their untouched rows do not decay).
    3 steps from one numpy state: losses and every persistable agree."""
    jm, js, jl = _deepfm("jax", opt_name, clip_decay=True)
    tm, _, tl = _deepfm("torch", opt_name, clip_decay=True)
    assert tm.to_dict() == jm.to_dict()
    ops = tm.global_block().ops
    for table in ("deepfm_w", "deepfm_v"):
        readers = [op.type for op in ops if f"{table}@GRAD" in op.input_arg_names]
        assert readers == [opt_name], (table, readers)
    assert any(op.type == "sqrt" for op in ops) and any(op.type == "sum" for op in ops)
    jexe, jscope, state = _jax_start(jm, js)
    texe, tscope = _torch_start(state)
    rng = np.random.RandomState(0)
    feed = {"feat_ids": rng.randint(0, 50, (4, 4)).astype("i4"),
            "label": (rng.rand(4, 1) < 0.3).astype("f4")}
    jlosses = _train("jax", jm, jl, jexe, jscope, [feed] * 3)
    tlosses = _train("torch", tm, tl, texe, tscope, [feed] * 3)
    np.testing.assert_allclose(tlosses, jlosses, atol=TOL, rtol=0)
    for name in _persistables(jm):
        _close(tscope.to_numpy(name), jscope.find_var(name), name)
    untouched = [r for r in range(50) if r not in set(feed["feat_ids"].reshape(-1).tolist())]
    for name in ("deepfm_w", "deepfm_v"):
        np.testing.assert_array_equal(tscope.to_numpy(name)[untouched],
                                      state[name][untouched], err_msg=name)

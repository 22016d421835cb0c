"""Mixed precision (contrib/mixed_precision) on the CPU against the JAX
package: every case of tests/test_amp.py in both packages, and a tiny
float16 BERT with AMP.

Each program is built by both packages and must be equal by `to_dict`
(main and startup: the decorator's vars, ops and attrs); the JAX package's
persistable state after its startup goes to the port through
`io.load_numpy_params`, both run the same numpy feeds, and every fetch and
every persistable is compared, dtypes included.  The three AMP vars
(`loss_scaling_0`, `good_steps_0`, `bad_steps_0`) must be exactly equal at
every step.  Tolerances: float32 programs 1e-5 of max(1, the largest
magnitude) for losses and state (the two packages sum in other orders);
the float16 MLP 2e-2 of max(|loss|, 0.1) in the losses and 2e-2 of max(1,
the largest magnitude) in the state after 60 steps (float16 activations rounded at
other places in the two packages' matmuls); the tiny BERT by
test_torch_training's bfloat16 rule (elementwise 2 lr steps + 1e-5, the
update within 10% in L2), its losses within 1e-2."""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.contrib.mixed_precision import decorate as j_decorate
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.models import transformer as j_transformer
from paddle_tpu_torch.contrib.mixed_precision import decorate as t_decorate
from paddle_tpu_torch.models import transformer as t_transformer
from paddle_tpu_torch.ops import cuda_kernels as ck

PKGS = {"jax": (jfluid, j_unique, j_decorate, j_transformer),
        "torch": (tfluid, tfluid.unique_name, t_decorate, t_transformer)}
AMP_VARS = ("loss_scaling_0", "good_steps_0", "bad_steps_0")
F32_TOL = 1e-5
F16_TOL = 2e-2


@pytest.fixture(autouse=True)
def launches_unchanged():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before, "a CPU run must not count a kernel launch"


def _mlp(fluid, decorate, dtype="float16", incr_every=4, init_scale=8.0, lr=0.05):
    """tests/test_amp.py _build: x [6] -> (cast) fc 16 relu -> fc 1 -> square
    error, Momentum under the decorator."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 11
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [6], dtype="float32")
        y = fluid.layers.data("y", [1], dtype="float32")
        net_in = fluid.layers.cast(x, dtype) if dtype != "float32" else x
        h = fluid.layers.fc(net_in, 16, act="relu")
        pred = fluid.layers.fc(h, 1)
        pred32 = fluid.layers.cast(pred, "float32") if dtype != "float32" else pred
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred32, y))
        decorate(fluid.optimizer.Momentum(lr, 0.9), init_loss_scaling=init_scale,
                 incr_every_n_steps=incr_every, decr_every_n_nan_or_inf=1).minimize(loss)
    return main, startup, loss


def _sparse_embedding(fluid, decorate):
    """tests/test_amp.py test_amp_with_sparse_embedding's model."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 5
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", [4], dtype="int64")
        y = fluid.layers.data("y", [1], dtype="float32")
        emb = fluid.layers.embedding(ids, size=[50, 8], is_sparse=True)
        pooled = fluid.layers.reshape(emb, [-1, 32])
        pred = fluid.layers.fc(pooled, 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        decorate(fluid.optimizer.SGD(0.1), init_loss_scaling=8.0, incr_every_n_steps=100,
                 decr_every_n_nan_or_inf=1).minimize(loss)
    return main, startup, loss


def _lazy_adam(fluid, decorate, lazy):
    """tests/test_amp.py test_sparse_adam_lazy_mode_semantics's model."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 3
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", [2], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[10, 4], is_sparse=True)
        loss = fluid.layers.mean(emb)
        fluid.optimizer.Adam(learning_rate=0.1, lazy_mode=lazy).minimize(loss)
    return main, startup, loss


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _both(build):
    """`build(fluid, decorate)` in each package under a fresh unique-name
    guard; the two programs equal by to_dict."""
    out = {}
    for name, (fluid, unique, decorate, _) in PKGS.items():
        with unique.guard():
            out[name] = build(fluid, decorate)
    for k in (0, 1):
        assert out["torch"][k].to_dict() == out["jax"][k].to_dict()
    return out


class _Pair:
    """Both packages' executors and scopes from the JAX package's startup
    state; `step` runs one feed in each and checks the AMP vars exactly."""

    def __init__(self, built, state_override=None):
        (self.jm, js, jl), (self.tm, _, tl) = built["jax"], built["torch"]
        self.jl, self.tl = jl.name, tl.name
        self.jexe, self.jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
        self.jexe.run(js, scope=self.jscope)
        self.names = _persistables(self.jm)
        for n, v in (state_override or {}).items():
            self.jscope.set_var(n, v)
        self.start = {n: np.asarray(self.jscope.find_var(n)).copy() for n in self.names}
        self.texe, self.tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        tfluid.io.load_numpy_params(self.tscope, self.start)

    def state(self, pkg):
        if pkg == "jax":
            return {n: np.asarray(self.jscope.find_var(n)).copy() for n in self.names}
        return {n: self.tscope.to_numpy(n).copy() for n in self.names}

    def set(self, name, value):
        self.jscope.set_var(name, value)
        tfluid.io.load_numpy_params(self.tscope, {name: value})

    def step(self, feed):
        jv = float(np.asarray(self.jexe.run(self.jm, feed=feed, fetch_list=[self.jl],
                                            scope=self.jscope)[0]).reshape(-1)[0])
        tv = float(np.asarray(self.texe.run(self.tm, feed=feed, fetch_list=[self.tl],
                                            scope=self.tscope)[0]).reshape(-1)[0])
        j, t = self.state("jax"), self.state("torch")
        for n in AMP_VARS:
            if n in j:
                assert t[n].dtype == j[n].dtype, n
                np.testing.assert_array_equal(t[n], j[n], err_msg=n)
        return jv, tv

    def hold_state(self, tol):
        j, t = self.state("jax"), self.state("torch")
        for n in self.names:
            assert t[n].dtype == j[n].dtype and t[n].shape == j[n].shape, n
            want = j[n].astype(np.float64)
            err = float(np.abs(t[n].astype(np.float64) - want).max()) if want.size else 0.0
            assert err <= tol * max(1.0, float(np.abs(want).max()) if want.size else 0.0), (n, err)
        return t


def test_amp_fp16_converges():
    pair = _Pair(_both(lambda f, d: _mlp(f, d, "float16")))
    rng = np.random.RandomState(0)
    w = rng.rand(6, 1).astype("f4")
    losses = []
    for _ in range(60):
        xv = rng.rand(16, 6).astype("f4")
        jv, tv = pair.step({"x": xv, "y": xv @ w})
        assert abs(tv - jv) <= F16_TOL * max(abs(jv), 0.1), (jv, tv)
        losses.append(tv)
    assert losses[-1] < losses[0] * 0.3, f"{losses[0]} -> {losses[-1]}"
    t = pair.hold_state(F16_TOL)
    assert t["loss_scaling_0"][0] > 8.0  # 60 finite steps at incr_every 4 grew it


def test_amp_scaling_grows_on_finite_steps():
    pair = _Pair(_both(lambda f, d: _mlp(f, d, "float32", incr_every=3, init_scale=4.0)))
    rng = np.random.RandomState(1)
    for _ in range(6):
        jv, tv = pair.step({"x": rng.rand(8, 6).astype("f4"), "y": rng.rand(8, 1).astype("f4")})
        assert abs(tv - jv) <= F32_TOL * max(1.0, abs(jv))
    t = pair.hold_state(F32_TOL)
    assert t["loss_scaling_0"][0] == 16.0 and t["loss_scaling_0"].dtype == np.float32
    assert t["good_steps_0"].dtype == np.int32 and t["good_steps_0"].shape == (1,)


def test_amp_overflow_skips_update_and_halves_scale():
    pair = _Pair(_both(lambda f, d: _mlp(f, d, "float32", incr_every=100, init_scale=8.0)))
    rng = np.random.RandomState(2)
    xv, yv = rng.rand(8, 6).astype("f4"), rng.rand(8, 1).astype("f4")
    pair.step({"x": xv, "y": yv})
    before = pair.state("torch")
    bad = xv.copy()
    bad[0, 0] = np.inf
    pair.step({"x": bad, "y": yv})
    after = pair.state("torch")
    for n in pair.names:
        if n not in AMP_VARS:  # every parameter and velocity, bit for bit
            np.testing.assert_array_equal(after[n], before[n], err_msg=n)
    assert after["loss_scaling_0"][0] == 4.0 and after["bad_steps_0"][0] == 0
    pair.step({"x": xv, "y": yv})
    moved = pair.state("torch")
    assert any(np.abs(moved[n] - after[n]).max() > 0 for n in pair.names if n not in AMP_VARS)
    pair.hold_state(F32_TOL)


def test_amp_loss_scale_floor():
    pair = _Pair(_both(lambda f, d: _mlp(f, d, "float32", incr_every=100, init_scale=2.0)))
    rng = np.random.RandomState(3)
    xv = rng.rand(4, 6).astype("f4")
    bad = xv.copy()
    bad[0, 0] = np.nan
    yv = rng.rand(4, 1).astype("f4")
    for _ in range(5):
        pair.step({"x": bad, "y": yv})
    t = pair.hold_state(0.0)  # nothing moved but the AMP vars, equal exactly
    assert t["loss_scaling_0"][0] == 1.0


def test_amp_with_sparse_embedding():
    """SelectedRows gradients through isfinite and the unscale (the
    elementwise_div of a SelectedRows by the scale keeps its rows)."""
    pair = _Pair(_both(_sparse_embedding))
    rng = np.random.RandomState(0)
    feed = {"ids": rng.randint(0, 50, (16, 4)).astype("int64"),
            "y": rng.randn(16, 1).astype("f4")}
    losses = []
    for _ in range(40):
        jv, tv = pair.step(feed)
        assert abs(tv - jv) <= F32_TOL * max(1.0, abs(jv)), (jv, tv)
        losses.append(tv)
    assert np.isfinite(losses).all() and losses[-1] < losses[0] * 0.5
    pair.hold_state(F32_TOL)


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "dense"])
def test_sparse_adam_lazy_mode_semantics(lazy):
    """lazy_mode moves the touched rows only; the densifying default moves
    row 0 again at the second step through its moment; both as the JAX
    package does."""
    pair = _Pair(_both(lambda f, d: _lazy_adam(f, d, lazy)))
    wname = next(n for n in pair.names if n.startswith("embedding"))
    w0 = pair.start[wname]
    seen = []
    for step_ids in ([[0, 1]], [[2, 3]]):
        jv, tv = pair.step({"ids": np.array(step_ids, "int64")})
        assert abs(tv - jv) <= F32_TOL * max(1.0, abs(jv))
        seen.append(pair.hold_state(F32_TOL)[wname])
    np.testing.assert_array_equal(seen[1][4:], w0[4:])  # never touched, zero moments
    # row 0, touched at step 1 only: its moment moves it at step 2 unless lazy
    assert np.array_equal(seen[1][0], seen[0][0]) == lazy


# --- the tiny BERT in float16 with AMP ------------------------------------

TINY = dict(vocab_size=200, seq_len=16, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            dropout_prob=0.0, with_optimizer=False)
BERT_LR = 1e-3
SIGN_FLIP = 2 * BERT_LR * 3 + 1e-5  # three applied steps
UPDATE_RTOL = 0.1
# the forced overflow: a scale no float16 gradient survives (the
# cross-entropy backward's cotangent is scale / rows)
OVERFLOW_SCALE = np.array([2.0 ** 40], np.float32)


def _bert(fused):
    def build(fluid, decorate):
        transformer = t_transformer if fluid is tfluid else j_transformer
        main, startup, _, fetches = transformer.build_bert(dtype="float16",
                                                           use_fused_attention=fused, **TINY)
        with fluid.program_guard(main, startup):
            decorate(fluid.optimizer.Adam(BERT_LR)).minimize(fetches["loss"])
        return main, startup, fetches["loss"]
    return build


@pytest.mark.parametrize("fused", [False, True], ids=["unfused_attention", "fused_attention"])
def test_tiny_bert_float16_with_amp(fused):
    """build_bert(dtype="float16") under decorate(Adam(1e-3)) at the
    decorator's defaults (scale 2^15, incr 1000, decr 2): a step, then two
    forced overflows (the scale set to 2^40 in both scopes), which leave
    every parameter, moment and beta pow bit for bit and halve the scale at
    the second (bad_steps 1, then 0), then the scale set back to 2^15 and
    two more steps.  AMP vars exactly equal at every step; losses 1e-2;
    parameters by the bfloat16 rule of test_torch_training."""
    from test_torch_training import _batch, _numpy_params

    built = _both(_bert(fused))
    ops = [op.type for op in built["torch"][0].global_block().ops]
    assert ("fused_attention" in ops) == fused and "update_loss_scaling" in ops
    params = {n: v.astype(np.float16) if built["jax"][0].global_block().var(n).dtype == "float16"
              else v for n, v in _numpy_params(built["jax"][0]).items()}
    pair = _Pair(built, state_override=params)
    feed = _batch()
    losses = []
    for step in range(5):
        if step == 1:
            pair.set("loss_scaling_0", OVERFLOW_SCALE)
        if step == 3:
            pair.set("loss_scaling_0", np.array([2.0 ** 15], np.float32))
        before = pair.state("torch")
        jv, tv = pair.step(feed)
        after = pair.state("torch")
        if step in (1, 2):
            for n in pair.names:
                if n not in AMP_VARS:
                    np.testing.assert_array_equal(after[n], before[n], err_msg=f"{n} step {step}")
            assert after["bad_steps_0"][0] == (1 if step == 1 else 0)
            assert after["loss_scaling_0"][0] == (2.0 ** 40 if step == 1 else 2.0 ** 39)
        else:
            assert abs(tv - jv) <= 1e-2 * max(1.0, abs(jv)), (step, jv, tv)
            losses.append(tv)
    assert losses[-1] < losses[0]
    j, t = pair.state("jax"), pair.state("torch")
    sq_diff = sq_update = 0.0
    for p in built["jax"][0].all_parameters():
        n = p.name
        assert t[n].dtype == j[n].dtype, n
        got, want = t[n].astype(np.float32), j[n].astype(np.float32)
        assert np.abs(got - want).max() <= SIGN_FLIP, (n, float(np.abs(got - want).max()))
        sq_diff += float(np.sum((got - want) ** 2))
        sq_update += float(np.sum((want - pair.start[n].astype(np.float32)) ** 2))
    assert np.sqrt(sq_diff / sq_update) <= UPDATE_RTOL

"""The ResNet-50 slice (and MNIST) on the CPU against the JAX package.

Kernels: the plain BN epilogue, forward and backward, against the Pallas
kernels in interpret mode at the FUSED_KERNELS tolerances.

Training: programs built by the JAX package travel to the port through
`to_dict` / `from_dict`, its persistable state through
`io.load_numpy_params`.  A batch-normalized ResNet-50 in training mode is
ill-conditioned at initialization: batch statistics make the gradients
explode with depth (Yang et al., "A Mean Field Theory of Batch
Normalization", 2019).  Measured here, a relative perturbation of 1e-6 of the
input images moves ResNet-50's parameter gradients by 3% (median over
tensors, up to 35% for single elements), ResNet-18's by 6e-6, and
ResNet-50's with running statistics by 3e-7.  Two implementations that round
differently therefore agree on ResNet-50's gradients only to a few percent,
and their trajectories part within steps.  So each of the 3 Momentum steps
starts both packages from the same state (the JAX package's, after its
previous step) and holds what that one step writes:
  * the loss, a forward quantity: 2e-4 * max(1, |loss|);
  * the running mean and variance, also forward quantities: within 1e-3 of
    how far the step moved them (per tensor, max norm);
  * each velocity and each parameter update, per tensor in L2: within 0.2 of
    the JAX package's (the two packages measured <= 0.05); a frozen, doubled
    or sign-flipped update scores >= 1, a step that drops the velocity's
    momentum ~0.5 or more; and the whole velocity's cosine >= 0.99.
ResNet-18 (space-to-depth stem), well conditioned, is held the same way at
1e-3.  MNIST trains 3 Adam steps freely, as tests/test_torch_training.py
holds BERT.  Serving: ResNets saved by the JAX package, with running
statistics calibrated on a batch, served by the port's Predictor."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.models import mnist as j_mnist
from paddle_tpu.models import resnet as j_resnet
from paddle_tpu.ops import pallas_kernels as jpk
from paddle_tpu_torch.core.dtypes import to_tensor
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.models import mnist as t_mnist
from paddle_tpu_torch.models import resnet as t_resnet
from paddle_tpu_torch.ops import cuda_kernels as ck
from test_torch_kernels import one_float16_step

DTYPES = ["float32", "bfloat16", "float16"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
STEPS = 3
LOSS_RTOL = 2e-4
STAT_SHARE = 1e-3
COSINE = 0.99


@pytest.fixture(autouse=True)
def launches_unchanged():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before, "a CPU run must not count a kernel launch"


def _t(a, grad=False):
    t = to_tensor(np.asarray(a)).clone()
    return t.requires_grad_(True) if grad else t


def _f32(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


# --------------------------------------------------------------------------
# the BN epilogue's plain versions against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [196, 49])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bn_epilogue_plain_matches_pallas(dtype, relu, hw):
    spec = jpk.FUSED_KERNELS["bn_scale_shift_relu"]
    x, mul, add = jpk._epilogue_example(JDT[dtype], hw=hw)
    want = jpk.bn_epilogue(x, mul, add, relu, True)
    got = ck.bn_epilogue(_t(x), _t(mul), _t(add), relu)
    assert got.dtype == _t(x).dtype and got.shape == tuple(x.shape)
    if dtype == "float16":
        one_float16_step(want, got)
    else:
        assert float(np.abs(_f32(got) - _f32(want)).max()) <= spec["tol"][dtype]
    if relu:
        assert float(_f32(got).min()) >= 0.0


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bn_epilogue_plain_backward_matches_pallas_vjp(dtype, relu):
    """The explicit plain backward against jax.vjp through the Pallas custom
    VJP (interpret mode) and against autograd of the plain forward, at the
    last stage's row width of 49.  Tolerances: 1e-4 * (1 + max|ref|) in
    float32, as the Pallas grad tests; 5e-2 of max|ref| in bfloat16; in
    float16 6.25e-3 of max|ref| for dx (bfloat16's scaled by the 2^-3 of
    float16's three more bits) and float32's for the float32 column sums
    dmul and dadd."""
    x, mul, add = jpk._epilogue_example(JDT[dtype], hw=49)
    n, c, w = x.shape
    x2 = x.reshape(n * c, w)
    mul_r, add_r = jnp.tile(mul, n), jnp.tile(add, n)
    g = jnp.asarray(np.random.RandomState(3).randn(n * c, w), JDT[dtype])
    _, vjp = jax.vjp(lambda a, m, b: jpk.fused_scale_shift_relu(a, m, b, relu, True),
                     x2, mul_r, add_r)
    jdx, jdm, jda = vjp(g)
    xt, mt, at = _t(x2, True), _t(mul_r, True), _t(add_r, True)
    dx, dm, da = ck.bn_epilogue_bwd_plain(xt.detach(), mt.detach(), at.detach(), _t(g), relu)
    assert dx.dtype == xt.dtype and dm.dtype == da.dtype == torch.float32
    auto = torch.autograd.grad(ck.bn_epilogue_plain(xt, mt, at, relu), (xt, mt, at), _t(g))
    for name, got, want in (("dx", dx, jdx), ("dmul", dm, jdm), ("dadd", da, jda),
                            ("autograd dx", dx, auto[0]), ("autograd dmul", dm, auto[1]),
                            ("autograd dadd", da, auto[2])):
        want = _f32(want)
        peak = float(np.abs(want).max())
        if dtype == "float32" or (dtype == "float16" and got.dtype == torch.float32):
            tol = 1e-4 * (1.0 + peak)
        else:
            tol = (5e-2 if dtype == "bfloat16" else 6.25e-3) * peak
        assert float(np.abs(_f32(got) - want).max()) <= tol, name


def test_bn_epilogue_function_routes_gradients():
    """The autograd Function gives x, mul and add the plain backward's
    gradients; the tiled per-channel vectors sum them per channel."""
    rng = np.random.RandomState(0)
    x = _t(rng.randn(2, 3, 4, 5).astype(np.float32), True)
    mul = _t(rng.rand(3).astype(np.float32) + 0.5, True)
    add = _t(rng.randn(3).astype(np.float32), True)
    g = _t(rng.randn(2, 3, 4, 5).astype(np.float32))
    dx, dm, da = torch.autograd.grad(ck.bn_epilogue(x, mul, add, True), (x, mul, add), g)
    want = ck.bn_epilogue_bwd_plain(x.detach().reshape(6, 20), mul.detach().repeat(2),
                                    add.detach().repeat(2), g.reshape(6, 20), True)
    torch.testing.assert_close(dx.reshape(6, 20), want[0])
    torch.testing.assert_close(dm, want[1].reshape(2, 3).sum(0))
    torch.testing.assert_close(da, want[2].reshape(2, 3).sum(0))


def test_bn_backward_rule_catches_a_dropped_mask_or_row():
    """chip_smoke's element rule for the backward kernel: dx within one
    rounding, dmul / dadd within 1e-5 of sum|g*x| / sum|g| of their row.
    A kernel that forgot the relu mask or skipped a row fails it by orders
    of magnitude; the plain backward against itself, reordered, passes."""
    import chip_smoke

    rng = np.random.RandomState(1)
    for dtype in (torch.float32, torch.bfloat16):
        for rows, w in ((64, 12544), (2048, 49)):
            x = torch.from_numpy(rng.randn(rows, w).astype(np.float32)).to(dtype)
            g = torch.from_numpy(rng.randn(rows, w).astype(np.float32)).to(dtype)
            mul = torch.from_numpy(rng.rand(rows).astype(np.float32) + 0.5)
            add = torch.from_numpy(rng.randn(rows).astype(np.float32) * 0.1)
            want = ck.bn_epilogue_bwd_plain(x, mul, add, g, True)
            allowed = chip_smoke.epilogue_bwd_allowed(x, mul, g, want)
            shares = lambda got: [float(((a.float() - b.float()).abs() / t).max())  # noqa: E731
                                  for a, b, t in zip(got, want, allowed)]
            # the same sums in another order (blocks of 32 columns, as lanes add)
            xf, gf = x.float(), g.float()
            live = (xf * mul[:, None] + add[:, None]) > 0
            gm = torch.where(live, gf, torch.zeros_like(gf))
            pad = (-w) % 32
            lanes = lambda t: torch.nn.functional.pad(t, (0, pad)).reshape(rows, -1, 32).sum(1).sum(1)  # noqa: E731
            reordered = (want[0], lanes(gm * xf), lanes(gm))
            assert max(shares(reordered)) <= 1.0
            unmasked = ck.bn_epilogue_bwd_plain(x, mul, add, g, False)
            assert min(shares(unmasked)) > 10.0  # every output catches it
            dropped = [t.clone() for t in want]
            dropped[0][5] = 0
            dropped[1][5] = 0
            dropped[2][5] = 0
            assert min(shares(dropped)) > 10.0


# --------------------------------------------------------------------------
# the fuse_bn_relu pass
# --------------------------------------------------------------------------


def _resnet(pkg, **kw):
    unique, resnet = (j_unique, j_resnet) if pkg == "jax" else (tfluid.unique_name, t_resnet)
    with unique.guard():
        return resnet.build(**kw)


@pytest.mark.parametrize("config", [dict(depth=50, dtype="bfloat16", stem="space_to_depth"),
                                    dict(depth=18, class_dim=10, image_shape=(3, 32, 32))],
                         ids=["resnet50_bf16_s2d", "resnet18"])
def test_builder_and_fuse_bn_relu_match_jax(config):
    """The port's builder emits the JAX package's program, and its
    fuse_bn_relu pass rewrites it the same way (to_dict)."""
    jm, js, _, jf = _resnet("jax", **config)
    tm, ts, _, _ = _resnet("torch", **config)
    for a, b in ((jm, tm), (js, ts)):
        da, db = a.to_dict()["blocks"][0], b.to_dict()["blocks"][0]
        assert da["ops"] == db["ops"]
        assert [(v["name"], v["dtype"], v["persistable"], v["trainable"]) for v in da["vars"]] == \
               [(v["name"], v["dtype"], v["persistable"], v["trainable"]) for v in db["vars"]]
    keep = [jf["loss"].name]
    jfluid.core.passes.apply_pass(jm, "fuse_bn_relu", keep=keep)
    tfluid.passes.apply_pass(tm, "fuse_bn_relu", keep=keep)
    assert tm.to_dict()["blocks"][0]["ops"] == jm.to_dict()["blocks"][0]["ops"]
    bns = [op for op in tm.global_block().ops if op.type == "batch_norm"]
    if config["depth"] == 50:
        # the stem, 3 per bottleneck x 16 and 4 shortcuts; the stem and two per bottleneck fuse
        assert len(bns) == 53 and sum(bool(op.attrs.get("fuse_relu")) for op in bns) == 33
    # the relus left are the residual adds'
    adds = {op.output("Out")[0] for op in tm.global_block().ops if op.type == "elementwise_add"}
    assert all(op.input("X")[0] in adds for op in tm.global_block().ops if op.type == "relu")
    # the running statistics are persistable, never trainable, never differentiated
    params = set(next(op for op in tm.global_block().ops
                      if op.type == "backward").attrs["param_names"])
    for op in bns:
        for slot in ("Mean", "Variance"):
            v = tm.global_block().var(op.input(slot)[0])
            assert v.persistable and not v.trainable and v.name not in params


def _bn_relu_program(build):
    """x -> conv2d -> batch_norm -> ..., the relu and its neighbours appended
    by `build(block, conv_out, bn_out)` as raw ops; returns the program."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        img = tfluid.layers.data("img", [4, 8, 8], dtype="float32")
        c = tfluid.layers.conv2d(img, 8, 3, padding=1)
        b = tfluid.layers.batch_norm(c)
        build(main.global_block(), c, b)
    return main, startup


def _relu(block, x, name):
    out = block.create_var(name, shape=x.shape, dtype=x.dtype)
    block.append_op("relu", inputs={"X": [x.name]}, outputs={"Out": [out.name]})
    return out


def _mean(block, x):
    out = block.create_var("loss", shape=(1,), dtype="float32")
    block.append_op("mean", inputs={"X": [x.name]}, outputs={"Out": [out.name]})
    return out


def _fused(main):
    return [bool(op.attrs.get("fuse_relu")) for op in main.global_block().ops
            if op.type == "batch_norm"]


def test_fuse_bn_relu_pass_parity():
    main, startup = _bn_relu_program(lambda blk, c, b: _mean(blk, _relu(blk, b, "r")))
    feed = {"img": np.random.RandomState(0).rand(2, 4, 8, 8).astype("f4")}
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    base = exe.run(main, feed=feed, fetch_list=["loss", "r"], scope=scope)
    tfluid.passes.apply_pass(main, "fuse_bn_relu", keep=["loss"])
    assert _fused(main) == [True]
    assert not [op for op in main.global_block().ops if op.type == "relu"]
    for a, b in zip(base, exe.run(main, feed=feed, fetch_list=["loss", "r"], scope=scope)):
        np.testing.assert_array_equal(a, b)


def test_fuse_bn_relu_pass_skips_later_writer():
    """A batch_norm that writes the relu's source AFTER the relu read it
    is a different definition: pairing across it would miscompile."""
    def build(blk, c, b):
        r = _relu(blk, b, "r")
        _mean(blk, r)
        late = tfluid.layers.batch_norm(r)
        blk.ops[-1].outputs["Y"] = [b.name]  # clobber b after the relu consumed it
        del late

    main, _ = _bn_relu_program(build)
    tfluid.passes.apply_pass(main, "fuse_bn_relu", keep=["loss"])
    assert any(op.type == "relu" for op in main.global_block().ops)
    assert _fused(main) == [False, False]


def test_fuse_bn_relu_pass_skips_fetched_bn_out():
    holder = {}

    def build(blk, c, b):
        holder["b"] = b.name
        _relu(blk, b, "r")

    main, _ = _bn_relu_program(build)
    tfluid.passes.apply_pass(main, "fuse_bn_relu", keep=[holder["b"]])
    assert any(op.type == "relu" for op in main.global_block().ops) and _fused(main) == [False]


def test_fuse_bn_relu_pass_skips_intervening_write():
    """An op between the BN and the relu that overwrites the BN's Y: the
    relu never saw the BN's value, so fusing would resurrect it."""
    def build(blk, c, b):
        scaled = blk.create_var("scaled", shape=c.shape, dtype=c.dtype)
        blk.append_op("scale", inputs={"X": [c.name]}, outputs={"Out": [scaled.name]},
                      attrs={"scale": 2.0})
        blk.append_op("assign", inputs={"X": [scaled.name]}, outputs={"Out": [b.name]})
        _mean(blk, _relu(blk, b, "r"))

    main, _ = _bn_relu_program(build)
    tfluid.passes.apply_pass(main, "fuse_bn_relu", keep=["loss"])
    assert _fused(main) == [False] and any(op.type == "relu" for op in main.global_block().ops)


# --------------------------------------------------------------------------
# training: 3 Momentum steps, each from the JAX package's state
# --------------------------------------------------------------------------


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _kind(name):
    if name.endswith("_velocity_0"):
        return "velocity"
    if name.startswith("learning_rate"):
        return "learning_rate"
    return "state"


def _l2_share(got, want, ref):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(ref), 1e-30))


def _train_teacher_forced(config, dtype, batch, seed=0):
    """Run STEPS Momentum steps in the JAX package; before each, load its
    state into the port and take the same step there.  Returns one record
    per step: losses, the state before, and both states after."""
    with j_unique.guard():
        jm, js, _, fetches = j_resnet.build(dtype=dtype, **config)
    loss = fetches["loss"].name
    for p in ("fuse_bn_relu", "fuse_bias_act"):
        jfluid.core.passes.apply_pass(jm, p, keep=[loss])
    tm = TProgram.from_dict(jm.to_dict())
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), tfluid.Executor(tfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(js, scope=jscope)
    names = _persistables(jm)
    rng = np.random.RandomState(seed)
    h = config["image_shape"][1]
    feed = {"img": rng.rand(batch, 3, h, h).astype(np.float32),
            "label": rng.randint(0, config["class_dim"], (batch, 1)).astype(np.int64)}
    records = []
    for _ in range(STEPS):
        before = {n: np.asarray(jscope.find_var(n)) for n in names}
        tscope = tfluid.Scope()
        tfluid.io.load_numpy_params(tscope, before)
        jl = float(np.asarray(jexe.run(jm, feed=feed, fetch_list=[loss], scope=jscope)[0])
                   .reshape(-1)[0])
        tl = float(texe.run(tm, feed=feed, fetch_list=[loss], scope=tscope)[0].reshape(-1)[0])
        records.append(dict(jl=jl, tl=tl, before=before,
                            jax={n: np.asarray(jscope.find_var(n), np.float32) for n in names},
                            port={n: tscope.to_numpy(n).astype(np.float32) for n in names}))
    return tm, records


def _check_steps(tm, records, update_l2):
    params = {p.name for p in tm.all_parameters() if p.trainable}
    stats = {op.input(s)[0] for op in tm.global_block().ops if op.type == "batch_norm"
             for s in ("Mean", "Variance")}
    losses = [r["jl"] for r in records]
    assert np.isfinite(losses).all() and losses[-1] != losses[0]
    for step, rec in enumerate(records):
        assert abs(rec["tl"] - rec["jl"]) <= LOSS_RTOL * max(1.0, abs(rec["jl"])), step
        dot = nj = nt = 0.0
        for name, want in rec["jax"].items():
            got = rec["port"][name]
            before = rec["before"][name].astype(np.float32)
            assert got.shape == want.shape, name
            if _kind(name) == "learning_rate":
                np.testing.assert_array_equal(got, want)
            elif name in stats:
                moved = float(np.abs(want - before).max())
                assert moved > 0, name
                err = float(np.abs(got - want).max())
                assert err <= STAT_SHARE * moved, (step, name, err, moved)
            elif _kind(name) == "velocity":
                assert _l2_share(got, want, want) <= update_l2, (step, name)
                dot += float(np.sum(got.astype(np.float64) * want))
                nj += float(np.sum(want.astype(np.float64) ** 2))
                nt += float(np.sum(got.astype(np.float64) ** 2))
            else:
                assert name in params, name
                assert _l2_share(got - before, want - before, want - before) <= update_l2, \
                    (step, name)
        assert dot / np.sqrt(nj * nt) >= COSINE, step


def test_resnet50_momentum_steps_match_jax():
    """ResNet-50, float32, 10 classes, 32 x 32 images, batch 8, lr 0.01: each
    of 3 Momentum steps (from the JAX package's state) by the rules of the
    module's docstring."""
    config = dict(depth=50, class_dim=10, image_shape=(3, 32, 32), learning_rate=0.01)
    tm, records = _train_teacher_forced(config, "float32", 8)
    _check_steps(tm, records, update_l2=0.2)


def test_resnet18_space_to_depth_momentum_steps_match_jax():
    """ResNet-18, float32, space-to-depth stem, 32 x 32, batch 8, lr 0.01:
    well conditioned, so each velocity and update is held to 1e-3 in L2
    (measured <= 8e-5), the rest as for ResNet-50."""
    config = dict(depth=18, class_dim=10, image_shape=(3, 32, 32), learning_rate=0.01,
                  stem="space_to_depth")
    tm, records = _train_teacher_forced(config, "float32", 8)
    _check_steps(tm, records, update_l2=1e-3)


# --------------------------------------------------------------------------
# serving: JAX save_inference_model -> the port's Predictor
# --------------------------------------------------------------------------


def _saved_by_jax(dirname, config, dtype, state=None):
    """Save the JAX package's inference model of `config` in `dtype` after
    fuse_bn_relu.  Without `state`, its running statistics are set to the
    batch statistics of a calibration batch (so the activations keep their
    scale) and the whole state is returned; with `state`, that is loaded."""
    with j_unique.guard():
        main, startup, _, fetches = j_resnet.build(dtype=dtype, with_optimizer=False, **config)
    logits = fetches["logits"].name
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    if state is None:
        calib = np.random.RandomState(1).rand(16, 3, 32, 32).astype(np.float32)
        bns = [op for op in main.global_block().ops if op.type == "batch_norm"]
        stats = exe.run(main, feed={"img": calib, "label": np.zeros((16, 1), np.int64)},
                        fetch_list=[op.output(s)[0] for op in bns
                                    for s in ("SavedMean", "SavedVariance")], scope=scope)
        for op, m, v in zip(bns, stats[0::2], stats[1::2]):
            scope.set_var(op.input("Mean")[0], jnp.asarray(m, jnp.float32))
            scope.set_var(op.input("Variance")[0], jnp.asarray(v, jnp.float32))
        state = {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}
    else:
        for name, arr in state.items():
            scope.set_var(name, jnp.asarray(arr))
    jfluid.core.passes.apply_pass(main, "fuse_bn_relu", keep=[logits])
    jfluid.io.save_inference_model(dirname, ["img"], [main.global_block().var(logits)],
                                   exe, main, scope)
    return state


@pytest.mark.parametrize("depth,dtype", [(50, "float32"), (18, "bfloat16")])
def test_jax_saved_resnet_served_by_port(tmp_path, depth, dtype):
    """A ResNet (10 classes, 32 x 32, space-to-depth stem) saved by the JAX
    package, served by the port's Predictor, against the JAX package's
    float32 logits.  Float32 ResNet-50: within 1e-4 * (1 + max|logits|)
    (running statistics: no batch coupling).  Bfloat16 ResNet-18: within
    0.1 * max|logits|; its rounding alone moves the logits that far (the
    JAX package's own bfloat16 path measured 0.09, the port's 0.06)."""
    config = dict(depth=depth, class_dim=10, image_shape=(3, 32, 32), stem="space_to_depth")
    ref_dir, dirname = str(tmp_path / "float32"), str(tmp_path / dtype)
    state = _saved_by_jax(ref_dir, config, "float32")
    if dtype != "float32":
        _saved_by_jax(dirname, config, dtype, state)
    feed = {"img": np.random.RandomState(0).rand(4, 3, 32, 32).astype(np.float32)}
    want = np.asarray(jfluid.inference.create_predictor(jfluid.inference.AnalysisConfig(
        ref_dir, jfluid.CPUPlace())).run(feed)[0], np.float32)
    got = tfluid.inference.create_predictor(tfluid.inference.AnalysisConfig(
        dirname if dtype != "float32" else ref_dir, tfluid.CPUPlace())).run(feed)[0]
    assert got.shape == want.shape == (4, 10) and np.isfinite(got).all()
    peak = float(np.abs(want).max())
    assert peak > 0.1
    tol = 1e-4 * (1.0 + peak) if dtype == "float32" else 0.1 * peak
    assert float(np.abs(got - want).max()) <= tol


def test_nhwc_lowerings_raise_naming_the_roadmap():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        img = tfluid.layers.data("img", [8, 8, 4], dtype="float32")
        out = tfluid.layers.conv2d(img, 4, 3, padding=1, data_format="NHWC")
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        exe.run(main, feed={"img": np.zeros((1, 8, 8, 4), np.float32)}, fetch_list=[out],
                scope=scope)


# --------------------------------------------------------------------------
# MNIST: 3 Adam steps from the JAX package's parameters
# --------------------------------------------------------------------------


def test_mnist_adam_steps_match_jax():
    """The LeNet-style MNIST CNN, float32, batch 16, Adam lr 1e-3, trained 3
    steps freely in both packages from the JAX package's state.  Losses within
    1e-4; parameters within 1e-5, save elements whose JAX gradient is within
    1e-6 of the model's largest at some step (Adam's first step is +-lr
    there whatever the gradient's size): 2*lr*steps + 1e-5; moments within
    1e-4 of the largest of their kind."""
    with j_unique.guard():
        jm, js, _, jf = j_mnist.build()
    with tfluid.unique_name.guard():
        tm, _, _, tf = t_mnist.build()
    assert jm.to_dict()["blocks"][0]["ops"] == tm.to_dict()["blocks"][0]["ops"]
    loss = jf["loss"].name
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), tfluid.Executor(tfluid.CPUPlace())
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe.run(js, scope=jscope)
    names = _persistables(jm)
    state = {n: np.asarray(jscope.find_var(n)) for n in names}
    tfluid.io.load_numpy_params(tscope, state)
    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(16, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (16, 1)).astype(np.int64)}
    params = [p.name for p in jm.all_parameters()]
    jl, tl, grads = [], [], []
    for _ in range(STEPS):
        out = jexe.run(jm, feed=feed, fetch_list=[loss] + [f"{p}@GRAD" for p in params],
                       scope=jscope)
        jl.append(float(np.asarray(out[0]).reshape(-1)[0]))
        grads.append([np.asarray(g, np.float32) for g in out[1:]])
        (t_out, acc) = texe.run(tm, feed=feed, fetch_list=[loss, tf["acc"].name], scope=tscope)
        tl.append(float(t_out.reshape(-1)[0]))
    assert tl[-1] < tl[0] and 0.0 <= float(acc[0]) <= 1.0
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    peaks = [max(float(np.abs(g).max()) for g in step) for step in grads]
    for i, name in enumerate(params):
        want = np.asarray(jscope.find_var(name), np.float32)
        err = np.abs(tscope.to_numpy(name) - want)
        near_zero = np.zeros(err.shape, bool)
        for step, peak in zip(grads, peaks):
            near_zero |= np.abs(step[i]) <= 1e-6 * peak
        assert err.max() <= 2 * 1e-3 * STEPS + 1e-5, name
        assert not (err[~near_zero] > 1e-5).any(), name
        assert not np.array_equal(tscope.to_numpy(name), state[name]), name
    for kind in ("moment1", "moment2"):
        kinds = [n for n in names if n.endswith(f"_{kind}_0")]
        peak = max(float(np.abs(np.asarray(jscope.find_var(n))).max()) for n in kinds)
        for n in kinds:
            assert np.abs(tscope.to_numpy(n) - np.asarray(jscope.find_var(n))).max() <= 1e-4 * peak


def test_load_numpy_params_carries_bn_and_momentum_state():
    """io.load_numpy_params takes running statistics and velocities, a numpy
    bfloat16 one with its bits."""
    scope = tfluid.Scope()
    arr = np.arange(6, dtype=np.float32).astype(ml_dtypes.bfloat16)
    tfluid.io.load_numpy_params(scope, {"bn.w_1": arr, "p_velocity_0": np.ones(3, np.float32)})
    assert scope.find_var("bn.w_1").dtype == torch.bfloat16
    np.testing.assert_array_equal(scope.to_numpy("bn.w_1"), arr.astype(np.float32))

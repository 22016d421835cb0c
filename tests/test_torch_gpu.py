"""Tests of paddle_tpu_torch that need a CUDA device (marker `gpu`).

Here, without a card, each skips itself.  On a machine with a card, which
has no JAX, run them without the suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

This module imports nothing of JAX or paddle_tpu for that reason."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.ops import cuda_attention as ca
from paddle_tpu_torch.ops import cuda_kernels as ck

TINY = dict(vocab_size=200, seq_len=16, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            use_fused_attention=True, with_optimizer=False)
NO_LAUNCHES = {k: 0 for k in ck.LAUNCHES}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


@pytest.fixture
def exact_card_math():
    """TF32 off for matmuls and convolutions, and cuDNN's deterministic
    algorithms (its weight gradients may add in any order otherwise), for
    one test: the process's switches are restored after it, so no later
    test inherits them."""
    switches = [(torch.backends.cuda.matmul, "allow_tf32", False),
                (torch.backends.cudnn, "allow_tf32", False),
                (torch.backends.cudnn, "deterministic", True)]
    saved = [getattr(module, name) for module, name, _ in switches]
    for module, name, value in switches:
        setattr(module, name, value)
    try:
        yield
    finally:
        for (module, name, _), value in zip(switches, saved):
            setattr(module, name, value)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_kernels_match_plain_on_card(dtype):
    _need_card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(300, 768, generator=g, device="cuda").to(dt)
    r = torch.randn(300, 768, generator=g, device="cuda").to(dt)
    s = torch.rand(768, generator=g, device="cuda") + 0.5
    b = torch.randn(768, generator=g, device="cuda") * 0.1
    tol = 2e-5 if dtype == "float32" else 5e-2
    before = dict(ck.LAUNCHES)
    out = ck.fused_ln_residual(x, r, s, b, 1e-5)
    want = ck.ln_residual_plain(x, r, s, b)
    if dtype == "float16":  # element by element (FWD_ROUNDING_RULE)
        tol = ck.ln_residual_fwd_allowed(x, r, s, b, want)
    assert ((out.float() - want.float()).abs() <= tol).all()
    out = ck.fused_bias_act(x, b, "gelu")
    want = ck.bias_act_plain(x, b)
    if dtype == "float16":
        tol = ck.bias_act_fwd_allowed(x, b, want)
    assert ((out.float() - want.float()).abs() <= tol).all()
    q = torch.randn(2, 12, 128, 64, generator=g, device="cuda").to(dt)
    out = ca.fused_sdpa(q, q, q, None, True, 0.125)
    want = ca.sdpa_plain(q, q, q, None, True, 0.125)
    tol = {"float32": 1e-4, "bfloat16": 5e-2}.get(dtype)
    if tol is None:  # float16: FWD_F16_RULE
        tol = ca.sdpa_fwd_bf16_allowed(q, q, q, None, True, 0.125, want)
    assert ((out.float() - want.float()).abs() <= tol).all()
    assert {k: ck.LAUNCHES[k] - before[k] for k in before} == dict(
        NO_LAUNCHES, ln_residual_fwd=1, bias_act_fwd=1, attention_fwd=1)


@pytest.mark.gpu
def test_kernel_wrappers_check_their_operands_on_card():
    _need_card()
    x = torch.zeros(8, 16, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        ck.fused_bias_act(x.t(), torch.zeros(8, device="cuda"), "gelu")
    with pytest.raises(TypeError, match="not supported"):  # float64: no kernel takes it
        ck.fused_bias_act(x.double(), torch.zeros(16, device="cuda"), "gelu")
    q = torch.zeros(1, 1, 4, 24, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        ca.fused_sdpa(q, q, q, None, False, 1.0)
    # a CUDA input that requires grad takes the backward kernels: dq, dk and dv
    # against the plain backward, and the same bits on a second run
    g = torch.Generator(device="cuda").manual_seed(2)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        q, k, v, do = (torch.randn(2, 3, n, 32, generator=g, device="cuda").to(dt)
                       for n in (100, 150, 150, 100))
        bias = torch.randn(2, 1, 100, 150, generator=g, device="cuda")
        runs = []
        for _ in range(2):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = ca.fused_sdpa(*leaves, bias, True, 0.2)
            runs.append(torch.autograd.grad(out, leaves, do))
        want = ca.sdpa_bwd_plain(q, k, v, bias, True, 0.2, out.detach(), do)
        for a, b, w in zip(*runs, want):
            assert torch.equal(a, b)
            peak = float(w.float().abs().max())
            assert _err(a, w) <= (tol * (1.0 + peak) if dt == torch.float32 else tol * peak)
    with pytest.raises(ValueError, match="share a shape"):
        ck.fused_adam(x, x, x, torch.zeros(8, device="cuda"), torch.ones(1, device="cuda"),
                      0.9, 0.999, 1e-8)


@pytest.mark.gpu
def test_tiny_bert_served_on_card_launches_each_kernel(tmp_path):
    _need_card()
    with fluid.unique_name.guard():
        main, startup, _, _ = transformer.build_bert(dtype="bfloat16", **TINY)
    logits = next(op for op in main.global_block().ops
                  if op.type == "softmax_with_cross_entropy").input("Logits")[0]
    for p in ("fuse_ln_residual", "fuse_bias_act"):
        fluid.passes.apply_pass(main, p)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(str(tmp_path), ["ids", "pos_ids"], [logits], exe, main, scope)
    feed = transformer.make_fake_batch(3, 16, 200, rng=np.random.RandomState(0))
    card = fluid.inference.create_predictor(fluid.inference.AnalysisConfig(str(tmp_path)))
    before = dict(ck.LAUNCHES)
    got = card.run(feed)[0]
    assert {k: ck.LAUNCHES[k] - before[k] for k in before} == dict(
        NO_LAUNCHES, ln_residual_fwd=5, bias_act_fwd=2, attention_fwd=2)
    cpu = fluid.inference.create_predictor(
        fluid.inference.AnalysisConfig(str(tmp_path), fluid.CPUPlace())).run(feed)[0]
    # bf16 fetches (ml_dtypes arrays) subtract in bf16: widen first
    assert np.abs(got.astype(np.float32) - cpu.astype(np.float32)).max() <= 5e-2


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def _grad_tol(dtype, ref):
    """1e-4 * (1 + max|ref|) in float32; 5e-2 of max|ref| in bfloat16, and
    the same 12.8 steps of float16's, 6.25e-3, in float16."""
    peak = float(ref.float().abs().max())
    return {"float32": 1e-4 * (1.0 + peak), "bfloat16": 5e-2 * peak}.get(dtype, 6.25e-3 * peak)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_training_kernels_match_plain_on_card(dtype):
    """The five training kernels against their plain versions, ragged rows
    and an odd Adam size included, and their backward reductions repeat
    bit for bit."""
    _need_card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(1)

    def rn(*shape, s=1.0, d=dt):
        return (torch.randn(*shape, generator=g, device="cuda") * s).to(d)

    before = dict(ck.LAUNCHES)
    x, r, gy = rn(301, 768), rn(301, 768), rn(301, 768)
    s = rn(768, s=0.2, d=torch.float32) + 1.0
    got = ck.ln_residual_bwd(x, r, s, gy, 1e-5)
    want = ck.ln_residual_bwd_plain(x, r, s, gy, 1e-5)
    assert _err(got[0], want[0]) <= _grad_tol(dtype, want[0])
    # dscale and dbias column by column (ck.LN_BWD_RULE), in float32 also
    # within the flat gradient tolerance
    for a, b, t in zip(got[1:], want[1:], ck.ln_residual_bwd_allowed(x, r, gy, 1e-5)):
        if dtype == "float32":
            t = torch.clamp(t, max=_grad_tol(dtype, b))
        assert ((a - b).abs() <= t).all()
    again = ck.ln_residual_bwd(x, r, s, gy, 1e-5)
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    # dx element by element and dbias column by column (ck.BIAS_ACT_BWD_RULE),
    # in float32 also within the flat gradient tolerance
    x, gy, b = rn(301, 1000), rn(301, 1000), rn(1000, s=0.1, d=torch.float32)
    got = ck.bias_act_bwd(x, b, gy, "gelu")
    want = ck.bias_act_bwd_plain(x, b, gy, "gelu")
    for a, w, t in zip(got, want, ck.bias_act_bwd_allowed(x, b, gy, "gelu", want)):
        if dtype == "float32":
            t = torch.clamp(t, max=_grad_tol(dtype, w))
        assert ((a.float() - w.float()).abs() <= t).all()
    assert torch.equal(got[1], ck.bias_act_bwd(x, b, gy, "gelu")[1])
    logits = rn(64, 1001, s=2.0)
    labels = torch.randint(0, 1001, (64,), generator=g, device="cuda").to(torch.int32)
    labels[::3] = -100
    labels[1], labels[2] = 0, 1000
    gl = 1.0 + torch.rand(64, generator=g, device="cuda")
    # the logits as they are, and as a view one element off the 16-byte grid
    for x in (logits, rn(64 * 1001 + 1, s=2.0)[1:].view(64, 1001)):
        loss, lse = ck.softmax_xent_fwd(x, labels)
        loss_p, lse_p = ck.softmax_xent_fwd_plain(x, labels)
        assert _err(loss, loss_p) <= 2e-5  # float32 on both sides
        dx = ck.softmax_xent_bwd(x, labels, lse_p, gl)
        dx_p = ck.softmax_xent_bwd_plain(x, labels, lse_p, gl)
        if dtype == "float32":
            allowed = 1e-6 * dx_p.float().abs() + 1e-12
        else:  # one rounding of the logits' dtype
            allowed = ck.stored_step(dt, dx_p) + 1e-12
        assert ((dx.float() - dx_p.float()).abs() <= allowed).all()
        assert not dx[::3].any()
    # g^2 of v's order: one step moves p, m and v by ~1e3 times the allowance,
    # 2^-20 of the magnitudes of each output's terms (+ a bf16 rounding of p)
    p, gr = rn(1001, s=0.02), rn(1001, s=0.01)
    m = rn(1001, s=0.01, d=torch.float32)
    v = (0.5 + torch.rand(1001, generator=g, device="cuda")) * 1e-4
    lr_t = torch.full((1,), 1e-3, device="cuda")
    want = ck.adam_plain(p, gr, m, v, lr_t, 0.9, 0.999, 1e-8)
    terms_m = 0.9 * m.abs() + 0.1 * gr.float().abs()
    terms = (p.float().abs() + lr_t * terms_m / (want[2].sqrt() + 1e-8), terms_m,
             0.999 * v + 0.001 * gr.float() ** 2)
    got = ck.fused_adam(p, gr, m, v, lr_t, 0.9, 0.999, 1e-8)
    assert got[0] is p  # updated in place
    for a, w, t in zip(got, want, terms):
        assert ((a.float() - w.float()).abs() <= 2.0 ** -20 * t + ck.stored_step(w.dtype, w)
                + 1e-30).all()
    assert {k: ck.LAUNCHES[k] - before[k] for k in before} == dict(
        NO_LAUNCHES, ln_residual_bwd=2, bias_act_bwd=2, softmax_xent_fwd=2, softmax_xent_bwd=2,
        adam=1)


ROW_COUNTS = [1, 3, 301, 4095, 16384]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("d", [768, 1000, 1024, 3072])
@pytest.mark.parametrize("rows", ROW_COUNTS)
def test_bias_act_backward_kernel_at_its_edges_on_card(rows, d, dtype):
    """dx and dbias against bias_act_bwd_plain by ck.BIAS_ACT_BWD_RULE (in
    float32 also within the flat gradient tolerance), gelu and relu, into
    NaN-poisoned memory, with x as it is and as a view one element off the
    16-byte grid (the scalar route; so is d = 1000); dbias bit for bit on a
    rerun; one launch a call."""
    _need_card()
    import chip_smoke  # the repository root's: NaN into the outputs' memory

    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(8)
    x, g = (torch.randn(rows, d, generator=gen, device="cuda").to(dt) for _ in range(2))
    off = torch.randn(rows * d + 1, generator=gen, device="cuda").to(dt)[1:].view(rows, d)
    b = torch.randn(d, generator=gen, device="cuda") * 0.1
    for act in ("gelu", "relu"):
        for xs in (x, off):
            chip_smoke.poison(torch, (xs.shape, dt), ((d,), torch.float32))
            before = dict(ck.LAUNCHES)
            got = ck.bias_act_bwd(xs, b, g, act)
            assert {k: ck.LAUNCHES[k] - before[k] for k in before} == dict(
                NO_LAUNCHES, bias_act_bwd=1)
            want = ck.bias_act_bwd_plain(xs, b, g, act)
            for a, w, t in zip(got, want, ck.bias_act_bwd_allowed(xs, b, g, act, want)):
                if dtype == "float32":
                    t = torch.clamp(t, max=_grad_tol(dtype, w))
                assert a.dtype == w.dtype and a.shape == w.shape
                assert ((a.float() - w.float()).abs() <= t).all(), act
            assert torch.equal(got[1], ck.bias_act_bwd(xs, b, g, act)[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("d", [768, 1000, 1024, 2048, 3072, 4096])
@pytest.mark.parametrize("rows", ROW_COUNTS)
def test_ln_forward_kernel_at_its_edges_on_card(rows, d, dtype):
    """The LayerNorm+residual forward against ln_residual_plain, with and
    without the residual, into NaN-poisoned memory, with x as it is and as a
    view one element off the 16-byte grid (the scalar route; so is d =
    1000); rows up to 1024 take one warp a row, wider ones several; one
    launch a call.  float32 within FUSED_KERNELS' 2e-5.  bfloat16 against
    the plain version run in float32 on the same values and rounded once,
    the kernel's own contract (the bfloat16 plain version rounds x + res to
    bfloat16 first), element by element within one rounding, 2^-7 of
    |plain|, plus 1e-4 for the float32 statistics' noise where y is near 0
    (FUSED_KERNELS' flat 5e-2 is less than one unit in the last place once
    |y| >= 8, which 16384 rows of 3072 reach)."""
    _need_card()
    import chip_smoke  # the repository root's: NaN into the outputs' memory

    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(9)
    x, res = (torch.randn(rows, d, generator=gen, device="cuda").to(dt) for _ in range(2))
    off = torch.randn(rows * d + 1, generator=gen, device="cuda").to(dt)[1:].view(rows, d)
    scale = torch.rand(d, generator=gen, device="cuda") + 0.5
    bias = torch.randn(d, generator=gen, device="cuda") * 0.1
    for r in (res, None):
        for xs in (x, off):
            chip_smoke.poison(torch, (xs.shape, dt))
            before = dict(ck.LAUNCHES)
            got = ck.fused_ln_residual(xs, r, scale, bias, 1e-5)
            assert {k: ck.LAUNCHES[k] - before[k] for k in before} == dict(
                NO_LAUNCHES, ln_residual_fwd=1)
            want = ck.ln_residual_plain(xs.float(), None if r is None else r.float(), scale,
                                        bias, 1e-5).to(dt)
            assert got.dtype == dt and got.shape == want.shape
            if dtype == "float32":
                assert _err(got, want) <= 2e-5, r is None
            elif dtype == "float16":  # FWD_ROUNDING_RULE, element by element
                allowed = ck.ln_residual_fwd_allowed(xs, r, scale, bias, want)
                assert ((got.float() - want.float()).abs() <= allowed).all(), r is None
            else:
                allowed = 2.0 ** -7 * want.float().abs() + 1e-4
                assert ((got.float() - want.float()).abs() <= allowed).all(), r is None


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
@pytest.mark.parametrize("rows,w", [(2 * 64, 12544), (3 * 2048 + 1, 49), (5, 7)])
def test_bn_epilogue_kernels_match_plain_on_card(rows, w, relu, dtype):
    """Both BN epilogue kernels against their plain versions at the
    ResNet-50 stem's and last stage's row widths, an odd R and a row shorter
    than a 16-byte vector: the forward at FUSED_KERNELS' tolerance (f32
    2e-5, bf16 2e-2), the backward element by element (dx within one
    rounding, dmul / dadd within 1e-5 of sum|g*x| and sum|g| of the row),
    the row sums bit for bit on a second run; and a view one element off
    the 16-byte grid (the scalar path)."""
    _need_card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(rows, w, generator=g, device="cuda").to(dt)
    gy = torch.randn(rows, w, generator=g, device="cuda").to(dt)
    mul = torch.rand(rows, generator=g, device="cuda") + 0.5
    add = torch.randn(rows, generator=g, device="cuda") * 0.1
    before = dict(ck.LAUNCHES)
    off = torch.randn(rows * w + 1, generator=g, device="cuda").to(dt)[1:].view(rows, w)
    for xs in (x, off):
        want = ck.bn_epilogue_plain(xs, mul, add, relu)
        tol = {"float32": 2e-5, "bfloat16": 2e-2}.get(dtype)
        if tol is None:  # float16: FWD_ROUNDING_RULE, element by element
            tol = ck.bn_epilogue_fwd_allowed(xs, mul, add, want)
        assert ((ck._epilogue_fwd(xs, mul, add, relu).float() - want.float()).abs() <= tol).all()
    got = ck.bn_epilogue_bwd(x, mul, add, gy, relu)
    want = ck.bn_epilogue_bwd_plain(x, mul, add, gy, relu)
    gf = gy.float()
    ulp = {"float32": 2.0 ** -23 * want[0].float().abs(),
           "bfloat16": 2.0 ** -8 * want[0].float().abs()}.get(dtype)
    if ulp is None:
        ulp = ck.stored_step(dt, want[0])
    allowed = (ulp + 1e-30, 1e-5 * (gf * x.float()).abs().sum(-1) + 1e-30,
               1e-5 * gf.abs().sum(-1) + 1e-30)
    for a, b, t in zip(got, want, allowed):
        assert ((a.float() - b.float()).abs() <= t).all()
    again = ck.bn_epilogue_bwd(x, mul, add, gy, relu)
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    assert {k: ck.LAUNCHES[k] - before[k] for k in before} == dict(
        NO_LAUNCHES, bn_epilogue_fwd=2, bn_epilogue_bwd=2)


@pytest.mark.gpu
def test_bn_epilogue_checks_its_operands_on_card():
    _need_card()
    x = torch.zeros(4, 6, device="cuda")
    v = torch.ones(4, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        ck.fused_scale_shift_relu(x, v.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="contiguous"):
        ck.fused_scale_shift_relu(x.t().contiguous().t(), v, v)
    with pytest.raises(TypeError, match="not supported"):  # float64: no kernel takes it
        ck.fused_scale_shift_relu(x.double(), v, v)
    # a CUDA input that requires grad is fine: the backward is a kernel too
    xg = torch.randn(2, 3, 4, 4, device="cuda", requires_grad=True)
    m = torch.ones(3, device="cuda", requires_grad=True)
    (ck.bn_epilogue(xg, m, torch.zeros(3, device="cuda"), True).sum()).backward()
    assert xg.grad is not None and m.grad is not None


@pytest.mark.gpu
def test_attention_backward_wrappers_check_their_operands_on_card():
    """A CUDA q with a host lse, di or bias, or k and v that do not fit q,
    raises before a launch."""
    _need_card()
    q = torch.zeros(1, 2, 8, 16, device="cuda")
    lse = torch.zeros(1, 2, 8, device="cuda")
    host = torch.zeros(1, 2, 8)
    host_bias = torch.zeros(1, 1, 8, 8)
    before = dict(ck.LAUNCHES)
    with pytest.raises(ValueError, match="several devices"):
        ca.attention_bwd_dq(q, q, q, None, False, 1.0, q, host, q)
    with pytest.raises(ValueError, match="several devices"):
        ca.attention_bwd_dkv(q, q, q, None, False, 1.0, lse, host, q)
    with pytest.raises(ValueError, match="several devices"):
        ca.attention_bwd_dkv(q, q, q, host_bias, False, 1.0, lse, lse, q)
    with pytest.raises(ValueError, match="several devices"):
        ca.attention_bwd(q, q, q, None, False, 1.0, q, host, q)
    with pytest.raises(ValueError, match="do not match"):
        ca.attention_bwd_dq(q, q[:, :1], q, None, False, 1.0, q, lse, q)
    short = torch.zeros(1, 2, 4, 16, device="cuda")
    with pytest.raises(ValueError, match="is not q's"):
        ca.attention_bwd_dkv(q, q, q, None, False, 1.0, lse, lse, short)
    assert ck.LAUNCHES == before


def _train_tiny_on_card_and_cpu(fused, steps):
    """Adam steps of the tiny BERT (dropout 0, float32) on the card and on the
    CPU from one state: the card's losses, scope and launches, the CPU's
    (the caller's test holds exact_card_math)."""
    config = dict(TINY, use_fused_attention=fused, dropout_prob=0.0, learning_rate=1e-3,
                  with_optimizer=True)
    with fluid.unique_name.guard():
        main, startup, _, fetches = transformer.build_bert(**config)
    loss = fetches["loss"].name
    for p in ("fuse_ln_residual", "fuse_bias_act"):
        fluid.passes.apply_pass(main, p, keep=[loss])
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    state = {v.name: init.to_numpy(v.name) for v in main.list_vars() if v.persistable}
    feed = transformer.make_fake_batch(4, 16, 200, rng=np.random.RandomState(1))
    params = [p.name for p in main.all_parameters()]
    grads = [f"{p}@GRAD" for p in params]
    runs = []
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.Scope()
        fluid.io.load_numpy_params(scope, state, device=place.device)
        exe = fluid.Executor(place)
        before = dict(ck.LAUNCHES)
        outs = [exe.run(main, feed=feed, fetch_list=[loss] + grads, scope=scope)
                for _ in range(steps)]
        runs.append(([float(o[0][0]) for o in outs], scope, [o[1:] for o in outs],
                     {k: ck.LAUNCHES[k] - before[k] for k in before}, exe.last_plan))
    (gl, gs, _, gd, plan), (cl, cs, cpu_grads, cd, _) = runs
    assert cd == NO_LAUNCHES
    np.testing.assert_allclose(gl, cl, atol=1e-4)
    peaks = [max(float(np.abs(g).max()) for g in step) for step in cpu_grads]
    for i, p in enumerate(params):
        err = np.abs(gs.to_numpy(p) - cs.to_numpy(p))
        near_zero = np.zeros(err.shape, bool)
        for step, peak in zip(cpu_grads, peaks):
            near_zero |= np.abs(step[i]) <= 1e-6 * peak
        assert err.max() <= 2 * 1e-3 * steps + 1e-5, p
        assert not (err[~near_zero] > 1e-5).any(), p
    return main, gd, plan


def _hold_graphed_launches(launches, plan, per_step):
    """A plan that ran >= 2 steps on the card: the first ran eagerly, the
    second captured one step into a CUDA graph that every later step
    replays.  The wrappers count a launch where they enqueue one, so the
    eager step and the capture each count one step's launches, and the
    graph holds exactly one step's."""
    assert plan.graphed and plan.graph_refusal is None
    assert plan.captured_launches == per_step
    assert launches == {k: 2 * v for k, v in per_step.items()}


@pytest.mark.gpu
def test_tiny_bert_trains_on_card_like_cpu(exact_card_math):
    """Adam steps of the tiny BERT (unfused attention, dropout 0, float32) on
    the card match the CPU's, and each step launches every training kernel.
    Parameters agree to 1e-5, save the elements whose CPU gradient is 0 to
    rounding (within 1e-6 of the largest) at some step, where the summation
    order can flip the sign of Adam's first step: 2*lr*steps + 1e-5."""
    _need_card()
    main, launches, plan = _train_tiny_on_card_and_cpu(False, 3)
    _hold_graphed_launches(launches, plan, dict(
        NO_LAUNCHES, ln_residual_fwd=5, ln_residual_bwd=5, bias_act_fwd=2, bias_act_bwd=2,
        softmax_xent_fwd=1, softmax_xent_bwd=1, adam=len(main.all_parameters())))


@pytest.mark.gpu
def test_tiny_bert_with_fused_attention_trains_on_card_like_cpu(exact_card_math):
    """Two Adam steps of the tiny BERT with the fused_attention op, by the
    rule above: each step runs the attention forward, dQ and dK/dV kernels
    once per layer."""
    _need_card()
    main, launches, plan = _train_tiny_on_card_and_cpu(True, 2)
    _hold_graphed_launches(launches, plan, dict(
        NO_LAUNCHES, ln_residual_fwd=5, ln_residual_bwd=5, bias_act_fwd=2, bias_act_bwd=2,
        softmax_xent_fwd=1, softmax_xent_bwd=1, attention_fwd=2, attention_bwd_dq=2,
        attention_bwd_dkv=2, adam=len(main.all_parameters())))


# the attention kernels at their edges: lengths that are not multiples of
# the 64-row tiles and 32-column passes, causal with Lq > Lk (rows with no
# visible key) and Lq < Lk with a per-head bias, dh 16 and 128
EDGE_CASES = [
    (2, 3, 129, 129, 64, None, False),
    (2, 3, 200, 72, 64, None, True),
    (2, 3, 72, 200, 64, "per_head", True),
    (2, 2, 129, 129, 16, None, False),
    (2, 2, 200, 72, 16, None, True),
    (2, 2, 129, 129, 128, None, False),
    (2, 2, 72, 200, 128, "per_head", True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", EDGE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_backward_kernels_at_their_edges_on_card(case, dtype):
    """dq against sdpa_bwd_dq_plain and dk, dv against sdpa_bwd_dkv_plain, on
    the kernels' own forward output: float32 within 1e-4 * (1 + max|ref|),
    bfloat16 element by element (cuda_attention.BWD_BF16_RULE); a second run
    gives the same bits; each wrapper launches its kernel once a call."""
    _need_card()
    B, H, Lq, Lk, dh, bias_kind, causal = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(B, H, n, dh, generator=g, device="cuda").to(dt)
                   for n in (Lq, Lk, Lk, Lq))
    bias = None
    if bias_kind == "per_head":
        bias = torch.randn(B, H, Lq, Lk, generator=g, device="cuda") * 2.0
    scale = dh ** -0.5
    out, lse = ca.attention_fwd(q, k, v, bias, causal, scale)
    before = dict(ck.LAUNCHES)
    dq, di = ca.attention_bwd_dq(q, k, v, bias, causal, scale, out, lse, do)
    dk, dv = ca.attention_bwd_dkv(q, k, v, bias, causal, scale, lse, di, do)
    assert {n: ck.LAUNCHES[n] - before[n] for n in before} == dict(
        NO_LAUNCHES, attention_bwd_dq=1, attention_bwd_dkv=1)
    assert torch.equal(dq, ca.attention_bwd_dq(q, k, v, bias, causal, scale, out, lse, do)[0])
    again = ca.attention_bwd_dkv(q, k, v, bias, causal, scale, lse, di, do)
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])
    want = (ca.sdpa_bwd_dq_plain(q, k, v, bias, causal, scale, out, do),
            *ca.sdpa_bwd_dkv_plain(q, k, v, bias, causal, scale, out, do))
    if dtype == "float32":
        allowed = [_grad_tol(dtype, w) for w in want]
    else:
        allowed = ca.sdpa_bwd_bf16_allowed(q, k, v, bias, causal, scale, out, do, want)
    for name, got, w, a in zip(("dq", "dk", "dv"), (dq, dk, dv), want, allowed):
        assert got.dtype == dt and got.shape == w.shape
        assert ((got.float() - w.float()).abs() <= a).all(), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", EDGE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_forward_kernel_at_its_edges_on_card(case, dtype):
    """out against sdpa_plain: float32 within 1e-4, bfloat16 element by
    element (cuda_attention.FWD_BF16_RULE); lse against the float32
    logsumexp of the plain scores within 1e-5 * (1 + |ref|) (a row with no
    visible key: -1e30); one launch a call."""
    _need_card()
    B, H, Lq, Lk, dh, bias_kind, causal = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (torch.randn(B, H, n, dh, generator=g, device="cuda").to(dt) for n in (Lq, Lk, Lk))
    bias = None
    if bias_kind == "per_head":
        bias = torch.randn(B, H, Lq, Lk, generator=g, device="cuda") * 2.0
    scale = dh ** -0.5
    before = dict(ck.LAUNCHES)
    out, lse = ca.attention_fwd(q, k, v, bias, causal, scale)
    assert {n: ck.LAUNCHES[n] - before[n] for n in before} == dict(NO_LAUNCHES, attention_fwd=1)
    want = ca.sdpa_plain(q, k, v, bias, causal, scale)
    assert out.dtype == dt and out.shape == want.shape
    if dtype == "float32":
        assert _err(out, want) <= 1e-4
    else:
        allowed = ca.sdpa_fwd_bf16_allowed(q, k, v, bias, causal, scale, want)
        assert ((out.float() - want.float()).abs() <= allowed).all()
    ref = torch.logsumexp(ca._scores_plain(q, k, bias, causal, scale)[0], dim=-1)
    assert lse.dtype == torch.float32 and lse.shape == ref.shape
    assert ((lse - ref).abs() <= 1e-5 * (1.0 + ref.abs())).all()


@pytest.mark.gpu
@pytest.mark.parametrize("lk", [513, 4196])
def test_bf16_score_forward_across_its_buffers_on_card(lk):
    """The bf16-score forward of bf16 inputs where a row's keys straddle its
    buffers: 513 keys (one past one CTA's score buffer: a cluster of 2, its
    last tile one key) and 4196 (past what a cluster of 8 holds: each CTA
    recomputes a tile), ragged query rows.  out against sdpa_plain with bf16
    scores element by element (FWD_BF16_RULE + SCORE_ROUNDING_RULE), the row
    maxima within one bf16 step of the plain version's, two runs bit for
    bit, one launch a call."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(9)
    q = torch.randn(1, 4, 100, 64, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(1, 4, lk, 64, generator=g, device="cuda").bfloat16() for _ in range(2))
    args = (q, k, v, None, False, 0.125)
    before = dict(ck.LAUNCHES)
    out, stats = ca.attention_fwd(*args, score_bf16=True)
    assert {n: ck.LAUNCHES[n] - before[n] for n in before} == dict(
        NO_LAUNCHES, attention_fwd_bf16_scores=1)
    want = ca.sdpa_plain(*args, score_bf16=True)
    allowed = (ca.sdpa_fwd_bf16_allowed(*args, want, score_bf16=True)
               + ca.score_rounding_allowed(*args))
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    assert ((out.float() - want.float()).abs() <= allowed).all()
    m = ca._probs_plain(q, k, None, False, 0.125, True)[2][..., 0]
    assert stats.shape == (2, 1, 4, 100)
    assert ((stats[1] - m).abs() <= 2.0 ** -7 * m.abs()).all()
    again = ca.attention_fwd(*args, score_bf16=True)
    assert torch.equal(out, again[0]) and torch.equal(stats, again[1])


# the cross-entropy forward at its edges: one row, a few columns, V below and
# above the block's vectors, odd V (bf16 rows off the 16-byte grid), BERT's
# vocabulary at seq 128 and 2048
XENT_SHAPES = [(1, 1), (3, 7), (301, 1000), (301, 1001), (4096, 30522), (16384, 30522)]


def _xent_labels(kind, rows, v, g):
    labels = torch.randint(0, v, (rows,), generator=g, device="cuda")
    if kind == "all_ignored":
        labels[:] = -100
    else:  # ignored rows, 0, V-1 and labels outside [0, V) that pick 0, in turn
        cycle = torch.tensor([-100, 0, v - 1, v + 3, -7, -100, -100], device="cuda")
        pick = torch.arange(rows, device="cuda") % 9
        labels = torch.where(pick < 7, cycle[pick.clamp(max=6)], labels)
    return labels.to(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("kind", ["mixed", "all_ignored"])
@pytest.mark.parametrize("rows,v", XENT_SHAPES, ids=lambda s: str(s))
def test_xent_forward_kernel_at_its_edges_on_card(rows, v, kind, dtype):
    """loss and lse against softmax_xent_fwd_plain within 2e-5 (float32 on
    both sides), lse 0 on ignored rows, into NaN-poisoned memory, for the
    logits as they are and as a view one element off the 16-byte grid; a
    second call bit for bit; one launch a call."""
    _need_card()
    import chip_smoke  # the repository root's: NaN into the outputs' memory

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(8)
    labels = _xent_labels(kind, rows, v, g)
    live = labels != -100
    base = (torch.randn(rows * v + 1, generator=g, device="cuda") * 2.0).to(dt)
    for x in (base[:-1].view(rows, v), base[1:].view(rows, v)):
        chip_smoke.poison(torch, ((rows,), torch.float32), ((rows,), torch.float32))
        before = dict(ck.LAUNCHES)
        loss, lse = ck.softmax_xent_fwd(x, labels)
        assert {n: ck.LAUNCHES[n] - before[n] for n in before} == dict(NO_LAUNCHES,
                                                                       softmax_xent_fwd=1)
        loss_p, lse_p = ck.softmax_xent_fwd_plain(x, labels)
        assert _err(loss, loss_p) <= 2e-5
        if bool(live.any()):
            assert _err(lse[live], lse_p[live]) <= 2e-5
        assert not loss[~live].any() and not lse[~live].any()
        again = ck.softmax_xent_fwd(x, labels)
        assert torch.equal(loss, again[0]) and torch.equal(lse, again[1])


def _tiny_deepfm(opt, lazy=False):
    """build_zoo(tiny=True)'s DeepFM with Adagrad(0.05) or Adam(1e-3)."""
    from paddle_tpu_torch.models import deepfm

    with fluid.unique_name.guard():
        main, startup, _, fetches = deepfm.build(num_fields=4, vocab_size=50, embed_dim=4,
                                                 mlp_dims=(8,), with_optimizer=False)
        with fluid.program_guard(main, startup):
            (fluid.optimizer.Adagrad(0.05) if opt == "adagrad"
             else fluid.optimizer.Adam(1e-3, lazy_mode=lazy)).minimize(fetches["loss"])
    return main, startup, fetches["loss"].name


@pytest.mark.gpu
@pytest.mark.parametrize("opt,lazy", [("adagrad", False), ("adam", False), ("adam", True)],
                         ids=["adagrad", "adam", "lazy_adam"])
def test_tiny_deepfm_trains_on_card_like_cpu(opt, lazy):
    """3 steps of the tiny DeepFM from one numpy state on the card and on the
    CPU: losses within 1e-5 relative, every persistable within 1e-5 of its
    largest magnitude, save (Adam) the elements whose CPU gradient is 0 to
    rounding at some step, which keep 2*lr*steps + 1e-5.  The Adam kernel
    runs once per adam op a step, save a lazy one over a SelectedRows
    gradient; Adagrad launches nothing."""
    _need_card()
    main, startup, loss = _tiny_deepfm(opt, lazy)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    state = {v.name: init.to_numpy(v.name) for v in main.list_vars() if v.persistable}
    rng = np.random.RandomState(0)
    feed = {"feat_ids": rng.randint(0, 50, (4, 4)).astype("int64"),
            "label": (rng.rand(4, 1) < 0.3).astype("float32")}
    params = [p.name for p in main.all_parameters()]
    runs = []
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.Scope()
        fluid.io.load_numpy_params(scope, state, device=place.device)
        exe = fluid.Executor(place)
        before = dict(ck.LAUNCHES)
        losses, grads = [], []
        for _ in range(3):
            out = exe.run(main, feed=feed, fetch_list=[loss] + [f"{p}@GRAD" for p in params],
                          scope=scope)
            losses.append(float(out[0].reshape(-1)[0]))
            grads.append(out[1:])
        launches = {n: ck.LAUNCHES[n] - before[n] for n in before}
        runs.append((losses, scope, grads, launches))
    (gl, gs, _, gd), (cl, cs, cpu_grads, cd) = runs
    n_adam = 0 if opt == "adagrad" else (len(params) - 2 if lazy else len(params))
    assert gd == dict(NO_LAUNCHES, adam=3 * n_adam) and cd == NO_LAUNCHES
    np.testing.assert_allclose(gl, cl, rtol=1e-5)
    near_zero = {p: np.zeros(state[p].shape, bool) for p in params}
    if opt == "adam":
        for step in cpu_grads:
            peak = max(float(np.abs(g).max()) for g in step)
            for p, g in zip(params, step):
                near_zero[p] |= np.abs(g) <= 1e-6 * peak
    for name in state:
        want = cs.to_numpy(name)
        err = np.abs(gs.to_numpy(name) - want)
        tol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
        if name in near_zero:
            assert err.max() <= tol + 2 * 1e-3 * 3, name
            err = err[~near_zero[name]]
        assert not (err > tol).any(), name


def _tiny_nmt(builder, **config):
    """The tiny NMT of tests/test_torch_nmt.py through the two fusion passes."""
    from paddle_tpu_torch.models import nmt

    with fluid.unique_name.guard():
        main, startup, _, fetches = getattr(nmt, builder)(
            src_vocab=64, tgt_vocab=80, d_model=32, n_layers=2, n_heads=2, d_ff=64, **config)
    keep = [v.name for v in fetches.values()]
    for p in ("fuse_ln_residual", "fuse_bias_act"):
        fluid.passes.apply_pass(main, p, keep=keep)
    return main, startup, fetches


@pytest.mark.gpu
def test_tiny_nmt_trains_and_decodes_on_card_like_cpu():
    """3 Adam steps of the tiny NMT (noam schedule, ragged feeds) from one
    numpy state on the card and on the CPU, by chip_smoke's phase 7 rule:
    losses within 1e-5 relative, parameters within 1e-5 save the elements
    whose CPU gradient is 0 to rounding at some step (2*lr*steps + 1e-5),
    moments within 1e-4 of the largest of their kind, the beta pows and
    the step counter equal; each step launches LN 10 + 10, bias+ReLU 4 + 4
    and Adam 88 (from the second step on, as one CUDA graph).  Then
    the compiled beam decode (beam 3) from the CPU's state: the card's ids
    equal the CPU's, the scores within 1e-5, and the kernels launch once a
    LayerNorm and once a bias+ReLU of the encoder and once each an iteration
    in the While's body."""
    _need_card()
    from paddle_tpu_torch.models import nmt

    main, startup, fetches = _tiny_nmt("build_transformer_nmt", dropout=0.0)
    loss = fetches["loss"].name
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    state = {v.name: init.to_numpy(v.name) for v in main.list_vars() if v.persistable}
    for name in state:
        if name.endswith(".ln.w"):
            state[name] = np.ones_like(state[name])
    feed = nmt.make_fake_nmt_batch([5, 9, 3, 7], [6, 4, 8, 2], 64, 80, seed=1)
    params = [p.name for p in main.all_parameters()]
    runs = []
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.Scope()
        fluid.io.load_numpy_params(scope, state, device=place.device)
        exe = fluid.Executor(place)
        before = dict(ck.LAUNCHES)
        losses, grads = [], []
        for _ in range(3):
            out = exe.run(main, feed=feed, fetch_list=[loss] + [f"{p}@GRAD" for p in params],
                          scope=scope)
            losses.append(float(out[0].reshape(-1)[0]))
            grads.append(out[1:])
        runs.append((losses, scope, grads, {n: ck.LAUNCHES[n] - before[n] for n in before},
                     exe.last_plan))
    (gl, gs, _, gd, plan), (cl, cs, cpu_grads, cd, _) = runs
    _hold_graphed_launches(gd, plan, dict(NO_LAUNCHES, ln_residual_fwd=10, ln_residual_bwd=10,
                                          bias_act_fwd=4, bias_act_bwd=4, adam=len(params)))
    assert cd == NO_LAUNCHES
    assert len(params) == 88
    np.testing.assert_allclose(gl, cl, rtol=1e-5)
    near_zero = {p: np.zeros(state[p].shape, bool) for p in params}
    for step in cpu_grads:
        peak = max(float(np.abs(g).max()) for g in step)
        for p, g in zip(params, step):
            near_zero[p] |= np.abs(g) <= 1e-6 * peak
    lr = 2.0 * 32 ** -0.5 * 2 * 400 ** -1.5  # the noam rate of the third step
    peak = {kind: max(float(np.abs(cs.to_numpy(n)).max()) for n in state
                      if n.endswith(f"_{kind}_0")) for kind in ("moment1", "moment2")}
    for name in state:
        want = cs.to_numpy(name)
        err = np.abs(gs.to_numpy(name) - want)
        kind = next((k for k in peak if name.endswith(f"_{k}_0")), None)
        if name in near_zero:
            assert err.max() <= 1e-5 + 2 * lr * 3, name
            held = err[~near_zero[name]]
            assert held.size == 0 or held.max() <= 1e-5, (name, float(held.max()))
        elif kind is not None:
            # a key bias's exact gradient is 0: its moments hold rounding
            # noise, held against the largest moment of their kind
            assert err.max() <= 1e-4 * peak[kind], (name, float(err.max()))
        else:  # beta pows and the step counter
            np.testing.assert_array_equal(gs.to_numpy(name), want, err_msg=name)

    decode, _, dfetch = _tiny_nmt("build_beam_decode", batch_size=3, src_len=7, beam_size=3,
                                  max_len=8)
    step = next(op.output("Out")[0] for op in decode.blocks[1].ops if op.type == "increment")
    rng = np.random.RandomState(3)
    src = rng.randint(3, 64, (3, 7)).astype("int64")
    lens = np.array([7, 4, 5], "int32")
    src[np.arange(7)[None, :] >= lens[:, None]] = 0
    outs = []
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.Scope()
        fluid.io.load_numpy_params(scope, {n: cs.to_numpy(n) for n in params}, device=place.device)
        before = dict(ck.LAUNCHES)
        out = fluid.Executor(place).run(
            decode, feed={"src_word": src, "src_len_vec": lens},
            fetch_list=[dfetch["out_ids"], dfetch["out_scores"], step], scope=scope)
        outs.append((out, {n: ck.LAUNCHES[n] - before[n] for n in before}))
    ((g_ids, g_scores, g_t), g_launch), ((c_ids, c_scores, c_t), c_launch) = outs
    np.testing.assert_array_equal(g_ids, c_ids)
    np.testing.assert_allclose(g_scores, c_scores, atol=1e-5, rtol=0)
    it = int(c_t[0]) - 1
    assert int(g_t[0]) == int(c_t[0]) and c_launch == NO_LAUNCHES
    assert g_launch == dict(NO_LAUNCHES, ln_residual_fwd=4 + 6 * it, bias_act_fwd=2 + 2 * it)


# --------------------------------------------------------------------------
# the executor's CUDA graphs
# --------------------------------------------------------------------------


def _tiny_bert_train(dropout):
    with fluid.unique_name.guard():
        main, startup, _, fetches = transformer.build_bert(**dict(
            TINY, use_fused_attention=True, dropout_prob=dropout, learning_rate=1e-3,
            with_optimizer=True))
    main.random_seed = startup.random_seed = 0
    return main, startup, fetches["loss"].name


def _tiny_mnist_momentum():
    from paddle_tpu_torch.models import mnist

    with fluid.unique_name.guard():
        main, startup, _, fetches = mnist.build(with_optimizer=False)
        with fluid.program_guard(main, startup):
            fluid.optimizer.Momentum(0.05, 0.9).minimize(fetches["loss"])
    main.random_seed = startup.random_seed = 0
    return main, startup, fetches["loss"].name


def _state_of(main, startup):
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    return {v.name: init.to_numpy(v.name) for v in main.list_vars() if v.persistable}


def _feeds_of(model, n):
    rng = np.random.RandomState(2)
    if model == "mnist":
        return [{"img": rng.rand(8, 1, 28, 28).astype("f4"),
                 "label": rng.randint(0, 10, (8, 1)).astype("int64")} for _ in range(n)]
    return [dict(transformer.make_fake_batch(4, 16, 200, rng=rng)) for _ in range(n)]


def _card_run(main, state, feeds, fetches, graphs, program=None):
    """Steps on the card from `state` (the caller's test holds
    exact_card_math)."""
    scope = fluid.Scope()
    fluid.io.load_numpy_params(scope, state, device="cuda:0")
    exe = fluid.Executor(fluid.CUDAPlace(0), _graphs=graphs)
    outs, ids = [], []
    for f in feeds:
        outs.append(exe.run(program or main, feed=f, fetch_list=fetches, scope=scope))
        ids.append({n: id(scope.find_var(n)) for n in state})
    return outs, scope, exe, ids


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["bert_adam_dropout", "mnist_momentum"])
def test_graphed_steps_match_eager_steps_on_card(model, exact_card_math):
    """4 steps replayed from a CUDA graph against 4 eager steps from one
    state: the tiny BERT (fused attention, dropout 0.1: the graph draws the
    scope generator's masks) with Adam, and the tiny MNIST with Momentum,
    whose velocities, like its parameters, are new tensors each step.  The
    fetches and every persistable agree within phase 7's tolerances
    (losses 1e-3, state 1e-5 of its largest magnitude), the plan is
    graphed, and from the capture on the scope holds the same tensors."""
    _need_card()
    main, startup, loss = (_tiny_mnist_momentum() if model == "mnist_momentum"
                           else _tiny_bert_train(0.1))
    state = _state_of(main, startup)
    feeds = _feeds_of("mnist" if model == "mnist_momentum" else "bert", 4)
    g_out, g_scope, g_exe, g_ids = _card_run(main, state, feeds, [loss], True)
    e_out, e_scope, e_exe, _ = _card_run(main, state, feeds, [loss], False)
    assert g_exe.last_plan.graphed and not e_exe.last_plan.graphed
    assert g_ids[1] == g_ids[2] == g_ids[3]
    np.testing.assert_allclose([o[0] for o in g_out], [o[0] for o in e_out], atol=1e-3, rtol=0)
    for n in state:
        want = e_scope.to_numpy(n)
        err = float(np.abs(g_scope.to_numpy(n).astype(np.float32) - want).max())
        assert err <= 1e-5 * max(float(np.abs(want).max()), 1.0), (n, err)
        assert not np.array_equal(want, state[n]) or "velocity" not in n, n


@pytest.mark.gpu
def test_graph_refused_plans_run_eagerly_on_card():
    """A `while` plan and a SelectedRows plan carry their refusal and run."""
    _need_card()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        i = fluid.layers.assign(np.zeros(1, "int32"))
        n = fluid.layers.assign(np.full(1, 3, "int32"))
        cond = fluid.layers.less_than(i, n)
        w = fluid.layers.While(cond)
        with w.block():
            fluid.layers.increment(i)
            fluid.layers.less_than(i, n, cond=cond)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    for _ in range(3):
        (got,) = exe.run(main, fetch_list=[i.name], scope=scope)
        assert int(got[0]) == 3
    assert "while op" in exe.last_plan.graph_refusal and not exe.last_plan.graphed
    main, startup, loss = _tiny_deepfm("adagrad")
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"feat_ids": np.random.RandomState(0).randint(0, 50, (4, 4)).astype("int64"),
            "label": np.ones((4, 1), "float32")}
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0].reshape(-1)[0])
              for _ in range(3)]
    assert "SelectedRows" in exe.last_plan.graph_refusal and not exe.last_plan.graphed
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.gpu
def test_steps_k_equals_k_runs_on_card(exact_card_math):
    """steps=3 from stacked feeds (one warm-up step, then the graph replayed
    twice) against 3 graphed runs: the same losses and state."""
    _need_card()
    main, startup, loss = _tiny_bert_train(0.0)
    state = _state_of(main, startup)
    feeds = _feeds_of("bert", 3)
    runs, r_scope, _, _ = _card_run(main, state, feeds, [loss], True)
    scope = fluid.Scope()
    fluid.io.load_numpy_params(scope, state, device="cuda:0")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    stacked = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
    (losses,) = exe.run(main, feed=stacked, fetch_list=[loss], scope=scope, steps=3)
    assert exe.last_plan.graphed and losses.shape[0] == 3
    np.testing.assert_array_equal(losses, np.stack([o[0] for o in runs]))
    for n in state:
        np.testing.assert_array_equal(scope.to_numpy(n), r_scope.to_numpy(n), err_msg=n)


@pytest.mark.gpu
def test_run_async_train_loop_and_remat_on_card(exact_card_math):
    """On graphed plans: run_async's handles equal run's; train_loop with
    max_inflight 2 equals the serial losses; remat equals no remat with
    dropout 0.1 (the recompute repeats the masks) within phase 7's
    tolerances; a set_var between replays is seen by the next step."""
    _need_card()
    main, startup, loss = _tiny_bert_train(0.1)
    state = _state_of(main, startup)
    feeds = _feeds_of("bert", 6)
    serial, s_scope, _, _ = _card_run(main, state, feeds, [loss], True)
    scope = fluid.Scope()
    fluid.io.load_numpy_params(scope, state, device="cuda:0")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    handles = [exe.run_async(main, feed=f, fetch_list=[loss], scope=scope) for f in feeds]
    for (h,), want in zip(handles, serial):
        np.testing.assert_array_equal(h.numpy(), want[0])
    scope = fluid.Scope()
    fluid.io.load_numpy_params(scope, state, device="cuda:0")
    stats = fluid.train_loop(fluid.Executor(fluid.CUDAPlace(0)), main, iter(feeds), [loss],
                             scope=scope, max_inflight=2, log_period=1)
    assert stats.steps == 6 and stats.max_inflight_seen == 2
    for s, vals in stats.logged:
        np.testing.assert_array_equal(vals[0], serial[s][0])
    strategy = fluid.BuildStrategy()
    strategy.memory_optimize = True
    compiled = fluid.CompiledProgram(main, strategy)
    remat, r_scope, r_exe, _ = _card_run(main, state, feeds, [loss], True, compiled)
    assert r_exe.last_plan.graphed and r_exe.last_plan.remat
    np.testing.assert_allclose([o[0] for o in remat], [o[0] for o in serial], atol=1e-3, rtol=0)
    for n in state:
        want = s_scope.to_numpy(n)
        err = float(np.abs(r_scope.to_numpy(n).astype(np.float32) - want).max())
        assert err <= 1e-5 * max(float(np.abs(want).max()), 1.0), (n, err)
    w = main.all_parameters()[0].name
    r_scope.set_var(w, torch.zeros_like(r_scope.find_var(w)))
    r_exe.run(compiled, feed=feeds[0], fetch_list=[loss], scope=r_scope)
    assert r_exe.last_plan.graphed and r_exe.last_plan.runs == 7
    moved = r_scope.to_numpy(w)
    assert float(np.abs(moved).max()) <= 1e-2  # one Adam step from zero, lr 1e-3


@pytest.mark.gpu
def test_dataloader_batch_equals_its_source_on_card():
    """Six 16 MB batches through DataLoader(capacity=1) onto the card, the
    loader's upload stream held back by a sleep kernel so that every copy
    is still queued when its batch is yielded: a kernel reading each batch
    right after the hand-off, while the producer refills the three pinned
    buffers of each feed with later batches, sees exactly its numpy source
    (float64 -> float32 and int64 -> int32 on the host first).  Three feeds
    share one shape and dtype, as BERT's token, position and label ids do:
    none of them is handed another's data."""
    _need_card()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [1024, 1024], dtype="float32")
        ids = [fluid.layers.data(n, [8], dtype="int64") for n in ("ids", "pos", "lbl")]
    rng = np.random.RandomState(5)
    batches = [{"x": rng.rand(4, 1024, 1024),
                **{n: rng.randint(0, 1 << 40, (4, 8)) for n in ("ids", "pos", "lbl")}}
               for _ in range(6)]
    loader = fluid.DataLoader.from_generator([x] + ids, capacity=1, device=fluid.CUDAPlace(0))
    loader.set_batch_generator(lambda: iter(batches))
    with torch.cuda.stream(loader._stream):
        torch.cuda._sleep(500_000_000)  # ~0.3 s: the uploads queue behind it
    seen = []
    for b in loader:
        assert b["x"].is_cuda and b["x"].dtype == torch.float32 and b["ids"].dtype == torch.int32
        seen.append({k: v * 1 for k, v in b.items()})  # a kernel on the consumer's stream
    torch.cuda.synchronize()
    assert len(loader._pool.bufs) == 4  # a pool of its own for each feed
    assert all(len(slots) == 3 for slots in loader._pool.bufs.values())  # buffers were reused
    for got, want in zip(seen, batches):
        np.testing.assert_array_equal(got["x"].cpu().numpy(), want["x"].astype(np.float32))
        for n in ("ids", "pos", "lbl"):
            np.testing.assert_array_equal(got[n].cpu().numpy(), want[n].astype(np.int32))


@pytest.mark.gpu
def test_snapshot_restore_between_replays_equals_eager_restore_on_card(exact_card_math):
    """The tiny BERT (dropout 0.1): 4 steps, a snapshot at the dispatch
    boundary of step 2, a restore after step 3, steps 2 and 3 again.  On a
    graphed executor the redone steps are replays of the graph captured at
    step 1 (the restore copies into the tensors it reads and sets the
    generator's state in place); on an eager one they run op by op.  Losses,
    every persistable and the generator are bit for bit the same in both,
    and the redone steps repeat the first pass."""
    from paddle_tpu_torch.resilience import _restore_scope, _snapshot_scope

    _need_card()
    main, startup, loss = _tiny_bert_train(0.1)
    state = _state_of(main, startup)
    feeds = _feeds_of("bert", 4)
    arms = {}
    for graphs in (True, False):
        scope = fluid.Scope()
        fluid.io.load_numpy_params(scope, state, device="cuda:0")
        exe = fluid.Executor(fluid.CUDAPlace(0), _graphs=graphs)
        exe._generator(scope, main).manual_seed(7)
        losses, snap = [], None
        for i, f in enumerate(feeds + feeds[2:]):
            if i == 2:
                snap = _snapshot_scope(scope)
            if i == 4:
                _restore_scope(scope, snap)
            losses.append(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0])
        assert exe.last_plan.graphed == graphs and (not graphs or exe.last_plan.runs == 6)
        arms[graphs] = (losses, {n: scope.to_numpy(n) for n in state},
                        scope.find_var("__rng_state__").get_state())
    for graphs, (losses, _, _) in arms.items():
        np.testing.assert_array_equal(np.stack(losses[4:]), np.stack(losses[2:4]))
    np.testing.assert_array_equal(np.stack(arms[True][0]), np.stack(arms[False][0]))
    for n in state:
        np.testing.assert_array_equal(arms[True][1][n], arms[False][1][n], err_msg=n)
    assert torch.equal(arms[True][2], arms[False][2])


def _chip_smoke():
    """chip_smoke.py at the repository's root, for build_seq2seq."""
    import importlib
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.gpu
def test_tiny_seq2seq_trains_on_card_like_cpu(exact_card_math):
    """The seq2seq with attention (a DynamicRNN decoder) at width 16, 3 Adam
    steps on 4 ragged pairs: the card's plan is captured (no host read in the
    per-step body) and launches Adam once a parameter a step; losses 1e-4,
    parameters 1e-5 (2*lr*steps + 1e-5 where the CPU gradient is 0 to
    rounding)."""
    _need_card()
    cs = _chip_smoke()
    main, startup, fetches = cs.build_seq2seq(fluid, src_vocab=50, tgt_vocab=60, emb_dim=16,
                                              enc_dim=16, dec_dim=16)
    loss = fetches["loss"].name
    state = cs.cpu_state(fluid, main, startup)
    feed = cs.seq2seq_feed(fluid.LoDTensor, 4, 3, 9, 50, 60, 0)
    params = [p.name for p in main.all_parameters()]
    runs = []
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.Scope()
        fluid.io.load_numpy_params(scope, state, device=place.device)
        exe = fluid.Executor(place)
        before = dict(ck.LAUNCHES)
        outs = [exe.run(main, feed=feed, fetch_list=[loss] + [f"{p}@GRAD" for p in params],
                        scope=scope) for _ in range(3)]
        runs.append(([float(o[0].reshape(-1)[0]) for o in outs], scope, [o[1:] for o in outs],
                     {k: ck.LAUNCHES[k] - before[k] for k in before}, exe.last_plan))
    (gl, gs, _, gd, plan), (cl, cs_scope, cpu_grads, cd, _) = runs
    assert cd == NO_LAUNCHES
    _hold_graphed_launches(gd, plan, dict(NO_LAUNCHES, adam=len(params)))
    np.testing.assert_allclose(gl, cl, atol=1e-4)
    peaks = [max(float(np.abs(g).max()) for g in step) for step in cpu_grads]
    for i, p in enumerate(params):
        err = np.abs(gs.to_numpy(p) - cs_scope.to_numpy(p))
        near_zero = np.zeros(err.shape, bool)
        for step, peak in zip(cpu_grads, peaks):
            near_zero |= np.abs(step[i]) <= 1e-6 * peak
        assert err.max() <= 2 * 1e-3 * 3 + 1e-5, p
        assert not (err[~near_zero] > 1e-5).any(), p


@pytest.mark.gpu
def test_cond_and_array_plans_are_refused_on_card():
    """A cond (conditional_block) plan and a tensor-array plan carry their
    refusal, run eagerly and give the CPU's values; a schedule's plan (mask
    arithmetic over the step counter) replays its graph."""
    _need_card()
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data("x", [3], dtype="float32")
        flag = layers.data("flag", [1], dtype="bool", append_batch_size=False)
        out = layers.cond(flag, lambda: layers.scale(x, 2.0), lambda: layers.exp(x))
        arr = layers.array_write(x, layers.fill_constant([1], "int64", 1))
        back = layers.array_read(arr, layers.fill_constant([1], "int64", 1))
        lr = layers.piecewise_decay([2, 4], [1.0, 0.5, 0.1])
    xv = np.random.RandomState(0).randn(2, 3).astype("float32")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)  # the schedule's step counter, which every plan advances
    for fetch, reason in ((out, "predicate"), (back, "index")):
        for flag_v in (True, False, True):
            (got,) = exe.run(main, feed={"x": xv, "flag": np.array([flag_v])},
                             fetch_list=[fetch], scope=scope)
            want = (xv * 2.0 if flag_v else np.exp(xv)) if fetch is out else xv
            np.testing.assert_allclose(got, want, rtol=1e-6)
        assert reason in exe.last_plan.graph_refusal and not exe.last_plan.graphed
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    got = [float(exe.run(main, fetch_list=[lr], scope=scope)[0][0]) for _ in range(6)]
    np.testing.assert_array_equal(np.float32(got), np.float32([1.0, 1.0, 0.5, 0.5, 0.1, 0.1]))
    assert exe.last_plan.graphed


# --- the detection slice: bf16 attention scores and the detection models ---

# EDGE_CASES and the tile edges of the bf16-score backward kernels
# (csrc/attention_bwd_bs.cu: 64 rows a CTA and a streamed tile, dK/dV 32
# queries a step at dh 128): one past them at dh 64 and 128, causal with
# Lq <= Lk at dh 128 whose dK/dV CTAs skip their first query tiles, causal
# with Lq > Lk at dh 128 with a bias, one ragged tile each way at dh 16
BF16_EDGE_CASES = EDGE_CASES + [
    (2, 3, 65, 65, 64, None, False),
    (2, 2, 129, 129, 128, None, False),
    (1, 2, 320, 384, 128, None, True),
    (2, 2, 100, 70, 128, "per_head", True),
    (2, 3, 40, 24, 16, None, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", BF16_EDGE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_bf16_score_attention_kernels_at_their_edges_on_card(case, dtype):
    """The bf16-score variants (score_bf16=True) against the plain versions
    with bf16 scores: forward, dQ and dK/dV, float32 within the f32 bounds
    and bfloat16 by FWD_BF16_RULE / BWD_BF16_RULE, each plus
    SCORE_ROUNDING_RULE (and TIE_RULE: the dQ kernel's shares of the row
    maxima's cotangents in its range, dq and dk with their term); one launch a call,
    counted under the
    `_bf16_scores` keys; the backward repeatable bit for bit."""
    _need_card()
    B, H, Lq, Lk, dh, bias_kind, causal = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(15)
    q, k, v, do = (torch.randn(B, H, n, dh, generator=g, device="cuda").to(dt)
                   for n in (Lq, Lk, Lk, Lq))
    bias = None
    if bias_kind == "per_head":
        bias = torch.randn(B, H, Lq, Lk, generator=g, device="cuda") * 2.0
    args = (q, k, v, bias, causal, dh ** -0.5)
    before = dict(ck.LAUNCHES)
    out, stats = ca.attention_fwd(*args, score_bf16=True)
    dq, di = ca.attention_bwd_dq(*args, out, stats, do, score_bf16=True)
    dk, dv = ca.attention_bwd_dkv(*args, stats, di, do, score_bf16=True)
    assert {n: ck.LAUNCHES[n] - before[n] for n in before} == dict(
        NO_LAUNCHES, attention_fwd_bf16_scores=1, attention_bwd_dq_bf16_scores=1,
        attention_bwd_dkv_bf16_scores=1)
    assert stats.shape == (2, B, H, Lq)
    assert torch.equal(dq, ca.attention_bwd_dq(*args, out, stats, do, score_bf16=True)[0])
    want = ca.sdpa_plain(*args, score_bf16=True)
    extra = ca.score_rounding_allowed(*args)
    base = (1e-4 if dtype == "float32"
            else ca.sdpa_fwd_bf16_allowed(*args, want, score_bf16=True))
    assert ((out.float() - want.float()).abs() <= base + extra).all()
    want = ca.sdpa_bwd_plain(*args, out, do, score_bf16=True)
    lo, hi, held = ca.tie_share_range(*args, out, do)  # the row max's cotangent
    assert ((di[1] >= lo) & (di[1] <= hi))[held].all()
    extra = list(ca.score_rounding_allowed(*args, out, do))
    for i, t in enumerate(ca.tie_allowed(*args, out, do, t=di[1])):
        extra[i] = extra[i] + t
    if dtype == "float32":
        base = [_grad_tol(dtype, w) for w in want]
    else:
        base = ca.sdpa_bwd_bf16_allowed(*args, out, do, want, score_bf16=True)
    for name, got, w, a, e in zip(("dq", "dk", "dv"), (dq, dk, dv), want, base, extra):
        assert got.dtype == dt and got.shape == w.shape
        assert ((got.float() - w.float()).abs() <= a + e).all(), name


@pytest.mark.gpu
def test_tiny_ssd_and_yolov3_train_graphed_on_card(exact_card_math):
    """models/detection.py's MobileNet-SSD and YOLOv3 at 64 x 64 (YOLOv3 one
    block a stage): three graphed Momentum / RMSProp steps launch the BN
    epilogue once per batch norm at the eager and capture runs, the plan
    captures (no refusal), the loss is finite, and the served detections
    are [N, keep_top_k, 6]."""
    _need_card()
    from paddle_tpu_torch.models import detection

    for build, make, kw in (
            (detection.build_mobilenet_ssd, detection.make_ssd_batch,
             dict(num_classes=5, image_size=64, max_boxes=6)),
            (detection.build_yolov3, detection.make_yolo_batch,
             dict(num_classes=4, image_size=64, max_boxes=6, stages=[1, 1, 1, 1, 1],
                  nms_top_k=50, keep_top_k=10))):
        with fluid.unique_name.guard():
            main, startup, _, fetches = build(**kw)
        n_bn = sum(op.type == "batch_norm" for op in main.global_block().ops)
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        feed = make(2, rng=np.random.RandomState(0), **{k: kw[k] for k in (
            "image_size", "num_classes", "max_boxes")}, most_boxes=4)
        for step in range(3):
            before = dict(ck.LAUNCHES)
            loss, det = exe.run(main, feed=feed, fetch_list=[fetches["loss"], fetches["detections"]],
                                scope=scope)
            delta = {n: ck.LAUNCHES[n] - before[n] for n in before}
            want = dict(NO_LAUNCHES, bn_epilogue_fwd=n_bn, bn_epilogue_bwd=n_bn) if step < 2 \
                else NO_LAUNCHES
            assert delta == want, (step, delta)
            assert np.isfinite(loss).all() and det.shape[0] == 2 and det.shape[2] == 6
        assert exe.last_plan.graphed and exe.last_plan.graph_refusal is None


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_adam_kernel_applies_found_inf_on_card(dtype):
    """The in-place Adam kernel with AMP's overflow flag (one bool on the
    device): set, p, m and v keep their bits and the launch still counts;
    clear, the step of adam_plain (2^-20 of each output's terms, one
    rounding of p's dtype); an odd size and a view off the 16-byte grid
    (the scalar path); and captured in a CUDA graph, whose replays read the
    flag on the device: a replay with it set moves nothing, one with it
    clear takes the step."""
    _need_card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(21)
    base = (torch.randn(1002, generator=g, device="cuda") * 0.02).to(dt)
    lr_t = torch.full((1,), 1e-3, device="cuda")
    for p0 in (base[:1001], base[1:]):
        gr = (torch.randn(1001, generator=g, device="cuda") * 0.01).to(dt)
        m0 = torch.randn(1001, generator=g, device="cuda") * 0.01
        v0 = (0.5 + torch.rand(1001, generator=g, device="cuda")) * 1e-4
        for flag in (True, False):
            p, m, v = p0.clone(), m0.clone(), v0.clone()
            found = torch.tensor([flag], device="cuda")
            before = dict(ck.LAUNCHES)
            got = ck.fused_adam(p, gr, m, v, lr_t, 0.9, 0.999, 1e-8, found)
            assert {k: ck.LAUNCHES[k] - before[k] for k in before} == dict(NO_LAUNCHES, adam=1)
            assert got[0] is p
            want = ((p0, m0, v0) if flag
                    else ck.adam_plain(p0, gr, m0, v0, lr_t, 0.9, 0.999, 1e-8))
            if flag:
                for a, b in zip((p, m, v), (p0, m0, v0)):
                    assert torch.equal(a, b)
            # 2^-20 of the magnitudes of each output's terms, plus one
            # rounding of its stored dtype (test_training_kernels' rule)
            gf = gr.float()
            terms_m = 0.9 * m0.abs() + 0.1 * gf.abs()
            terms = (p0.float().abs() + lr_t * terms_m / (want[2].float().sqrt() + 1e-8),
                     terms_m, 0.999 * v0 + 0.001 * gf * gf)
            for a, w, t in zip(got, want, terms):
                assert ((a.float() - w.float()).abs()
                        <= 2.0 ** -20 * t + ck.stored_step(w.dtype, w) + 1e-30).all()
    p, m, v = p0.clone(), m0.clone(), v0.clone()
    found = torch.tensor([True], device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        ck.fused_adam(p, gr, m, v, lr_t, 0.9, 0.999, 1e-8, found)  # warm, skipped
        with torch.cuda.graph(graph, stream=stream):
            ck.fused_adam(p, gr, m, v, lr_t, 0.9, 0.999, 1e-8, found)
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(p, p0) and torch.equal(m, m0) and torch.equal(v, v0)
    found.fill_(False)
    graph.replay()
    torch.cuda.synchronize()
    assert not torch.equal(p, p0) and not torch.equal(m, m0)


@pytest.mark.gpu
def test_float16_overflow_is_inf_where_the_plain_version_has_it_on_card():
    """float16 outputs past 65504 from finite inputs: the LayerNorm forward
    (a float32 scale of 3e4), bias+GELU (a float32 bias of 6.5e4), the BN
    epilogue (multipliers of 4e4) and the cross-entropy backward (an upstream
    of 2^32 / 8, AMP's overflow): +-inf at the plain version's elements with
    its signs, the finite elements within one rounding (FWD_ROUNDING_RULE;
    the backward's, one float16 step); never clamped to 65504."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(22)
    h = torch.float16

    def rn(*shape, s=1.0, d=h):
        return (torch.randn(*shape, generator=g, device="cuda") * s).to(d)

    def hold(got, want, allowed):
        # +-inf where the plain version has it, save a few elements where
        # the other side is +-65504 (the float32 value within its noise of
        # the threshold 65520: one step apart; chip_smoke's hold_overflow)
        inf_g, inf_w = torch.isinf(got), torch.isinf(want)
        assert got.dtype == h and bool(inf_w.any())
        both, apart = inf_g & inf_w, inf_g ^ inf_w
        assert torch.equal(got[both], want[both])
        edge = torch.where(inf_g, want, got)[apart].float()
        assert int(apart.sum()) <= 2 and bool((edge.abs() == 65504.0).all())
        fin = torch.isfinite(want) & torch.isfinite(got)
        assert ((got.float() - want.float()).abs()[fin] <= allowed[fin]).all()

    x, r = rn(301, 768), rn(301, 768)
    s, b = rn(768, s=3e4, d=torch.float32).abs() + 3e4, rn(768, d=torch.float32)
    want = ck.ln_residual_plain(x, r, s, b)
    hold(ck.fused_ln_residual(x, r, s, b, 1e-5), want, ck.ln_residual_fwd_allowed(x, r, s, b, want))
    x, b = rn(301, 1000, s=1e3), rn(1000, d=torch.float32) + 6.5e4
    want = ck.bias_act_plain(x, b)
    hold(ck.fused_bias_act(x, b, "gelu"), want, ck.bias_act_fwd_allowed(x, b, want))
    x = rn(64, 49)
    mul, add = torch.full((64,), 4e4, device="cuda"), torch.zeros(64, device="cuda")
    want = ck.bn_epilogue_plain(x, mul, add, False)
    hold(ck._epilogue_fwd(x, mul, add, False), want, ck.bn_epilogue_fwd_allowed(x, mul, add, want))
    logits = rn(8, 1001, s=2.0)
    labels = torch.randint(0, 1001, (8,), generator=g, device="cuda").to(torch.int32)
    _, lse = ck.softmax_xent_fwd_plain(logits, labels)
    up = torch.full((8,), 2.0 ** 32 / 8, device="cuda")
    want = ck.softmax_xent_bwd_plain(logits, labels, lse, up)
    hold(ck.softmax_xent_bwd(logits, labels, lse, up), want, ck.stored_step(h, want) + 1e-12)


def _tiny_encoder_dir(tmp_path):
    """The tiny zoo BERT through the two fusion passes, saved for inference
    with its encoder's hidden states [batch, 16, 32] as the output, weights
    from seed 0."""
    with fluid.unique_name.guard():
        main, startup, _, _ = transformer.build_bert(dtype="bfloat16", **TINY)
    logits = next(op for op in main.global_block().ops
                  if op.type == "softmax_with_cross_entropy").input("Logits")[0]
    for p in ("fuse_ln_residual", "fuse_bias_act"):
        fluid.passes.apply_pass(main, p, keep=[logits])
    head = next(op for op in main.global_block().ops if "bert.lm_head.w" in op.input_arg_names)
    hidden = next(n for n in head.input_arg_names if n != "bert.lm_head.w")
    startup.random_seed = 0
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    d = str(tmp_path / "encoder")
    fluid.io.save_inference_model(d, ["ids", "pos_ids"], [hidden], exe, main, scope)
    return d


def _tiny_request(rows, seed):
    full = transformer.make_fake_batch(rows, TINY["seq_len"], TINY["vocab_size"],
                                       rng=np.random.RandomState(seed))
    return {"ids": full["ids"], "pos_ids": full["pos_ids"]}


def _plans(registry, version):
    return [p for k, p in registry.executor._cache.items() if k[4] == version.scope._uuid]


@pytest.mark.gpu
def test_a_warmed_bucket_is_graphed_on_card(tmp_path):
    """Server.load_model leaves each bucket's plan holding a CUDA graph, and
    traffic of novel sizes captures nothing and builds no plan."""
    _need_card()
    d = _tiny_encoder_dir(tmp_path)
    fluid.monitor.reset()
    fluid.monitor.enable()
    try:
        registry = fluid.serving.ModelRegistry()
        with fluid.serving.Server(registry, buckets=(1, 4, 8), workers=2) as srv:
            version = srv.load_model("m", d)
            plans = _plans(registry, version)
            assert len(plans) == 3 and all(p.graphed for p in plans)
            capture0 = fluid.monitor.counter("executor.graph_capture").value
            miss0 = fluid.monitor.counter("executor.cache_miss").value
            before = dict(ck.LAUNCHES)
            eager = fluid.inference.AnalysisConfig(d)
            eager._graphs = False
            direct = fluid.inference.create_predictor(eager)
            for i, rows in enumerate((3, 1, 7, 2, 8, 5)):
                feed = _tiny_request(rows, i)
                (out,) = srv.infer("m", feed)
                want = direct.run(feed)[0]
                assert out.shape == (rows, TINY["seq_len"], TINY["d_model"])
                assert np.abs(out.astype(np.float32) - want.astype(np.float32)).max() <= 5e-2
            assert fluid.monitor.counter("executor.graph_capture").value == capture0
            assert fluid.monitor.counter("executor.cache_miss").value == miss0 + 6  # direct's
            served = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
            assert served == {k: 6 * v for k, v in dict(
                NO_LAUNCHES, ln_residual_fwd=5, bias_act_fwd=2, attention_fwd=2).items()}
    finally:
        fluid.monitor.disable()


@pytest.mark.gpu
def test_an_evicted_models_bytes_are_freed_on_card(tmp_path):
    """Evicting a graphed model gives its weights and its graphs' pools back
    to the allocator: memory_allocated comes back to what the survivor
    holds alone."""
    _need_card()
    import gc

    d = _tiny_encoder_dir(tmp_path)
    d2 = str(tmp_path / "encoder2")
    import shutil

    shutil.copytree(d, d2)
    need = fluid.serving.plan_model_bytes(d, 8)
    registry = fluid.serving.ModelRegistry(hbm_budget_mb=need * 1.2 / 1e6)

    def allocated():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    registry.load("b", d2, warm_buckets=(1, 8))  # makes the side stream's workspaces
    registry.unload("b")
    base = allocated()
    registry.load("b", d2, warm_buckets=(1, 8))
    alone = allocated()
    own = alone - base  # the model's weights, graph pools and static buffers
    assert own > 0
    registry.unload("b")
    assert abs(allocated() - base) <= 0.01 * own
    registry.load("a", d, warm_buckets=(1, 8))
    assert abs(allocated() - base - own) <= 0.01 * own  # the same model, the same bytes
    registry.load("b", d2, warm_buckets=(1, 8))  # evicts "a"
    assert sorted(registry.models()) == ["b"]
    assert abs(allocated() - alone) <= 0.01 * own


# --- contrib.slim: the fake-quantize ops and int8 model dirs ----------------------

FAKE_QUANT = {
    "fake_quantize_abs_max": ({}, {"bit_length": 8}),
    "fake_channel_wise_quantize_abs_max": ({}, {"bit_length": 8, "quant_axis": 1}),
    "fake_quantize_moving_average_abs_max": ({"InScale": np.array([1.5], np.float32)},
                                             {"bit_length": 8, "moving_rate": 0.9}),
    "fake_dequantize_max_abs": ({"Scale": np.array([0.3], np.float32)}, {"max_range": 127.0}),
}


def _fake_quant_run(op_type, dtype, place):
    """One fake-quantize op on a seeded [48, 40] X; returns its outputs and
    X's gradient through sum(Out * w)."""
    import ml_dtypes

    extra, attrs = FAKE_QUANT[op_type]
    r = np.random.RandomState(22)
    x = r.randn(48, 40).astype(np.float32) * 3
    if op_type == "fake_dequantize_max_abs":
        x = np.round(x * 20)
    x = x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x
    w = r.randn(48, 40).astype(np.float32)
    outs = ["Out"] if op_type == "fake_dequantize_max_abs" else ["Out", "OutScale"]
    main = fluid.Program()
    feed = {"x": x, "w": w, **{k.lower(): v for k, v in extra.items()}}
    with fluid.program_guard(main, fluid.Program()):
        block = main.global_block()
        xv = block.create_var("x", shape=x.shape, dtype=dtype, is_data=True)
        xv.stop_gradient = False
        ins = {"X": ["x"]}
        for slot, v in extra.items():
            block.create_var(slot.lower(), shape=v.shape, dtype="float32", is_data=True)
            ins[slot] = [slot.lower()]
        for o in outs:
            block.create_var(f"out_{o}")
        block.append_op(op_type, inputs=ins, outputs={o: [f"out_{o}"] for o in outs},
                        attrs=attrs)
        wv = block.create_var("w", shape=w.shape, dtype="float32", is_data=True)
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(block.var("out_Out"), wv))
        grads = fluid.append_backward(loss, parameter_list=["x"])
    exe = fluid.Executor(place)
    return exe.run(main, feed=feed, fetch_list=[f"out_{o}" for o in outs] + [grads[0][1].name],
                   scope=fluid.Scope())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op_type", list(FAKE_QUANT))
def test_fake_quantize_ops_on_card_match_the_cpu_run(op_type, dtype):
    """Each fake-quantize op and its straight-through gradient on the card
    equal its CPU run bit for bit (IEEE division and round-half-even on
    both; a bf16 op rounds once on both), and launch no kernel."""
    _need_card()
    before = dict(ck.LAUNCHES)
    card = _fake_quant_run(op_type, dtype, fluid.CUDAPlace(0))
    cpu = _fake_quant_run(op_type, dtype, fluid.CPUPlace())
    assert ck.LAUNCHES == before
    for i, (a, b) in enumerate(zip(card, cpu)):
        assert a.dtype == b.dtype and a.shape == b.shape, (i, a.dtype, b.dtype)
        assert a.tobytes() == b.tobytes(), (op_type, dtype, i)


@pytest.mark.gpu
@pytest.mark.parametrize("serve_dtype", [None, "bfloat16"])
def test_an_int8_dir_loads_on_the_card_bitwise_as_on_the_cpu(tmp_path, serve_dtype,
                                                            exact_card_math):
    """An int8 dir (channel-wise QAT conv net, saved on the CPU) loads onto
    the card with each weight bitwise its CPU load, and its predictor's
    fetches on the card are within float32 rounding of the CPU's."""
    _need_card()
    from paddle_tpu_torch.contrib import slim

    layers = fluid.layers
    with fluid.unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = layers.data("x", [3, 8, 8], dtype="float32")
            c = layers.conv2d(x, num_filters=8, filter_size=3, padding=1, act="relu")
            out = layers.fc(layers.reshape(c, [-1, 8 * 8 * 8]), 10, act="softmax")
    startup.random_seed = 3
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    slim.quant_aware(main, weight_quantize_type="channel_wise_abs_max",
                     quantize_activations=False)
    d = str(tmp_path / "q")
    fluid.io.save_quantized_inference_model(d, ["x"], [out], exe, main, scope,
                                            serve_dtype=serve_dtype)
    loaded = {}
    for where, device in (("card", "cuda:0"), ("cpu", "cpu")):
        s = fluid.Scope()
        names = fluid.io.load_vars(d, None, s, device=device)
        loaded[where] = {n: s.find_var(n) for n in names}
    for n, t in loaded["card"].items():
        c = loaded["cpu"][n]
        assert t.is_cuda and t.dtype == c.dtype and t.shape == c.shape, n
        assert torch.equal(t.cpu().view(torch.uint8) if t.dtype == torch.bfloat16 else t.cpu(),
                           c.view(torch.uint8) if c.dtype == torch.bfloat16 else c), n
    xv = np.random.RandomState(0).rand(4, 3, 8, 8).astype(np.float32)
    got = {w: fluid.inference.create_predictor(fluid.inference.AnalysisConfig(d, place=p)).run(
        {"x": xv})[0] for w, p in (("card", fluid.CUDAPlace(0)), ("cpu", fluid.CPUPlace()))}
    np.testing.assert_allclose(np.asarray(got["card"], np.float32),
                               np.asarray(got["cpu"], np.float32), rtol=0, atol=1e-4)


def _dygraph_conv_bn_linear(place, optimizer, state=None):
    """A Conv2D + BatchNorm + Linear model in dygraph, 3 steps under
    guard(place) on one batch: the initial state, the losses, the state
    after each step and the parameters' devices."""
    dy = fluid.dygraph
    rng = np.random.RandomState(0)
    xv = rng.rand(8, 3, 16, 16).astype("f4")
    yv = rng.randint(0, 5, (8, 1))
    with dy.guard(place):
        class Net(dy.Layer):
            def __init__(self):
                super().__init__("net")
                self.conv = dy.Conv2D(3, 8, 3, padding=1)
                self.bn = dy.BatchNorm(8, act="relu")
                self.pool = dy.Pool2D(pool_type="avg", global_pooling=True)
                self.fc = dy.Linear(8, 5)

            def forward(self, x):
                y = fluid.layers.reshape(self.pool(self.bn(self.conv(x))), [-1, 8])
                return self.fc(y)

        net = Net()
        if state is not None:
            net.set_dict(state)
        initial = net.state_dict()
        opt = {"momentum": lambda: fluid.optimizer.Momentum(0.1, 0.9),
               "adam": lambda: fluid.optimizer.Adam(0.01)}[optimizer]()
        losses, states = [], []
        for _ in range(3):
            loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
                net(dy.to_variable(xv)), dy.to_variable(yv)))
            loss.backward()
            opt.minimize(loss, parameter_list=net.parameters())
            net.clear_gradients()
            losses.append(float(loss.numpy().reshape(-1)[0]))
            states.append(net.state_dict())
        return initial, losses, states, {p.value.device.type for p in net.parameters()}


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["momentum", "adam"])
def test_dygraph_conv_bn_linear_on_card_matches_the_cpu_run(optimizer, exact_card_math):
    """dygraph.guard() without a place trains on cuda:0, launches none of the
    port's kernels, and matches the CPU run from the same weights: losses
    within 1e-4 relative, every parameter and running statistic within 1e-5
    of max(1, |CPU|); under Adam the conv bias, which the batch norm removes
    (gradient 0 in exact arithmetic), within 2 * lr * steps + 1e-5."""
    _need_card()
    cpu = _dygraph_conv_bn_linear(fluid.CPUPlace(), optimizer)
    before = dict(ck.LAUNCHES)
    card = _dygraph_conv_bn_linear(None, optimizer, state=cpu[0])
    assert dict(ck.LAUNCHES) == before
    assert card[3] == {"cuda"} and cpu[3] == {"cpu"}
    np.testing.assert_allclose(card[1], cpu[1], rtol=1e-4)
    for got, want in zip(card[2], cpu[2]):
        for n in want:
            tol = 1e-5 * max(1.0, float(np.abs(want[n]).max()))
            if optimizer == "adam" and n == "conv.bias":
                tol = 2 * 0.01 * 3 + 1e-5
            np.testing.assert_allclose(got[n], want[n], rtol=0, atol=tol, err_msg=n)


HOST_DEEPFM = dict(num_fields=5, vocab_size=400, embed_dim=4, mlp_dims=(8, 8))


def _host_table_deepfm(place):
    """A tiny host-tier DeepFM: both tables TieredEmbeddings (hot quarter in
    process) over an in-process ParameterServer, deepfm_net's arithmetic
    over the pulled blocks, Adam(1e-3, epsilon 1e-3) on the MLP, 3 steps of
    batch 32, pull after push.  Returns the losses, every table row and
    parameter, and the plan."""
    from paddle_tpu_torch.param_server import KVClient, ParameterServer
    from paddle_tpu_torch.parallel import TieredEmbedding

    layers, cfg = fluid.layers, HOST_DEEPFM
    nf, k = cfg["num_fields"], cfg["embed_dim"]
    with fluid.unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            w_emb = layers.data("w_emb", [nf, 1], dtype="float32")
            v_emb = layers.data("v_emb", [nf, k], dtype="float32")
            label = layers.data("label", [1], dtype="float32")
            fm = layers.reduce_sum(layers.square(layers.reduce_sum(v_emb, dim=[1]))
                                   - layers.reduce_sum(layers.square(v_emb), dim=[1]),
                                   dim=[1]) * 0.5
            deep = layers.reshape(v_emb, [-1, nf * k])
            for d in cfg["mlp_dims"]:
                deep = layers.fc(deep, size=d, act="relu")
            logit = layers.reshape(layers.reduce_sum(w_emb, dim=[1, 2]) + fm, [-1, 1]) \
                + layers.fc(deep, size=1)
            loss = layers.mean(layers.sigmoid_cross_entropy_with_logits(logit, label))
            grads = fluid.calc_gradient(loss, [w_emb, v_emb])
            fluid.optimizer.Adam(1e-3, epsilon=1e-3).minimize(loss)
    startup.random_seed = 0
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    srv = ParameterServer(optimizer="sgd", lr=0.05).start()
    client = KVClient(srv.endpoint)
    try:
        tables = {n: TieredEmbedding(client, n, cfg["vocab_size"], d, cfg["vocab_size"] // 4,
                                     lr=0.05, degraded_ok=False, seed=s)
                  for s, (n, d) in enumerate((("deepfm_w", 1), ("deepfm_v", k)), 1)}
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        for v in main.list_vars():
            if v.persistable:
                scope.set_var(v.name, init.to_numpy(v.name).copy())
        rng = np.random.RandomState(3)
        losses = []
        for _ in range(3):
            ids = rng.randint(0, cfg["vocab_size"], (32, nf))
            feed = {"w_emb": tables["deepfm_w"].lookup(ids),
                    "v_emb": tables["deepfm_v"].lookup(ids),
                    "label": (rng.rand(32, 1) < 0.3).astype("f4")}
            out = exe.run(main, feed=feed, fetch_list=[loss] + list(grads), scope=scope)
            losses.append(float(out[0].reshape(-1)[0]))
            for (n, t), g in zip(tables.items(), out[1:]):
                t.apply_grad(ids.reshape(-1), g.reshape(-1, t.dim))
        state = {n: t.export_selected_rows().values.numpy() for n, t in tables.items()}
        state.update({p.name: scope.to_numpy(p.name).copy() for p in main.all_parameters()})
        return losses, state, exe.last_plan
    finally:
        client.close()
        srv.stop()


@pytest.mark.gpu
def test_host_table_deepfm_on_card_matches_the_cpu_run(exact_card_math):
    """The host tier around a device step on the card: losses within 1e-5
    relative of the CPU run's, every table row and MLP parameter within 1e-5
    of max(1, |CPU|), and the Adam kernel launched for the 6 MLP parameters
    at each eager run and at the capture."""
    _need_card()
    cpu_losses, cpu_state, _ = _host_table_deepfm(fluid.CPUPlace())
    before = dict(ck.LAUNCHES)
    losses, state, plan = _host_table_deepfm(fluid.CUDAPlace(0))
    runs = 2 if plan.graphed else 3
    assert {k: ck.LAUNCHES[k] - before[k] for k in before} == dict(NO_LAUNCHES, adam=6 * runs)
    np.testing.assert_allclose(losses, cpu_losses, rtol=1e-5)
    for n, want in cpu_state.items():
        np.testing.assert_allclose(state[n], want, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(want).max())), err_msg=n)


@pytest.mark.gpu
def test_a_chaos_schedule_on_card_gives_the_cpu_verdict(tmp_path):
    """chaos.run_one with no place runs on the card: the seed-8 planted
    pairing's probes, fires and (clean) verdict equal the CPU run's."""
    from paddle_tpu_torch import chaos

    _need_card()
    spec = "nan@2;device@7:UNAVAILABLE"
    card = chaos.run_one("train", spec, seed=8, workdir=str(tmp_path / "card"))
    cpu = chaos.run_one("train", spec, seed=8, workdir=str(tmp_path / "cpu"),
                        place=fluid.CPUPlace())
    assert card.ok and (card.fired, card.data) == (cpu.fired, cpu.data)
    assert chaos.evaluate(card) == chaos.evaluate(cpu) == []


@pytest.mark.gpu
def test_a_collection_during_a_capture_frees_no_graph():
    """Executors whose graphed plans are garbage in reference cycles, and
    the collector run at every allocation while a new plan captures: the
    capture goes through and replays.  A collection inside a capture that
    frees another plan's graph would reset it mid-capture, which CUDA does
    not permit; the executor keeps the collector out of its captures."""
    import gc

    _need_card()

    def graphed():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [8], dtype="float32")
            loss = fluid.layers.mean(fluid.layers.fc(x, 4))
            fluid.optimizer.SGD(0.1).minimize(loss)
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        out = [exe.run(main, feed={"x": np.full((4, 8), i, "f4")}, fetch_list=[loss],
                       scope=scope)[0] for i in range(3)]
        return exe, out

    for _ in range(4):
        exe, _ = graphed()
        exe.cycle = exe  # garbage only a collection frees
        del exe
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        exe, out = graphed()
    finally:
        gc.set_threshold(*threshold)
    assert exe.last_plan.graphed and exe.last_plan.runs == 3
    assert all(np.isfinite(o).all() for o in out)


@pytest.mark.gpu
def test_device_hbm_limit_is_the_cards_total():
    _need_card()
    from paddle_tpu_torch.core import resource_plan as rp

    total = torch.cuda.mem_get_info(0)[1]
    assert rp.device_hbm_limit(torch.device("cuda:0")) == total
    old = fluid.get_flags(["FLAGS_resource_hbm_limit_mb"])
    fluid.set_flags({"FLAGS_resource_hbm_limit_mb": 1000.0})
    try:
        assert rp.device_hbm_limit(torch.device("cuda:0")) == 10 ** 9
    finally:
        fluid.set_flags(old)


@pytest.mark.gpu
def test_precheck_raises_before_any_allocation_on_card():
    """A program past the card's memory is refused at its plan-cache miss:
    nothing of the step is allocated (only the uploaded feeds, freed with
    the error's frames), no plan is cached, and the error names the card's
    total as its limit."""
    _need_card()
    from paddle_tpu_torch.errors import ResourceError

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [1 << 15], dtype="float32")
        z = fluid.layers.relu(fluid.layers.fc(x, 1 << 20))  # a 137 GB weight
    exe = fluid.Executor(fluid.CUDAPlace(0))
    feed = {"x": np.ones((64, 1 << 15), "f4")}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        exe.run(main, feed=feed, fetch_list=[z], scope=fluid.Scope())
    except ResourceError as e:
        err = e.with_traceback(None)
    else:
        raise AssertionError("the pre-check let the program run")
    torch.cuda.synchronize()
    assert err.needed_bytes > err.limit_bytes == torch.cuda.mem_get_info(0)[1]
    assert err.phase == "build" and err.watermark_ops
    assert not exe._cache
    assert torch.cuda.memory_allocated() == before
    assert torch.cuda.max_memory_allocated() - before <= 64 * (1 << 15) * 4 + 4096


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", sorted(ck.FUSED_KERNELS))
def test_fused_kernels_registry_matches_plain_on_card(kernel, dtype):
    """Each FUSED_KERNELS entry's kernel against its plain version at the
    registry's example shapes and tolerance (tools/port_opbench.py --fused
    checks the same before it times), launching its kernel."""
    _need_card()
    spec = ck.FUSED_KERNELS[kernel]
    args = spec["example"](getattr(torch, dtype), device="cuda")
    want = spec["reference"](args)
    fresh = [None if a is None else a.clone() for a in args]
    before = dict(ck.LAUNCHES)
    got = spec["fused"](fresh)
    torch.cuda.synchronize()
    assert any(ck.LAUNCHES[k] > before[k] for k in ck.LAUNCHES)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert float((g.float() - w.float()).abs().max()) <= spec["tol"][dtype]

"""Two models trained eagerly, written against a `fluid` module passed in
so that either package builds the same classes: the dygraph ResNet of
Fluid's `test_imperative_resnet.py` (Conv2D + BatchNorm bottlenecks, a 7 x 7
stem, Pool2D, a Linear head) and the PTB language model of Fluid's dygraph
`ptb_lm` (Zaremba et al. 2014: stacked `contrib.rnn_impl.BasicLSTMUnit`s
unrolled over `num_steps`, Dropout on the non-recurrent connections,
uniform init, an Embedding and a Linear head under
`softmax_with_cross_entropy`).  The tests hold the port against the JAX
package with them, chip_smoke.py trains them on the card and holds the card
against the CPU.  `static_*_loss` build the same forward as a static program
from a model's weights, for the dygraph-equals-static check.  This is user
code over the API, not a feature of the port."""
import numpy as np

RESNET50 = dict(class_dim=1000, widths=(64, 128, 256, 512))
PTB_MEDIUM = dict(hidden=650, vocab=10000, num_layers=2, num_steps=35, init_scale=0.05,
                  dropout=0.5)
PTB_BATCH = 20
BLOCKS = (3, 4, 6, 3)  # ResNet-50's bottlenecks a stage


def resnet(fluid, class_dim=1000, widths=(64, 128, 256, 512)):
    """The dygraph ResNet-50: BLOCKS bottlenecks of widths w, w, 4w a stage."""
    dy = fluid.dygraph

    class ConvBN(dy.Layer):
        def __init__(self, cin, cout, k, stride=1, act=None):
            super().__init__("conv_bn")
            self.conv = dy.Conv2D(cin, cout, k, stride=stride, padding=(k - 1) // 2)
            self.bn = dy.BatchNorm(cout, act=act)
            self.spec = (k, stride, (k - 1) // 2, act)

        def forward(self, x):
            return self.bn(self.conv(x))

    class Bottleneck(dy.Layer):
        def __init__(self, cin, width, stride, shortcut):
            super().__init__("bottleneck")
            self.conv0 = ConvBN(cin, width, 1, act="relu")
            self.conv1 = ConvBN(width, width, 3, stride, act="relu")
            self.conv2 = ConvBN(width, width * 4, 1)
            self.short = None if shortcut else ConvBN(cin, width * 4, 1, stride)

        def forward(self, x):
            y = self.conv2(self.conv1(self.conv0(x)))
            short = x if self.short is None else self.short(x)
            return fluid.layers.relu(short + y)

    class ResNet(dy.Layer):
        def __init__(self):
            super().__init__("resnet")
            self.stem = ConvBN(3, widths[0], 7, 2, act="relu")
            self.pool = dy.Pool2D(3, "max", 2, 1)
            self.blocks = []
            cin = widths[0]
            for stage, (n, w) in enumerate(zip(BLOCKS, widths)):
                for i in range(n):
                    blk = self.add_sublayer(f"s{stage}b{i}", Bottleneck(
                        cin, w, 2 if i == 0 and stage > 0 else 1, i > 0))
                    self.blocks.append(blk)
                    cin = w * 4
            self.gap = dy.Pool2D(pool_type="avg", global_pooling=True)
            self.fc = dy.Linear(cin, class_dim)
            self.channels = cin

        def forward(self, x, label):
            y = self.pool(self.stem(x))
            for blk in self.blocks:
                y = blk(y)
            logits = self.fc(fluid.layers.reshape(self.gap(y), [-1, self.channels]))
            return fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(logits, label))

    return ResNet()


def ptb(fluid, hidden, vocab, num_layers, num_steps, init_scale, dropout):
    """The PTB LSTM language model; forward(ids [B, T], labels [B, T]) gives
    the loss, the sum over time of the batch-mean cross entropy."""
    dy = fluid.dygraph
    uniform = fluid.initializer.UniformInitializer(-init_scale, init_scale)

    def attr():
        return fluid.ParamAttr(initializer=uniform)

    class PtbModel(dy.Layer):
        def __init__(self):
            super().__init__("ptb_model")
            self.embedding = dy.Embedding([vocab, hidden], param_attr=attr())
            self.cells = [self.add_sublayer(f"cell{i}", fluid.contrib.BasicLSTMUnit(
                f"lstm{i}", hidden, param_attr=attr(), bias_attr=attr()))
                for i in range(num_layers)]
            self.drop = dy.Dropout(dropout)
            self.out = dy.Linear(hidden, vocab, param_attr=attr(), bias_attr=attr())

        def forward(self, ids, labels):
            batch = ids.shape[0]
            zeros = np.zeros((batch, hidden), "float32")
            h = [dy.to_variable(zeros) for _ in range(num_layers)]
            c = [dy.to_variable(zeros) for _ in range(num_layers)]
            tops = []
            for t in range(num_steps):
                x = self.drop(self.embedding(dy.to_variable(ids[:, t:t + 1])))
                for i, cell in enumerate(self.cells):
                    h[i], c[i] = cell(x, h[i], c[i])
                    x = self.drop(h[i])
                tops.append(fluid.layers.reshape(x, [batch, 1, hidden]))
            y = fluid.layers.reshape(fluid.layers.concat(tops, axis=1), [-1, hidden])
            xent = fluid.layers.softmax_with_cross_entropy(
                self.out(y), dy.to_variable(labels.reshape(-1, 1)))
            per_step = fluid.layers.reduce_mean(
                fluid.layers.reshape(xent, [batch, num_steps]), dim=[0])
            return fluid.layers.reduce_sum(per_step)

    return PtbModel()


def images(batch, size, class_dim, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(batch, 3, size, size).astype("float32"),
            rng.randint(0, class_dim, (batch, 1)).astype("int64"))


def tokens(batch, num_steps, vocab, seed):
    """Seeded token ids and their next-token labels (the PTB corpus is not in
    the repository)."""
    ids = np.random.RandomState(seed).randint(0, vocab, (batch, num_steps + 1))
    return ids[:, :-1].astype("int64"), ids[:, 1:].astype("int64")


def train_step(fluid, model, opt, loss, clip=None):
    """The rest of an eager training step after the forward gave `loss`:
    the backward, the clip's gradients written back, the update; the loss
    as a Python float."""
    loss.backward()
    if clip is not None:
        for p, g in clip([(p, p.grad) for p in model.parameters() if p.grad is not None]):
            p.grad = g
    opt.minimize(loss, parameter_list=model.parameters())
    model.clear_gradients()
    return float(loss.numpy().reshape(-1)[0])


def static_resnet_loss(fluid, model, xv, yv):
    """The forward of `model` (a `resnet(...)`, training-mode batch norm) as
    a static program from its weights; the loss on the CPU."""
    from itertools import count

    state = model.state_dict()
    init = fluid.initializer.NumpyArrayInitializer
    names = iter(state)
    fresh = count()

    def conv_bn(x, cb):
        k, stride, pad, act = cb.spec
        w, b, scale, shift, _, _ = (state[next(names)] for _ in range(6))
        y = fluid.layers.conv2d(x, w.shape[0], k, stride, pad,
                                param_attr=fluid.ParamAttr(f"w{next(fresh)}", initializer=init(w)),
                                bias_attr=fluid.ParamAttr(f"b{next(fresh)}", initializer=init(b)))
        return fluid.layers.batch_norm(
            y, act=act, param_attr=fluid.ParamAttr(f"s{next(fresh)}", initializer=init(scale)),
            bias_attr=fluid.ParamAttr(f"t{next(fresh)}", initializer=init(shift)))

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", list(xv.shape[1:]), dtype="float32")
        label = fluid.layers.data("label", [1], dtype="int64")
        y = fluid.layers.pool2d(conv_bn(x, model.stem), 3, "max", 2, 1)
        for blk in model.blocks:
            z = conv_bn(conv_bn(conv_bn(y, blk.conv0), blk.conv1), blk.conv2)
            short = y if blk.short is None else conv_bn(y, blk.short)
            y = fluid.layers.relu(fluid.layers.elementwise_add(short, z))
        y = fluid.layers.pool2d(y, pool_type="avg", global_pooling=True)
        w, b = state[next(names)], state[next(names)]
        logits = fluid.layers.fc(fluid.layers.reshape(y, [-1, model.channels]), w.shape[1],
                                 param_attr=fluid.ParamAttr("fc_w", initializer=init(w)),
                                 bias_attr=fluid.ParamAttr("fc_b", initializer=init(b)))
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(logits, label))
    return _run_static(fluid, main, startup, {"x": xv, "label": yv}, loss)


def static_ptb_loss(fluid, model, ids, labels, hidden, num_steps, forget_bias=1.0):
    """The forward of `model` (a `ptb(...)` with dropout 0) as a static
    program from its weights; the loss on the CPU."""
    state = model.state_dict()
    init = fluid.initializer.NumpyArrayInitializer
    L = fluid.layers
    batch = ids.shape[0]
    cells = [(state[f"cell{i}.weight"], state[f"cell{i}.bias"]) for i in range(len(model.cells))]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = L.data("ids", [num_steps, 1], dtype="int64")
        lab = L.data("labels", [num_steps, 1], dtype="int64")
        emb = L.embedding(words, list(state["embedding.weight"].shape), param_attr=fluid.ParamAttr(
            "emb", initializer=init(state["embedding.weight"])))
        ws = [(L.create_parameter(list(w.shape), "float32", f"cw{i}",
                                  default_initializer=init(w)),
               L.create_parameter(list(b.shape), "float32", f"cb{i}",
                                  default_initializer=init(b)))
              for i, (w, b) in enumerate(cells)]
        zeros = L.fill_constant([batch, hidden], "float32", 0.0)
        h, c = [zeros] * len(ws), [zeros] * len(ws)
        tops = []
        for t in range(num_steps):
            x = L.reshape(L.slice(emb, [1], [t], [t + 1]), [batch, hidden])
            for i, (w, b) in enumerate(ws):
                gates = L.elementwise_add(L.matmul(L.concat([x, h[i]], axis=1), w), b)
                gi, gj, gf, go = L.split(gates, 4, dim=1)
                c[i] = L.elementwise_add(
                    L.elementwise_mul(c[i], L.sigmoid(L.scale(gf, bias=forget_bias))),
                    L.elementwise_mul(L.sigmoid(gi), L.tanh(gj)))
                h[i] = L.elementwise_mul(L.tanh(c[i]), L.sigmoid(go))
                x = h[i]
            tops.append(L.reshape(x, [batch, 1, hidden]))
        y = L.reshape(L.concat(tops, axis=1), [-1, hidden])
        w, b = state["out.weight"], state["out.bias"]
        logits = L.fc(y, w.shape[1], param_attr=fluid.ParamAttr("out_w", initializer=init(w)),
                      bias_attr=fluid.ParamAttr("out_b", initializer=init(b)))
        xent = L.softmax_with_cross_entropy(logits, L.reshape(lab, [-1, 1]))
        loss = L.reduce_sum(L.reduce_mean(L.reshape(xent, [batch, num_steps]), dim=[0]))
    feed = {"ids": ids.reshape(batch, num_steps, 1), "labels": labels.reshape(batch, num_steps, 1)}
    return _run_static(fluid, main, startup, feed, loss)


def _run_static(fluid, main, startup, feed, loss):
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    (out,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    return float(np.asarray(out).reshape(-1)[0])


def velocities(model, opt):
    """The eager Momentum's velocity of each parameter that has one, by
    name, as numpy (the card's copied to the host)."""
    state = getattr(opt, "_eager_state", {})
    return {n: _host(state[id(p)]["velocity"]) for n, p in model.named_parameters()
            if id(p) in state}


def set_velocities(fluid, model, opt, vel):
    """Install velocities (by name) as the eager Momentum's state, on the
    model's device: a step then starts from another run's state."""
    opt._eager_state = {id(p): {"velocity": fluid.dygraph.VarBase(vel[n]).value}
                        for n, p in model.named_parameters() if n in vel}


def _host(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


# --- one-layer, one-function and one-optimizer cases ----------------------
# (numpy inputs from fixed seeds; the tests hold the port against the JAX
# package with them, chip_smoke.py's dygraph_parity the card against the CPU)

R = np.random.RandomState(7)
TREE_EDGES = np.array([[[1, 2], [1, 3], [2, 4], [0, 0]],
                       [[1, 2], [2, 3], [2, 4], [3, 5]]], "int32")


def F32(*s):
    return R.randn(*s).astype("float32")


LAYER_CASES = {
    "linear_relu": (lambda dy: dy.Linear(6, 5, act="relu"), [F32(4, 6)]),
    "fc_tanh": (lambda dy: dy.FC(6, 5, act="tanh"), [F32(4, 6)]),
    "conv2d": (lambda dy: dy.Conv2D(3, 4, 3, stride=2, padding=1, act="relu"), [F32(2, 3, 8, 8)]),
    "conv2d_groups_dilation": (lambda dy: dy.Conv2D(4, 6, 3, padding=2, dilation=2, groups=2),
                               [F32(2, 4, 7, 7)]),
    "pool2d_max_pad_ceil": (lambda dy: dy.Pool2D(3, "max", 2, 1, ceil_mode=True),
                            [F32(2, 3, 7, 7)]),
    "pool2d_avg_pad_ceil": (lambda dy: dy.Pool2D(3, "avg", 2, 1, ceil_mode=True, exclusive=True),
                            [F32(2, 3, 7, 7)]),
    "pool2d_global": (lambda dy: dy.Pool2D(pool_type="avg", global_pooling=True),
                      [F32(2, 3, 5, 5)]),
    "batch_norm_train": (lambda dy: dy.BatchNorm(3, act="relu", momentum=0.8),
                         [F32(4, 3, 5, 5) * 2 + 1]),
    "batch_norm_nhwc": (lambda dy: dy.BatchNorm(3, data_layout="NHWC"), [F32(4, 5, 5, 3)]),
    "embedding_padding_idx": (lambda dy: dy.Embedding([10, 4], padding_idx=3),
                              [np.array([[1], [3], [9], [3], [0]], "int64")]),
    "embedding_negative_padding_idx": (lambda dy: dy.Embedding([10, 4], padding_idx=-1),
                                       [np.array([[1, 9], [9, 2]], "int64")]),
    "layer_norm": (lambda dy: dy.LayerNorm([4, 5], act="sigmoid"), [F32(3, 4, 5)]),
    "layer_norm_no_scale": (lambda dy: dy.LayerNorm(5, scale=False), [F32(3, 5)]),
    "dropout": (lambda dy: dy.Dropout(0.3), [F32(6, 7)]),
    "conv2d_transpose": (lambda dy: dy.Conv2DTranspose(3, 2, 3, stride=2, padding=1,
                                                       act="leaky_relu"), [F32(2, 3, 4, 4)]),
    "prelu_all": (lambda dy: dy.PRelu(mode="all"), [F32(2, 3, 4)]),
    "prelu_channel": (lambda dy: dy.PRelu(mode="channel", channel=3), [F32(2, 3, 4)]),
    "prelu_element": (lambda dy: dy.PRelu(mode="element", input_shape=[2, 3, 4]),
                      [F32(2, 3, 4)]),
    "gru_unit": (lambda dy: dy.GRUUnit(12), [F32(3, 12), F32(3, 4)]),
    "gru_unit_origin": (lambda dy: dy.GRUUnit(12, origin_mode=True), [F32(3, 12), F32(3, 4)]),
    "group_norm": (lambda dy: dy.GroupNorm(6, groups=3, act="softmax"), [F32(2, 6, 3, 3)]),
    "spectral_norm": (lambda dy: dy.SpectralNorm([4, 6], dim=1, power_iters=3), [F32(4, 6)]),
    "bilinear_tensor_product": (lambda dy: dy.BilinearTensorProduct(3, 4, 5, act="sigmoid"),
                                [F32(2, 3), F32(2, 4)]),
    "nce": (lambda dy: dy.NCE(20, 6, num_neg_samples=4, seed=3),
            [F32(5, 6), np.array([[1], [4], [19], [0], [7]], "int64")]),
    "conv3d": (lambda dy: dy.Conv3D(2, 3, 3, padding=1, act="relu"), [F32(1, 2, 4, 4, 4)]),
    "conv3d_transpose": (lambda dy: dy.Conv3DTranspose(2, 3, 3, stride=2, padding=1),
                         [F32(1, 2, 3, 3, 3)]),
    "tree_conv": (lambda dy: dy.TreeConv(4, 3, num_filters=2, max_depth=3),
                  [F32(2, 5, 4), TREE_EDGES]),
}


def layer_run(fluid, case, state=None, twice=False):
    """One layer case under the caller's guard: its initial state, outputs
    (two forwards with `twice`, each drawing the next mask or samples),
    the gradients of every parameter and floating input under a fixed
    random cotangent, and the state after."""
    make, inputs = LAYER_CASES[case]
    dy = fluid.dygraph
    layer = make(dy)
    if state is not None:
        layer.set_dict(state)
    initial = layer.state_dict()
    xs = [dy.VarBase(a, stop_gradient=not np.issubdtype(a.dtype, np.floating)) for a in inputs]
    outs = []
    for _ in range(2 if twice else 1):  # a second forward draws the next mask / samples
        out = layer(*xs)
        out = out[0] if isinstance(out, tuple) else out
        cot = np.asarray(np.random.RandomState(11).randn(*out.shape), "float32")
        loss = fluid.layers.reduce_sum(out * dy.VarBase(cot, stop_gradient=True))
        loss.backward()
        outs.append(out.numpy())
    grads = {n: p.gradient() for n, p in layer.named_parameters() if not p.stop_gradient}
    grads.update({f"input{i}": x.gradient() for i, x in enumerate(xs) if not x.stop_gradient})
    return initial, outs, grads, layer.state_dict()


P = np.random.RandomState(5)
PROBS = np.exp(P.randn(4, 5)).astype("f4")
PROBS /= PROBS.sum(-1, keepdims=True)
LABELS = np.array([[1], [4], [0], [2]], "int64")
FUNCTIONAL_CASES = {
    "mean": (lambda L, v: L.mean(v[0]), [F32(3, 4)]),
    "relu": (lambda L, v: L.relu(v[0]), [F32(3, 4)]),
    "sigmoid": (lambda L, v: L.sigmoid(v[0]), [F32(3, 4)]),
    "tanh": (lambda L, v: L.tanh(v[0]), [F32(3, 4)]),
    "sqrt": (lambda L, v: L.sqrt(v[0]), [np.abs(F32(3, 4)) + 0.1]),
    "square": (lambda L, v: L.square(v[0]), [F32(3, 4)]),
    "exp": (lambda L, v: L.exp(v[0]), [F32(3, 4)]),
    "log": (lambda L, v: L.log(v[0]), [np.abs(F32(3, 4)) + 0.1]),
    "softmax": (lambda L, v: L.softmax(v[0], axis=1), [F32(2, 3, 4)]),
    "matmul": (lambda L, v: L.matmul(v[0], v[1], transpose_x=True, transpose_y=True, alpha=0.5),
               [F32(2, 4, 3), F32(2, 5, 4)]),
    "reshape": (lambda L, v: L.reshape(v[0], [0, -1, 2]), [F32(3, 4, 2)]),
    "transpose": (lambda L, v: L.transpose(v[0], [2, 0, 1]), [F32(2, 3, 4)]),
    "concat": (lambda L, v: L.concat([v[0], v[1]], axis=1), [F32(2, 3), F32(2, 5)]),
    "reduce_sum": (lambda L, v: L.reduce_sum(v[0], dim=[0, 2], keep_dim=True), [F32(2, 3, 4)]),
    "reduce_sum_all": (lambda L, v: L.reduce_sum(v[0]), [F32(2, 3)]),
    "reduce_mean": (lambda L, v: L.reduce_mean(v[0], dim=1), [F32(2, 3, 4)]),
    "square_error_cost": (lambda L, v: L.square_error_cost(v[0], v[1]), [F32(4, 1), F32(4, 1)]),
    "cross_entropy": (lambda L, v: L.cross_entropy(v[0], LABELS, ignore_index=4), [PROBS]),
    "cross_entropy_soft": (lambda L, v: L.cross_entropy(v[0], PROBS[::-1].copy(),
                                                        soft_label=True), [PROBS]),
    "softmax_with_cross_entropy": (
        lambda L, v: L.softmax_with_cross_entropy(v[0], LABELS, ignore_index=0), [F32(4, 5)]),
    "softmax_with_cross_entropy_soft": (
        lambda L, v: L.softmax_with_cross_entropy(v[0], PROBS, soft_label=True,
                                                  return_softmax=True)[1], [F32(4, 5)]),
    "accuracy": (lambda L, v: L.accuracy(v[0], LABELS, k=2), [F32(4, 5)]),
    "dropout": (lambda L, v: L.dropout(v[0], 0.4), [F32(5, 6)]),
    "dropout_upscale": (lambda L, v: L.dropout(v[0], 0.4,
                                               dropout_implementation="upscale_in_train"),
                        [F32(5, 6)]),
    "dropout_test": (lambda L, v: L.dropout(v[0], 0.4, is_test=True), [F32(5, 6)]),
}


OPTIMIZERS = {
    "sgd": lambda o, dy: o.SGD(0.1),
    "sgd_piecewise": lambda o, dy: o.SGD(dy.PiecewiseDecay([1, 2], [0.1, 0.05, 0.01])),
    "momentum": lambda o, dy: o.Momentum(0.1, 0.9),
    "momentum_nesterov": lambda o, dy: o.Momentum(0.1, 0.9, use_nesterov=True),
    "adam": lambda o, dy: o.Adam(0.05),
    "adam_noam": lambda o, dy: o.Adam(dy.NoamDecay(16, 2)),
    "adagrad": lambda o, dy: o.Adagrad(0.1, initial_accumulator_value=0.1),
    "rmsprop": lambda o, dy: o.RMSProp(0.01, momentum=0.5),
    "rmsprop_centered": lambda o, dy: o.RMSProp(0.01, centered=True),
    "adamax": lambda o, dy: o.Adamax(0.05),
    "adadelta": lambda o, dy: o.Adadelta(1.0),
    "lars_momentum": lambda o, dy: o.LarsMomentum(0.1, 0.9),
    "decayed_adagrad": lambda o, dy: o.DecayedAdagrad(0.1),
    # inherited in the JAX package: Lamb takes Adam's step, DGC Momentum's
    "lamb": lambda o, dy: o.Lamb(0.05),
    "dgc_momentum": lambda o, dy: o.DGCMomentum(0.1, 0.9, rampup_begin_step=0),
}


def train_linear(fluid, make, steps=3):
    """`steps` eager updates of a Linear(5, 2) on a least-squares fit by the
    optimizer `make(fluid.optimizer, fluid.dygraph)` gives; the losses and
    the state after each step."""
    dy = fluid.dygraph
    rng = np.random.RandomState(8)
    xv = rng.rand(8, 5).astype("f4")
    yv = (xv @ rng.rand(5, 2)).astype("f4")
    layer = dy.Linear(5, 2)
    layer.set_dict({"weight": rng.randn(5, 2).astype("f4"), "bias": rng.randn(2).astype("f4")})
    opt = make(fluid.optimizer, dy)
    losses, after = [], []
    for _ in range(steps):
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            layer(dy.to_variable(xv)), dy.to_variable(yv)))
        loss.backward()
        opt.minimize(loss, parameter_list=layer.parameters())
        layer.clear_gradients()
        losses.append(float(loss.numpy()[0]))
        after.append(layer.state_dict())
    return losses, after


def functional_run(fluid, case):
    """One functional case through `fluid.layers` under the caller's guard:
    the output's dtype and value and the inputs' gradients under a fixed
    random cotangent (dropout's mask from numpy's global generator, seeded)."""
    fn, inputs = FUNCTIONAL_CASES[case]
    dy = fluid.dygraph
    xs = [dy.VarBase(a) for a in inputs]
    np.random.seed(3)
    out = fn(fluid.layers, xs)
    if not out.stop_gradient:
        cot = np.asarray(np.random.RandomState(2).randn(*out.shape), "float32")
        fluid.layers.reduce_sum(out * dy.VarBase(cot, stop_gradient=True)).backward()
    return out.dtype, out.numpy(), [x.gradient() for x in xs]


CLIP_GRADS = [np.random.RandomState(9).randn(3, 4).astype("f4") * 3, None,
              np.random.RandomState(10).randn(5).astype("f4")]
CLIPS = {"value": lambda c: c.GradClipByValue(-0.5, 1.0),
         "value_sym": lambda c: c.GradClipByValue(0.7),
         "norm": lambda c: c.GradClipByNorm(2.0),
         "global_norm": lambda c: c.GradClipByGlobalNorm(1.5)}


def clip_run(fluid, which):
    """A clip over CLIP_GRADS (one of them None) on the caller's device."""
    clip = CLIPS[which](fluid.dygraph_grad_clip)
    out = clip([(i, None if g is None else fluid.dygraph.VarBase(g).value)
                for i, g in enumerate(CLIP_GRADS)])
    return [(p, None if g is None else fluid.dygraph.VarBase(g).numpy()) for p, g in out]


CELL_INPUTS = [np.random.RandomState(11).randn(3, n).astype("f4") for n in (5, 4, 4)]


def cell_run(fluid, cell, state=None):
    """A BasicLSTMUnit (forget bias 0.5) or BasicGRUUnit step on CELL_INPUTS:
    outputs, parameter and input gradients, state.  The cells make their
    weights at the first call: with `state`, a first call builds them and a
    second, after `set_dict(state)`, is the one held."""
    dy = fluid.dygraph
    unit = (fluid.contrib.BasicLSTMUnit("lstm", 4, forget_bias=0.5) if cell == "lstm"
            else fluid.contrib.BasicGRUUnit("gru", 4))
    xs = [dy.VarBase(v) for v in CELL_INPUTS]

    def call():
        return unit(*xs) if cell == "lstm" else (unit(*xs[:2]),)

    outs = call()
    if state is not None:
        unit.set_dict(state)
        outs = call()
    loss = fluid.layers.reduce_sum(fluid.layers.concat(
        [fluid.layers.square(o) for o in outs], axis=1))
    loss.backward()
    return ([o.numpy() for o in outs], {n: p.gradient() for n, p in unit.named_parameters()},
            [v.gradient() for v in xs], unit.state_dict())

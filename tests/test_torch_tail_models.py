"""The programs over the last op files against the JAX package on the
CPU: the CRF sequence tagger scored by chunk_eval, word2vec with an NCE
head and with a hierarchical-sigmoid head, conv3d + pool3d training and
data_norm training its statistics, each from the JAX package's parameters
(io.load_numpy_params of its persistables); then what cannot match the JAX
package's PRNG stream, held by its moments (NCE's and sampled softmax's
negatives, the batch-size-like fillers, sampling_id, random_crop), the
published XXH64 vectors through the hash op, and the graph refusals of the
host-read ops."""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.models import vision as t_vision
from paddle_tpu_torch.ops import cuda_kernels as ck

PKGS = {"jax": (jfluid, j_unique), "torch": (tfluid, t_unique)}


@pytest.fixture(autouse=True)
def launches_unchanged():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before, "a CPU run must not count a kernel launch"


def _built(build):
    out = {}
    for name, (fluid, uniq) in PKGS.items():
        with uniq.guard():
            out[name] = build(fluid)
    return out


def _train_both(built, feeds, fetches, steps, startup_fix=None):
    """Run the JAX package's startup, load its persistables into the port,
    then `steps` runs of each main on the same feeds: the fetches of every
    step, and each package's scope."""
    (jm, js), (tm, _) = built["jax"][:2], built["torch"][:2]
    assert tm.to_dict() == jm.to_dict()
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name)) for v in jm.list_vars()
             if v.persistable and jscope.find_var(v.name) is not None}
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.load_numpy_params(tscope, state)
    outs = {"jax": [], "torch": []}
    for i in range(steps):
        outs["jax"].append([np.asarray(v) for v in jexe.run(
            jm, feed=feeds(i, jfluid), fetch_list=fetches, scope=jscope)])
        outs["torch"].append(texe.run(tm, feed=feeds(i, tfluid), fetch_list=fetches,
                                      scope=tscope))
    return outs, jscope, tscope, state


def _tagger(fluid):
    """build_crf_tagger's program in either package (the JAX package has no
    such builder; this is its code with the package's layers)."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = L.data("x", [6], dtype="float32", lod_level=1)
        label = L.data("label", [1], dtype="int64", lod_level=1)
        emis = L.fc(x, 5, num_flatten_dims=2)
        crf = fluid.ParamAttr(name="crfw")
        loss = L.mean(L.linear_chain_crf(emis, label, param_attr=crf))
        fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
        path = L.crf_decoding(emis, param_attr=crf)
        seq = __import__(fluid.__name__ + ".layers.sequence", fromlist=["_lod_of"])
        metrics = L.chunk_eval(path, label, "IOB", 2, seq_info=seq._lod_of(x))
    return main, startup, [loss.name] + [m.name for m in metrics]


def _tagger_feed(i, fluid):
    rng = np.random.RandomState(3)
    lens = [5, 3, 4, 6]
    lbls = [rng.randint(0, 5, (t, 1)).astype("int64") for t in lens]
    rows = [(rng.randn(t, 6) * 0.1).astype("f4") for t in lens]
    for r, lab in zip(rows, lbls):
        r[np.arange(len(lab)), lab[:, 0]] += 2.0
    return {"x": fluid.LoDTensor(rows), "label": fluid.LoDTensor(lbls)}


def test_crf_tagger_with_chunk_eval_trains_as_the_jax_package():
    """Eight Adam steps of the tagger, the chunk metrics of each step's
    Viterbi paths: the losses within 1e-4, the chunk counts equal and the
    precision / recall / F1 within 1e-6, and the port's builder
    (models.vision.build_crf_tagger) is the same program."""
    built = _built(_tagger)
    fetches = built["jax"][2]
    with t_unique.guard():
        tm = t_vision.build_crf_tagger(feature_dim=6, num_chunk_types=2)[0]
    assert tm.to_dict() == built["torch"][0].to_dict()
    outs, _, _, _ = _train_both(built, _tagger_feed, fetches, 8)
    for w, g in zip(outs["jax"], outs["torch"]):
        np.testing.assert_allclose(float(g[0].reshape(-1)[0]), float(w[0].reshape(-1)[0]),
                                   atol=1e-4)
        for a, b in zip(g[4:], w[4:]):
            assert int(a.reshape(-1)[0]) == int(b.reshape(-1)[0])
        np.testing.assert_allclose(np.concatenate([a.reshape(-1) for a in g[1:4]]),
                                   np.concatenate([b.reshape(-1) for b in w[1:4]]), atol=1e-6)
    losses = [float(o[0].reshape(-1)[0]) for o in outs["torch"]]
    assert losses[-1] < losses[0]
    assert float(outs["torch"][-1][3].reshape(-1)[0]) > float(outs["torch"][0][3].reshape(-1)[0])


def _w2v(fluid, head):
    """build_word2vec at tiny widths with an NCE (fixed negatives) or a
    hierarchical-sigmoid head, in either package."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = [L.data(f"w{i}", [1], dtype="int64") for i in range(3)]
        target = L.data("target", [1], dtype="int64")
        embs = [L.embedding(w, size=[40, 8], param_attr=fluid.ParamAttr(name="w2v_emb"))
                for w in words]
        hidden = L.fc(L.concat(embs, axis=1), 16, act="sigmoid")
        if head == "nce":
            cost = L.nce(hidden, target, 40, num_neg_samples=5,
                         custom_neg_classes=[1, 7, 13, 22, 35])
        else:
            cost = L.hsigmoid(hidden, target, 40)
        loss = L.mean(cost)
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, [loss.name]


def _w2v_feed(i, fluid=None):
    r = np.random.RandomState(0)  # one batch: the loss falls step by step
    feed = {f"w{k}": r.randint(0, 40, (16, 1)).astype(np.int64) for k in range(3)}
    feed["target"] = r.randint(0, 40, (16, 1)).astype(np.int64)
    return feed


@pytest.mark.parametrize("head", ["nce", "hsigmoid"])
def test_word2vec_heads_train_as_the_jax_package(head):
    """Four Adam steps of word2vec with the head: losses within 1e-5, every
    persistable within 1e-5 of its largest element (dtypes equal), and the
    port's build_word2vec(head=...) is the same program."""
    built = _built(lambda fluid: _w2v(fluid, head))
    kw = dict(dict_size=40, embed_size=8, hidden_size=16, head=head)
    if head == "nce":
        kw["custom_neg_classes"] = [1, 7, 13, 22, 35]
    with t_unique.guard():
        tm = t_vision.build_word2vec(**kw)[0]
    assert tm.to_dict() == built["torch"][0].to_dict()
    outs, jscope, tscope, state = _train_both(built, _w2v_feed, built["jax"][2], 4)
    jl = [float(o[0].reshape(-1)[0]) for o in outs["jax"]]
    tl = [float(o[0].reshape(-1)[0]) for o in outs["torch"]]
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    assert tl[-1] < tl[0]
    for n in state:
        want = np.asarray(jscope.find_var(n))
        got = tscope.to_numpy(n)
        assert got.dtype == want.dtype, n
        np.testing.assert_allclose(got, want, atol=1e-5 * (1 + np.abs(want).max()), err_msg=n)


def _conv3d_net(fluid):
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = L.data("x", [2, 4, 6, 6])
        y = L.data("y", [1], dtype="int64")
        c = L.conv3d(x, num_filters=4, filter_size=3, padding=1, act="relu")
        p = L.pool3d(c, pool_size=2, pool_stride=2)
        logits = L.fc(L.reshape(p, [-1, 4 * 2 * 3 * 3]), 3)
        loss = L.mean(L.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return main, startup, [loss.name]


def test_conv3d_trains_as_the_jax_package():
    """tests/test_ops_round4.py's conv3d + pool3d net, five Adam steps from
    the JAX package's parameters: the losses within 1e-5 and falling."""
    rng = np.random.RandomState(120)
    feed = {"x": rng.rand(6, 2, 4, 6, 6).astype("float32"),
            "y": rng.randint(0, 3, (6, 1)).astype("int64")}
    outs, jscope, tscope, state = _train_both(_built(_conv3d_net), lambda i, f: feed,
                                              _built(_conv3d_net)["jax"][2], 5)
    jl = [float(o[0].reshape(-1)[0]) for o in outs["jax"]]
    tl = [float(o[0].reshape(-1)[0]) for o in outs["torch"]]
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    assert tl[-1] < tl[0]


def test_data_norm_trains_its_statistics_as_the_jax_package():
    """data_norm's three accumulators take each batch (count, sum, square
    sum) in both packages, and the normalized output follows them."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            y = fluid.layers.data_norm(fluid.layers.data("x", [3]))
        return main, startup, [y.name]

    built = _built(build)
    rng = np.random.RandomState(4)
    batches = [(rng.randn(5, 3) * 3 + 1).astype(np.float32) for _ in range(3)]
    outs, jscope, tscope, state = _train_both(built, lambda i, f: {"x": batches[i]},
                                              built["jax"][2], 3)
    for w, g in zip(outs["jax"], outs["torch"]):
        np.testing.assert_allclose(g[0], w[0], rtol=1e-5, atol=1e-5)
    for n in state:
        np.testing.assert_allclose(tscope.to_numpy(n), np.asarray(jscope.find_var(n)),
                                   rtol=1e-6, err_msg=n)
    sums = [n for n in state if "batch_sum" in n]
    np.testing.assert_allclose(tscope.to_numpy(sums[0]), sum(b.sum(0) for b in batches),
                               rtol=1e-5)


# --- what the PRNG streams cannot match: moments --------------------------------------

def _one_op(fluid, op_type, inputs, attrs, outs, exe=None, scope=None):
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        block = prog.global_block()
        io = {}
        for slot, arr in inputs.items():
            block.create_var(f"in_{slot}", shape=arr.shape, dtype=str(arr.dtype), is_data=True)
            io[slot] = [f"in_{slot}"]
        for slot, dt in outs.items():
            block.create_var(f"out_{slot}", dtype=dt)
        block.append_op(op_type, inputs=io, outputs={s: [f"out_{s}"] for s in outs}, attrs=attrs)
    return (exe or fluid.Executor(fluid.CPUPlace())).run(
        prog, feed={f"in_{s}": a for s, a in inputs.items()},
        fetch_list=[f"out_{s}" for s in outs], scope=scope or fluid.Scope())


@pytest.mark.parametrize("sampler", [0, 1, 2])
def test_nce_negatives_by_their_moments(sampler):
    """The negatives each sampler draws (uniform, log-uniform, custom
    distribution) have the frequencies of its distribution in both
    packages (within 4 standard errors), and the true labels lead each row."""
    C, B, S = 8, 500, 20
    rng = np.random.RandomState(6)
    probs = rng.dirichlet(np.ones(C)).astype(np.float32)
    inputs = {"Input": rng.randn(B, 4).astype(np.float32),
              "Label": rng.randint(0, C, (B, 1)).astype(np.int64),
              "Weight": rng.randn(C, 4).astype(np.float32)}
    if sampler == 2:
        inputs["CustomDistProbs"] = probs
        want = probs
    elif sampler == 1:
        k = np.arange(C)
        want = np.log((k + 2.0) / (k + 1.0)) / np.log(C + 1.0)
        want = want / want.sum()
    else:
        want = np.full(C, 1.0 / C)
    attrs = {"num_total_classes": C, "num_neg_samples": S, "sampler": sampler}
    for fluid in (jfluid, tfluid):
        cost, labels = _one_op(fluid, "nce", inputs, attrs,
                               {"Cost": "float32", "SampleLabels": "int64"})
        labels = np.asarray(labels)
        assert labels.shape == (B, 1 + S) and np.isfinite(np.asarray(cost)).all()
        np.testing.assert_array_equal(labels[:, 0], inputs["Label"][:, 0])
        freq = np.bincount(labels[:, 1:].reshape(-1), minlength=C) / (B * S)
        se = np.sqrt(want * (1 - want) / (B * S))
        assert (np.abs(freq - want) <= 4 * se + 1e-3).all(), (fluid.__name__, freq, want)


def test_sample_logits_by_its_moments():
    """Sampled softmax: the true label's column is 0 of every row, the
    negatives follow the log-uniform law, and masked draws are -1e20."""
    C, B, S = 10, 400, 12
    rng = np.random.RandomState(7)
    inputs = {"Logits": rng.randn(B, C).astype(np.float32),
              "Labels": rng.randint(0, C, (B, 1)).astype(np.int64)}
    k = np.arange(C)
    want = np.log((k + 2.0) / (k + 1.0)) / np.log(C + 1.0)
    for fluid in (jfluid, tfluid):
        logits, samples, labels = (np.asarray(a) for a in _one_op(
            fluid, "sample_logits", inputs, {"num_samples": S},
            {"SampledLogits": "float32", "Samples": "int64", "SampledLabels": "int64"}))
        assert samples.shape == (B, 1 + S) and (labels == 0).all()
        np.testing.assert_array_equal(samples[:, 0], inputs["Labels"][:, 0])
        freq = np.bincount(samples[:, 1:].reshape(-1), minlength=C) / (B * S)
        assert np.abs(freq - want / want.sum()).max() < 0.02
        hits = samples[:, 1:] == samples[:, :1]
        assert (logits[:, 1:][hits] == -1e20).all()


@pytest.mark.parametrize("op_type,attrs,mean,std", [
    ("uniform_random_batch_size_like", {"min": -1.0, "max": 3.0}, 1.0, 4.0 / np.sqrt(12.0)),
    ("gaussian_random_batch_size_like", {"mean": 1.0, "std": 2.0}, 1.0, 2.0),
])
def test_batch_size_like_fillers_by_their_moments(op_type, attrs, mean, std):
    ref = np.zeros((400, 3), np.float32)
    attrs = dict(attrs, shape=[-1, 250], dtype="float32")
    for fluid in (jfluid, tfluid):
        (out,) = _one_op(fluid, op_type, {"Input": ref}, attrs, {"Out": "float32"})
        out = np.asarray(out)
        assert out.shape == (400, 250)
        assert abs(out.mean() - mean) < 0.02 * std * 5 and abs(out.std() - std) < 0.02 * std


def test_sampling_id_and_random_crop_by_their_moments():
    rng = np.random.RandomState(8)
    probs = np.tile(np.array([[0.1, 0.6, 0.3]], np.float32), (3000, 1))
    x = rng.randn(4, 3, 9, 9).astype(np.float32)
    for fluid in (jfluid, tfluid):
        (ids,) = _one_op(fluid, "sampling_id", {"X": probs}, {}, {"Out": "int32"})
        freq = np.bincount(np.asarray(ids).reshape(-1), minlength=3) / 3000
        assert np.abs(freq - probs[0]).max() < 0.03, freq
        starts = set()
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        for _ in range(12):  # one scope: its random stream moves on each run
            (out,) = _one_op(fluid, "random_crop", {"X": x}, {"shape": [3, 5, 4]},
                             {"Out": "float32"}, exe, scope)
            out = np.asarray(out)
            assert out.shape == (4, 3, 5, 4)
            hit = [(i, j) for i in range(5) for j in range(6)
                   if np.array_equal(x[:, :, i:i + 5, j:j + 4], out)]
            assert len(hit) == 1  # one offset, the same for every leading index
            starts.add(hit[0])
        assert len(starts) > 3


def test_hash_matches_the_published_xxh64_vectors():
    """XXH64 of int32 rows through the port's hash op, against the
    published vectors (a row's bytes: seed 0 'abcd' = b'abcd', and the
    32-byte and longer lanes) and the JAX package's numpy specification."""
    from paddle_tpu.ops.misc_ops import _xxh64
    from paddle_tpu_torch.ops.misc_ops import _xxh64_words
    import torch

    for text, want in ((b"", 0xEF46DB3751D8E999), (b"abcd", None),
                       (b"Nobody inspects the spammish repetition!", None)):
        if want is not None:
            assert _xxh64(text, 0) == want
    rng = np.random.RandomState(9)
    for last in (1, 2, 3, 7, 8, 9, 16, 17):
        rows = rng.randint(-2 ** 31, 2 ** 31 - 1, (5, last)).astype(np.int32)
        words = torch.from_numpy(rows.astype(np.int64) & 0xFFFFFFFF)
        for seed in (0, 1, 5):
            hi, lo = _xxh64_words(words, seed)
            got = [(int(h) << 32) | int(l) for h, l in zip(hi, lo)]
            assert got == [_xxh64(r.tobytes(), seed) for r in rows], (last, seed)
    # 40 bytes of text, as 10 little-endian int32 words: the published vector
    text = b"Nobody inspects the spammish repetition!"
    words = torch.from_numpy(np.frombuffer(text, "<u4").astype(np.int64)[None, :])
    hi, lo = _xxh64_words(words, 0)
    assert (int(hi[0]) << 32 | int(lo[0])) == _xxh64(text, 0)
    (out,) = _one_op(tfluid, "hash", {"X": np.frombuffer(b"abcd", "<i4").reshape(1, 1).copy()},
                     {"mod_by": 2 ** 31 - 1, "num_hash": 1}, {"Out": "int32"})
    assert int(np.asarray(out).reshape(-1)[0]) == _xxh64(b"abcd", 0) % (2 ** 31 - 1)


def test_host_read_ops_refuse_a_graph_with_their_reason():
    """The executor reads chunk_eval's and merge_selected_rows' refusals off
    the program before any capture."""
    from paddle_tpu_torch.core.executor import _graph_refusal

    with t_unique.guard():
        main = t_vision.build_crf_tagger()[0]
    assert "chunk_eval" in _graph_refusal(main.global_block().ops)
    with t_unique.guard():
        main = t_vision.build_word2vec(dict_size=50, head="hsigmoid")[0]
    assert _graph_refusal(main.global_block().ops) is None
    prog = tfluid.Program()
    with tfluid.program_guard(prog, tfluid.Program()):
        tfluid.layers.merge_selected_rows(tfluid.layers.data("x", [3]))
    assert "unique_consecutive" in _graph_refusal(prog.global_block().ops)

"""The port's data pipeline on the CPU against the JAX package: RecordIO
files (native/recordio.cc in both), the corrupt-chunk budget, the reader
decorators with their stream states, sharding and repartitioning,
`FeedSpec` / `DataFeeder`, the synthetic corpora, `DataLoader` on the CPU,
and `QueueDataset` / `train_from_dataset`.

Every case runs through both packages on the same numpy inputs, drawn from
a seed.  Tolerances: samples, batches and stream states exactly (states as
their pickled bytes); errors by class and message; fit-a-line losses
1e-5."""
import contextlib
import os
import pickle
import struct

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import datasets as j_datasets
from paddle_tpu import monitor as j_monitor
from paddle_tpu import reader as j_reader
from paddle_tpu import recordio as j_rio
from paddle_tpu import recordio_writer as j_writer
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu_torch import datasets as t_datasets
from paddle_tpu_torch import monitor as t_monitor
from paddle_tpu_torch import reader as t_reader
from paddle_tpu_torch import recordio as t_rio
from paddle_tpu_torch import recordio_writer as t_writer
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.ops import cuda_kernels as ck

PKGS = {
    "jax": dict(fluid=jfluid, rio=j_rio, reader=j_reader, datasets=j_datasets,
                monitor=j_monitor, unique=j_unique, writer=j_writer),
    "torch": dict(fluid=tfluid, rio=t_rio, reader=t_reader, datasets=t_datasets,
                  monitor=t_monitor, unique=t_unique, writer=t_writer),
}


@pytest.fixture(autouse=True)
def launches_unchanged():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before, "a CPU run must not count a kernel launch"


@contextlib.contextmanager
def _budget(pkg, n):
    """FLAGS_data_corrupt_budget = n in one package, a fresh spend window."""
    pkg["fluid"].set_flags({"FLAGS_data_corrupt_budget": n})
    pkg["rio"].reset_corrupt_spent()
    try:
        yield
    finally:
        pkg["fluid"].set_flags({"FLAGS_data_corrupt_budget": 0})
        pkg["rio"].reset_corrupt_spent()


@contextlib.contextmanager
def _monitored(pkg):
    mon = pkg["monitor"]
    mon.reset()
    mon.enable()
    try:
        yield mon
    finally:
        mon.disable()


def _write(rio, path, n, chunk=4, dim=3):
    rio.write_arrays(path, [(np.full(dim, i, "f4"),) for i in range(n)], max_chunk_records=chunk)
    return path


def _corrupt_chunk(path, k, at=5):
    """Flip one payload byte of chunk k (20-byte headers, payload length at +8)."""
    raw = bytearray(open(path, "rb").read())
    off = 0
    for _ in range(k):
        (plen,) = struct.unpack_from("<Q", raw, off + 8)
        off += 20 + plen
    raw[off + 20 + at] ^= 0xFF
    open(path, "wb").write(bytes(raw))


def _outcome(fn):
    """(result, None) or (None, (error class name, message))."""
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 -- the class is what is compared
        return None, (type(e).__name__, str(e))


# --- RecordIO: either package reads what the other wrote ---------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_recordio_files_written_by_one_package_read_in_the_other(tmp_path, writer):
    reader = "torch" if writer == "jax" else "jax"
    w, r = PKGS[writer]["rio"], PKGS[reader]["rio"]
    rng = np.random.RandomState(0)
    samples = [(rng.rand(3, 4).astype("f4"), rng.randint(0, 9, (2,)).astype("i8"))
               for _ in range(7)]
    p = str(tmp_path / "a.rio")
    assert w.write_arrays(p, samples, max_chunk_records=2) == 7
    back = list(r.read_arrays(p))
    assert len(back) == 7
    for (a, b), (a2, b2) in zip(samples, back):
        np.testing.assert_array_equal(a, a2)
        np.testing.assert_array_equal(b, b2)
        assert (a2.dtype, b2.dtype) == (a.dtype, b.dtype)
    raw = str(tmp_path / "raw.rio")
    with w.Writer(raw, max_chunk_records=3) as f:
        for i in range(10):
            f.write(bytes([i]) * (i + 1))
    with r.Scanner(raw) as s:
        assert list(s) == [bytes([i]) * (i + 1) for i in range(10)]
    slot = str(tmp_path / "slot.rio")
    w.write_arrays(slot, [(np.full(3, i, "f4"), np.asarray([i], "i4")) for i in range(10)],
                   max_chunk_records=4)
    with r.SlotBatchReader([slot], 4, n_threads=1, drop_last=False) as q:
        got = [b[1].reshape(-1).tolist() for b in q]
    assert got == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    conv = str(tmp_path / "conv")
    paths = PKGS[writer]["writer"].convert_reader_to_recordio_files(
        conv, 4, lambda: iter([(np.int64(i), np.ones(2, "f4") * i) for i in range(9)]))
    assert [os.path.basename(x) for x in paths] == ["conv-00000", "conv-00001", "conv-00002"]
    assert [int(s[0].reshape(-1)[0]) for x in paths for s in r.read_arrays(x)] == list(range(9))


def test_the_port_builds_its_own_library(tmp_path, monkeypatch):
    """The port compiles native/recordio.cc into its own _build/ and never
    writes the JAX package's library; a compiler that fails raises with its
    error, and no Python scanner takes over."""
    t_rio._lib()
    assert os.path.dirname(t_rio._SO).endswith(os.path.join("paddle_tpu_torch", "_build"))
    assert os.path.exists(t_rio._SO)
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(t_rio, "_SRC", str(bad))
    monkeypatch.setattr(t_rio, "_SO", str(tmp_path / "_build" / "librecordio.so"))
    monkeypatch.setattr(t_rio, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build .*bad.cc"):
        t_rio.Scanner(str(tmp_path / "x.rio"))
    assert not os.path.exists(t_rio._SO)


# --- CRC, truncation and the corrupt budget: the same outcomes ------------------

def _crc(pkg, d):
    rio = pkg["rio"]
    p = os.path.join(d, "c.rio")
    with rio.Writer(p) as w:
        w.write(b"hello world" * 10)
    raw = bytearray(open(p, "rb").read())
    raw[-3] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    return [_outcome(lambda: list(rio.Scanner(p)))]


def _truncated(pkg, d):
    rio = pkg["rio"]
    p = _write(rio, os.path.join(d, "t.rio"), 12, chunk=4)
    raw = open(p, "rb").read()
    open(p, "wb").write(raw[:len(raw) - 10])
    strict = _outcome(lambda: list(rio.read_arrays(p)))
    with _budget(pkg, 1), _monitored(pkg) as mon:
        s = rio.Scanner(p)
        got = [float(rio._unpack_arrays(r)[0][0]) for r in s]
        tolerant = (got, s.corrupt_chunks, mon.counter("data.corrupt_chunks").value)
    return [strict, tolerant]


def _flipped_and_budget(pkg, d):
    rio = pkg["rio"]
    p = _write(rio, os.path.join(d, "f.rio"), 12, chunk=4)
    _corrupt_chunk(p, 1)
    with _budget(pkg, 1), _monitored(pkg) as mon:
        got = [float(s[0][0]) for s in rio.read_arrays(p)]
        first = (got, mon.counter("data.corrupt_chunks").value,
                 mon.counter("data.chunks_scanned").value)
    with _budget(pkg, 1):
        rio._spend_corrupt(1, "earlier-file")  # the budget already spent
        try:
            list(rio.read_arrays(p))
            exhausted = None
        except Exception as e:  # noqa: BLE001
            exhausted = (type(e).__name__, str(e), getattr(e, "budget_exhausted", False),
                         e.phase)
    return [first, exhausted]


def _mixed_slot_files(pkg, d):
    rio = pkg["rio"]
    good, bad = os.path.join(d, "good.rio"), os.path.join(d, "bad.rio")
    rio.write_arrays(good, [(np.full(3, i, "f4"), np.asarray([i], "i4")) for i in range(12)],
                     max_chunk_records=4)
    rio.write_arrays(bad, [(np.full(3, 100 + i, "f4"), np.asarray([100 + i], "i4"))
                           for i in range(12)], max_chunk_records=4)
    _corrupt_chunk(bad, 1, at=3)
    with _budget(pkg, 2), _monitored(pkg) as mon:
        with rio.SlotBatchReader([good, bad], 4, n_threads=1, drop_last=False) as r:
            ids = sorted(int(v) for b in r for v in b[1].reshape(-1))
        tolerant = (ids, mon.counter("data.corrupt_chunks").value)

    def strict():
        with rio.SlotBatchReader([good, bad], 4, n_threads=1) as r:
            return list(r)
    return [tolerant, _outcome(strict)]


def _epochs(pkg, d):
    rio = pkg["rio"]
    p = _write(rio, os.path.join(d, "ep.rio"), 12, chunk=4)
    _corrupt_chunk(p, 1)
    with _budget(pkg, 1), _monitored(pkg) as mon:
        r = rio.reader_creator(p)
        got = [[float(s[0][0]) for s in r()] for _ in range(3)]
        return [got, rio.corrupt_spent(), mon.counter("data.corrupt_chunks").value]


def _seek_into_corrupt(pkg, d):
    rio = pkg["rio"]
    p = _write(rio, os.path.join(d, "sc.rio"), 9, chunk=3)
    s = rio.Scanner(p)
    it = iter(s)
    for _ in range(4):
        next(it)
    state = s.state_dict()
    s.close()
    _corrupt_chunk(p, 1, at=2)
    with _budget(pkg, 4):
        return [state, _outcome(lambda: rio.Scanner(p).load_state_dict(state))]


def _exhausted_scanner(pkg, d):
    rio = pkg["rio"]
    p = _write(rio, os.path.join(d, "sx.rio"), 6)
    with rio.Scanner(p) as s:
        return [sum(1 for _ in s), sum(1 for _ in s), _outcome(s.tell), _outcome(lambda: s.seek(0))]


def _file_faults(pkg, d):
    rio = pkg["rio"]
    faults = pkg["fluid"].faults
    p = _write(rio, os.path.join(d, "ff.rio"), 16, chunk=4)
    inj = faults.FaultInjector("corrupt_chunk@1;truncated_file@2")
    inj.on_files([p])
    fired = [f.kind for f in inj.fired()]
    inj.on_files([p])
    with _budget(pkg, 4):
        return [fired, [float(s[0][0]) for s in rio.read_arrays(p)], rio.corrupt_spent()]


def _empty_files(pkg, d):
    rio = pkg["rio"]
    e = os.path.join(d, "e.rio")
    with rio.Writer(e):
        pass
    z = os.path.join(d, "z.rio")
    open(z, "wb").close()
    return [list(rio.Scanner(e)), list(rio.Scanner(z))]


CORRUPTION_CASES = {"crc": _crc, "truncated": _truncated, "flipped_budget": _flipped_and_budget,
                    "mixed_slot_files": _mixed_slot_files, "epochs": _epochs,
                    "seek_into_corrupt": _seek_into_corrupt, "exhausted": _exhausted_scanner,
                    "file_faults": _file_faults, "empty": _empty_files}


@pytest.mark.parametrize("case", sorted(CORRUPTION_CASES))
def test_corruption_and_budget_give_the_same_outcomes(tmp_path, case):
    """tests/test_recordio.py's matrix, each case in both packages: the same
    surviving samples, corrupt and scanned counts, and errors (class and
    message; IOError for strict scanners, a DataError with
    `budget_exhausted` past the budget)."""
    got = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        # messages name the file: compare them with the directory left out
        got[name] = repr(CORRUPTION_CASES[case](pkg, str(d))).replace(str(d), "<dir>")
    assert got["torch"] == got["jax"]
    if case in ("crc", "truncated", "mixed_slot_files"):
        assert "Error" in got["torch"]  # the strict path raised
    if case == "flipped_budget":
        assert "'DataError'" in got["torch"] and got["torch"].endswith("True, 'loader')]")


def test_queue_dataset_partial_batch_resume_in_both(tmp_path):
    def run(pkg):
        fluid, rio = pkg["fluid"], pkg["rio"]
        p = str(tmp_path / f"qd_{pkg['rio'].__name__}.rio")
        rio.write_arrays(p, [(np.full(2, i, "f4"), np.asarray([i], "i4")) for i in range(10)],
                         max_chunk_records=4)

        def make():
            ds = fluid.QueueDataset()
            ds.set_batch_size(4)
            ds.set_thread(1)
            ds.set_filelist([p])
            ds.set_use_var(["a", "b"])
            ds._drop_last = False
            return ds

        ds = make()
        sizes = [b["b"].shape[0] for b in ds.batches()]
        state = ds.state_dict()
        ds2 = make()
        ds2.load_state_dict(state)
        return sizes, state, list(ds2.batches())

    assert run(PKGS["torch"]) == run(PKGS["jax"]) == ([4, 4, 2], {"samples_consumed": 10}, [])


# --- reader decorators: the same batches and the same stream states -------------

def _sample_file(pkg, path, n=40):
    rng = np.random.RandomState(3)
    pkg["rio"].write_arrays(path, [(rng.rand(3).astype("f4"), np.asarray([i], "i8"))
                                   for i in range(n)], max_chunk_records=7)
    return path


def _normalize(batch):
    return {"x": np.stack([s[0] for s in batch]) * 2.0,
            "id": np.stack([s[1] for s in batch])}


def _pipeline(pkg, kind, path):
    r, rio = pkg["reader"], pkg["rio"]
    src = rio.reader_creator(path)
    if kind == "shuffle_batch_map":
        return r.map_readers(_normalize, r.batch(r.shuffle(src, 9, seed=5), 4))
    if kind == "xmap_ordered":
        return r.batch(r.xmap_readers(lambda s: (s[0] + 1.0, s[1]), src, 3, 4, order=True), 5)
    if kind == "chain_firstn":
        other = rio.reader_creator(path)
        return r.batch(r.firstn(r.chain(src, r.shuffle(other, 6, seed=1)), 70), 6)
    if kind == "cache":
        return r.batch(r.cache(src), 8)
    if kind == "shard":
        return r.batch(r.shard(r.shuffle(src, 10, seed=2), 1, 3), 3)
    raise ValueError(kind)


def _walk(pipe):
    """Each batch of one pass, with the pickled state after it."""
    out = []
    for b in pipe():
        arrays = {k: np.asarray(v) for k, v in b.items()} if isinstance(b, dict) else \
            [[np.asarray(a) for a in s] for s in b]
        out.append((arrays, pickle.dumps(pipe.state_dict())))
    return out


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert repr(x[0]) == repr(y[0])
        assert x[1] == y[1]


PIPELINES = ("shuffle_batch_map", "xmap_ordered", "chain_firstn", "cache", "shard")


@pytest.mark.parametrize("kind", PIPELINES)
def test_decorator_chain_gives_the_same_batches_and_states(tmp_path, kind):
    """The same decorator chain over the same RecordIO file yields the same
    batches and the same pickled state after each batch in both packages;
    a resume from any of those states, in either package, lands at the
    same next batch (each package loads the other's states too)."""
    path = _sample_file(PKGS["jax"], str(tmp_path / "s.rio"))
    walks = {name: _walk(_pipeline(pkg, kind, path)) for name, pkg in PKGS.items()}
    _same_batches(walks["torch"], walks["jax"])
    assert len(walks["jax"]) >= 3
    assert all(t_reader.is_checkpointable(_pipeline(PKGS["torch"], kind, path)) for _ in [0])
    for i in range(len(walks["jax"]) - 1):
        state = pickle.loads(walks["jax"][i][1])
        want = walks["jax"][i + 1:]
        for name, pkg in PKGS.items():
            pipe = _pipeline(pkg, kind, path)
            pipe.load_state_dict(pickle.loads(pickle.dumps(state)))
            _same_batches(_walk(pipe), want)


def test_repartition_of_shard_cursors_matches(tmp_path):
    """Three strided shards stopped after two batches each, re-split for two
    ranks by both packages: the same cursors, and the two new shards
    together yield exactly the samples not yet consumed."""
    path = _sample_file(PKGS["jax"], str(tmp_path / "s.rio"), n=30)
    states = {}
    for name, pkg in PKGS.items():
        r = pkg["reader"]
        cursors = []
        for rank in range(3):
            pipe = r.batch(r.shard(pkg["rio"].reader_creator(path), rank, 3), 2)
            it = pipe()
            next(it)
            next(it)
            cursors.append(pipe.state_dict())
        states[name] = (cursors, r.repartition_stream_states(cursors, 2))
    assert pickle.dumps(states["torch"]) == pickle.dumps(states["jax"])
    seen = []
    for rank, st in enumerate(states["jax"][1]):
        pipe = t_reader.batch(t_reader.shard(t_rio.reader_creator(path), rank, 2), 2)
        pipe.load_state_dict(st)
        seen += [int(s[1][0]) for b in pipe() for s in b]
    assert sorted(seen) == list(range(12, 30))
    for bad in ([states["jax"][0][0]], [{"src": {"kind": "shard", "rank": 0, "world": 1,
                                                   "pos": 2, "base": None}}, {"x": 1}]):
        errs = {name: _outcome(lambda: pkg["reader"].repartition_stream_states(bad, 2))[1]
                for name, pkg in PKGS.items()}
        assert errs["torch"] == errs["jax"] and errs["torch"][0] == "ValueError"


def test_xmap_and_loader_errors_are_reraised_as_themselves(tmp_path):
    for pkg in PKGS.values():
        r = pkg["reader"]

        def bad_mapper(s):
            if int(s) == 3:
                raise KeyError("mapper bug")
            return s

        pipe = r.xmap_readers(bad_mapper, lambda: iter(range(8)), 2, 4, order=True)
        with pytest.raises(KeyError, match="mapper bug") as ei:
            list(pipe())
        ce = pkg["fluid"].errors.classify(ei.value)
        assert type(ce).__name__ == "DataError" and ce.batch_index == 3


# --- FeedSpec, DataFeeder, the corpora ----------------------------------------

def _feed_vars(pkg):
    fluid = pkg["fluid"]
    main, startup = fluid.Program(), fluid.Program()
    with pkg["unique"].guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data("img", [3, 4], dtype="float32")
        label = fluid.layers.data("label", [1], dtype="int64")
    return img, label


def _feeder_cases(pkg):
    fluid, r = pkg["fluid"], pkg["reader"]
    img, label = _feed_vars(pkg)
    feeder = r.DataFeeder([img, label])
    rng = np.random.RandomState(4)
    samples = [(rng.rand(3, 4).astype("f4"), np.int64(i)) for i in range(5)]
    fed = feeder.feed(samples)
    out = [{k: (v.dtype.str, v.shape, v.tobytes()) for k, v in fed.items()}]
    spec = r.FeedSpec([img, label])
    cases = [("img", np.zeros((2, 3, 5), "f4"), None),   # shape
             ("img", np.zeros((2, 3, 4), "U1"), None),   # string data
             ("label", np.zeros((2, 1), "f4"), None),    # float into an int slot
             ("label", np.zeros((2, 1), "i4"), None),    # int widening: fine
             ("img", np.full((2, 3, 4), np.nan, "f4"), "full"),
             ("img", np.full((2, 3, 4), np.nan, "f4"), "shape"),
             ("other", np.zeros(7), None)]               # not in the spec
    for name, arr, mode in cases:
        old = fluid.get_flags("FLAGS_feed_validation")["FLAGS_feed_validation"]
        if mode:
            fluid.set_flags({"FLAGS_feed_validation": mode})
        try:
            res = _outcome(lambda: spec.validate(name, arr))
        finally:
            fluid.set_flags({"FLAGS_feed_validation": old})
        if res[1] is not None:
            try:
                spec.validate(name, arr, mode or "shape")
            except Exception as e:  # noqa: BLE001
                res = (res[0], res[1], e.phase,
                       type(fluid.errors.classify(e)).__name__)
        out.append(res)
    out.append(_outcome(lambda: feeder.feed([(np.zeros((3, 4), "U1"), np.int64(0))])))
    return out


def test_datafeeder_and_feedspec_give_the_same_arrays_and_errors():
    got = {name: _feeder_cases(pkg) for name, pkg in PKGS.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][1][1][0] == "DataError" and got["torch"][4][1] is None


@pytest.mark.parametrize("corpus", ["mnist.train", "mnist.test", "cifar.train10",
                                    "cifar.test100", "uci_housing.train", "imdb.train",
                                    "wmt14.test"])
def test_corpora_give_the_same_samples(corpus):
    cls, fn = corpus.split(".")
    got = {}
    for name, pkg in PKGS.items():
        reader = getattr(getattr(pkg["datasets"], cls), fn)()
        got[name] = [[np.asarray(a) for a in s] for s, _ in zip(reader(), range(40))]
    assert len(got["torch"]) == 40
    for a, b in zip(got["torch"], got["jax"]):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


# --- DataLoader on the CPU --------------------------------------------------------

def _loader_batches(n=5):
    rng = np.random.RandomState(6)
    return [{"img": rng.rand(2, 3, 4), "label": rng.randint(0, 9, (2, 1))} for _ in range(n)]


def test_dataloader_on_the_cpu_gives_the_jax_packages_batches_and_states():
    """The same checkpointable batch generator through both loaders: the
    same values and dtypes (float64 -> float32, int64 -> int32: the
    declared dtype, then the x32 rule), the same consumer-side states, and
    a resume from the third batch's state."""
    batches = _loader_batches()
    got = {}
    for name, pkg in PKGS.items():
        r = pkg["reader"]
        img, label = _feed_vars(pkg)
        gen = r.cache(lambda: iter(batches))
        kw = {"device": tfluid.CPUPlace()} if name == "torch" else {}
        loader = r.DataLoader.from_generator([img, label], capacity=2, **kw)
        loader.set_batch_generator(gen)
        seen, states = [], []
        for b in loader:
            seen.append({k: np.asarray(v) for k, v in b.items()})
            states.append(loader.state_dict())
            if name == "torch":
                assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                           for v in b.values())
        loader.load_state_dict(states[2])
        rest = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
        got[name] = (seen, states, rest)
    for (a, b) in zip(got["torch"][0] + got["torch"][2], got["jax"][0] + got["jax"][2]):
        for k in ("img", "label"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert got["torch"][1] == got["jax"][1]
    assert len(got["torch"][2]) == 2
    assert got["torch"][0][0]["img"].dtype == np.float32
    assert got["torch"][0][0]["label"].dtype == np.int32


def test_dataloader_reraises_the_producers_exception_and_validates():
    img, label = _feed_vars(PKGS["torch"])

    def gen():
        yield {"img": np.zeros((2, 3, 4), "f4"), "label": np.zeros((2, 1), "i8")}
        raise ZeroDivisionError("user generator bug")

    loader = tfluid.DataLoader([img, label], device=tfluid.CPUPlace()).set_batch_generator(gen)
    it = iter(loader)
    next(it)
    with pytest.raises(ZeroDivisionError, match="user generator bug") as ei:
        next(it)
    ce = tfluid.errors.classify(ei.value)
    assert isinstance(ce, tfluid.errors.DataError) and ce.batch_index == 1
    loader = tfluid.DataLoader([img, label], device=tfluid.CPUPlace()).set_batch_generator(
        lambda: iter([{"img": np.zeros((2, 3, 5), "f4"), "label": np.zeros((2, 1), "i8")}]))
    with pytest.raises(tfluid.errors.DataError, match="slot 'img' has shape"):
        list(loader)


def test_dataloader_defaults_to_the_card_and_refuses_sharding(monkeypatch):
    img, label = _feed_vars(PKGS["torch"])
    with pytest.raises(NotImplementedError, match="A10"):
        tfluid.DataLoader([img, label], device=tfluid.CPUPlace(), sharding={"img": None})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.DataLoader([img, label])
    assert tfluid.PyReader is tfluid.DataLoader


class _PendingUpload:
    """Stands in for a CUDA event of an upload still queued on the card."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


def test_pinned_pool_never_hands_out_a_buffer_an_upload_may_read(monkeypatch):
    """The loader's pinned buffers (host pages here; `pin_memory` needs a
    card): feeds of one shape and dtype in one batch each get a buffer of
    their own, a buffer whose upload is pending is not handed out again,
    and past the pool's depth the oldest upload is waited for first."""
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k: empty(*a, **k))
    pool = t_reader._PinnedPool(2)
    batch = [pool.take(n, (4, 8), torch.int32) for n in ("ids", "pos_ids", "labels")]
    assert len({s[0].data_ptr() for s in batch}) == 3
    ev = [_PendingUpload(), _PendingUpload()]
    batch[0][1:] = [ev[0], 1]
    second = pool.take("ids", (4, 8), torch.int32)
    assert second is not batch[0]
    second[1:] = [ev[1], 2]
    third = pool.take("ids", (4, 8), torch.int32)  # both pending: wait for upload 1
    assert third is batch[0] and ev[0].done and not ev[1].done
    third[1:] = [_PendingUpload(), 3]
    ev[1].done = True
    assert pool.take("ids", (4, 8), torch.int32) is second


# --- QueueDataset / train_from_dataset on fit-a-line ---------------------------

def _fit_a_line(pkg):
    fluid = pkg["fluid"]
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 0
    with pkg["unique"].guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [13])
        y = fluid.layers.data("y", [1])
        loss = fluid.layers.mean(fluid.layers.square_error_cost(fluid.layers.fc(x, 1), y))
        fluid.optimizer.SGD(0.05).minimize(loss)
    return main, startup, loss


def test_queue_dataset_trains_fit_a_line_alike(tmp_path):
    """Two RecordIO slot files, QueueDataset at one thread, batch 16,
    `Executor.train_from_dataset` from the JAX package's initial weights:
    the same losses within 1e-5; a dataset resumed from its state after
    batch 2 yields batches 3 onward again."""
    rng = np.random.RandomState(0)
    files = []
    for k in range(2):
        p = str(tmp_path / f"line{k}.rio")
        xs = rng.rand(48, 13).astype("f4")
        t_rio.write_arrays(p, [(x, x.sum(keepdims=True)) for x in xs], max_chunk_records=10)
        files.append(p)
    built = {n: _fit_a_line(p) for n, p in PKGS.items()}
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(built["jax"][1], scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in built["jax"][0].list_vars() if v.persistable}
    tscope = tfluid.Scope()
    tfluid.io.load_numpy_params(tscope, state)
    runs = {"jax": (jexe, jscope), "torch": (tfluid.Executor(tfluid.CPUPlace()), tscope)}
    logs = {}
    for name, pkg in PKGS.items():
        ds = pkg["fluid"].QueueDataset()
        ds.set_batch_size(16)
        ds.set_thread(1)
        ds.set_filelist(files)
        ds.set_use_var(["x", "y"])
        assert pkg["reader"].is_checkpointable(ds)
        exe, scope = runs[name]
        main, _, loss = built[name]
        logs[name] = exe.train_from_dataset(main, ds, scope=scope, fetch_list=[loss],
                                            print_period=1)
    assert [i for i, _ in logs["torch"]] == list(range(6))
    lt = [float(d[built["torch"][2].name][0]) for _, d in logs["torch"]]
    lj = [float(d[built["jax"][2].name][0]) for _, d in logs["jax"]]
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-5)
    ds = tfluid.QueueDataset()
    ds.set_batch_size(16)
    ds.set_thread(1)
    ds.set_filelist(files)
    ds.set_use_var(["x", "y"])
    everything = list(ds.batches())
    it = ds.batches()
    next(it)
    next(it)
    st = ds.state_dict()
    ds2 = tfluid.QueueDataset()
    ds2.set_batch_size(16)
    ds2.set_thread(1)
    ds2.set_filelist(files)
    ds2.set_use_var(["x", "y"])
    ds2.load_state_dict(st)
    again = list(ds2.batches())
    assert st == {"samples_consumed": 32} and len(again) == 4
    for a, b in zip(again, everything[2:]):
        np.testing.assert_array_equal(a["x"], b["x"])
    ds.set_thread(2)
    assert not tfluid.reader.is_checkpointable(ds)

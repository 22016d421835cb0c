"""Dataset corpus loaders (counterpart of paddle_tpu/datasets.py; the
reference's python/paddle/dataset/ -- mnist, cifar, uci_housing, imdb,
wmt14 -- each downloads a public corpus and yields sample tuples through
`reader()` generators).  The same seeds give both packages the same
samples.

This environment has no network egress, so every loader here generates a
DETERMINISTIC SYNTHETIC corpus with the exact shapes/dtypes/ranges of the
original (seeded per corpus; train/test streams differ).  The reader
contract is identical — `paddle.dataset.mnist.train()` ports by changing
the import — and the synthetic data is honest about what it is.
"""
from __future__ import annotations

import zlib

import numpy as np


def _rng(name, train):
    # crc32, not hash(): str hashing is salted per interpreter run and the
    # corpus must be bit-identical across runs
    return np.random.RandomState(zlib.crc32(f"{name}|{bool(train)}".encode()))


class _Corpus:
    pass


class mnist(_Corpus):
    """28x28 grayscale digits in [-1, 1] + int label 0..9 (reference
    dataset/mnist.py: reader_creator over the IDX files)."""

    N_TRAIN, N_TEST = 8192, 1024

    @staticmethod
    def _reader(train):
        def reader():
            rng = _rng("mnist", train)
            n = mnist.N_TRAIN if train else mnist.N_TEST
            for _ in range(n):
                img = (rng.rand(784).astype("float32") * 2.0 - 1.0)
                label = np.int64(rng.randint(0, 10))
                yield img, label

        return reader

    train = staticmethod(lambda: mnist._reader(True))
    test = staticmethod(lambda: mnist._reader(False))


class cifar(_Corpus):
    """3x32x32 color images in [0,1] + int label (reference dataset/cifar.py)."""

    N_TRAIN, N_TEST = 4096, 512

    @staticmethod
    def _reader(train, classes):
        def reader():
            rng = _rng(f"cifar{classes}", train)
            n = cifar.N_TRAIN if train else cifar.N_TEST
            for _ in range(n):
                yield rng.rand(3 * 32 * 32).astype("float32"), np.int64(rng.randint(0, classes))

        return reader

    train10 = staticmethod(lambda: cifar._reader(True, 10))
    test10 = staticmethod(lambda: cifar._reader(False, 10))
    train100 = staticmethod(lambda: cifar._reader(True, 100))
    test100 = staticmethod(lambda: cifar._reader(False, 100))


class uci_housing(_Corpus):
    """13 features + scalar price, feature-normalized (reference
    dataset/uci_housing.py) — synthetic linear-plus-noise task so fit_a_line
    style models actually converge."""

    W = None

    @staticmethod
    def _reader(train):
        def reader():
            rng = _rng("uci", train)
            w = np.linspace(-1, 1, 13).astype("float32")
            n = 404 if train else 102
            for _ in range(n):
                x = rng.randn(13).astype("float32")
                y = np.float32(x @ w + 0.1 * rng.randn())
                yield x, y

        return reader

    train = staticmethod(lambda: uci_housing._reader(True))
    test = staticmethod(lambda: uci_housing._reader(False))


class imdb(_Corpus):
    """Word-id sequences + binary sentiment (reference dataset/imdb.py);
    label correlates with the id distribution so classifiers can learn."""

    @staticmethod
    def _reader(train, word_dict_size=5000):
        def reader():
            rng = _rng("imdb", train)
            n = 2048 if train else 256
            for _ in range(n):
                label = rng.randint(0, 2)
                length = rng.randint(8, 64)
                lo, hi = (0, word_dict_size // 2) if label else (word_dict_size // 2, word_dict_size)
                ids = rng.randint(lo, hi, size=length).astype("int64")
                yield ids, np.int64(label)

        return reader

    train = staticmethod(lambda w=5000: imdb._reader(True, w))
    test = staticmethod(lambda w=5000: imdb._reader(False, w))

    @staticmethod
    def word_dict(size=5000):
        return {f"w{i}": i for i in range(size)}


class wmt14(_Corpus):
    """(src_ids, trg_ids, trg_next_ids) translation triples (reference
    dataset/wmt14.py)."""

    @staticmethod
    def _reader(train, dict_size=1000):
        def reader():
            rng = _rng("wmt14", train)
            n = 1024 if train else 128
            bos, eos = 0, 1
            for _ in range(n):
                ls = rng.randint(4, 20)
                lt = rng.randint(4, 20)
                src = rng.randint(2, dict_size, size=ls).astype("int64")
                trg = rng.randint(2, dict_size, size=lt).astype("int64")
                yield src, np.concatenate([[bos], trg]), np.concatenate([trg, [eos]])

        return reader

    train = staticmethod(lambda d=1000: wmt14._reader(True, d))
    test = staticmethod(lambda d=1000: wmt14._reader(False, d))

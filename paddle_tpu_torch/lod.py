"""Ragged (LoD) batches (counterpart of paddle_tpu/lod.py).

A ragged variable `x` (lod_level >= 1) is two tensors inside a program:
`x`, padded to [batch, T, *feature], and `x@LOD`, the int32 valid length of
each row.  The executor fills both when it is fed a `LoDTensor` (or a list
of per-sequence arrays); the sequence ops take the lengths as an explicit
input slot and mask.  T is bucketed exactly as in the JAX package: a
multiple of 8 up to 64, then the next power of two.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

LOD_SUFFIX = "@LOD"

_BUCKET_MULTIPLE = 8
_POW2_FROM = 64


def bucket_length(n: int) -> int:
    """Smallest bucketed length >= n."""
    n = max(int(n), 1)
    if n <= _POW2_FROM:
        return -(-n // _BUCKET_MULTIPLE) * _BUCKET_MULTIPLE
    b = _POW2_FROM
    while b < n:
        b *= 2
    return b


def lod_var_name(name: str) -> str:
    return name + LOD_SUFFIX


class LoDTensor:
    """Host-side ragged batch: a list of per-sequence numpy arrays, each
    [len_i, *feature]."""

    def __init__(self, sequences: Sequence[np.ndarray], dtype=None):
        seqs = [np.asarray(s) for s in sequences]
        if not seqs:
            raise ValueError("LoDTensor needs at least one sequence")
        feat = seqs[0].shape[1:]
        for s in seqs:
            if s.shape[1:] != feat:
                raise ValueError(
                    f"ragged sequences must share feature dims: {s.shape[1:]} vs {feat}")
        if dtype is not None:
            seqs = [s.astype(dtype) for s in seqs]
        self.sequences = seqs

    def lod(self):
        """Offset-style LoD table [[0, l1, l1+l2, ...]]."""
        return [np.concatenate([[0], np.cumsum(self.lengths)]).tolist()]

    def recursive_sequence_lengths(self) -> List[List[int]]:
        return [self.lengths.tolist()]

    def set_lod(self, lod):
        """Re-segment the flat payload by an offset table [[0, l1, l1+l2, ...]]."""
        flat = np.concatenate(self.sequences, axis=0)
        offs = lod[0]
        self.sequences = [flat[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]

    def set_recursive_sequence_lengths(self, lengths):
        """Re-segment the flat payload by lengths [[l1, l2, ...]]."""
        flat = np.concatenate(self.sequences, axis=0)
        out, pos = [], 0
        for ln in lengths[0]:
            out.append(flat[pos:pos + ln])
            pos += ln
        self.sequences = out

    def has_valid_recursive_sequence_lengths(self) -> bool:
        """At least one sequence, all with the same feature dims."""
        if not self.sequences:
            return False
        feat = self.sequences[0].shape[1:]
        return all(s.shape[1:] == feat for s in self.sequences)

    def shape(self):
        return (int(self.lengths.sum()),) + tuple(self.sequences[0].shape[1:])

    def __len__(self):
        return len(self.sequences)

    @property
    def lengths(self) -> np.ndarray:
        return np.array([len(s) for s in self.sequences], dtype=np.int32)

    @property
    def dtype(self):
        return self.sequences[0].dtype

    def padded(self, bucket: Union[bool, int] = True):
        """(padded [b, T, *f], lengths [b] int32): T is bucket_length of the
        longest sequence (bucket=True), exactly the longest (False), or the
        given int."""
        lens = self.lengths
        max_len = int(lens.max())
        if bucket is True:
            T = bucket_length(max_len)
        elif bucket is False:
            T = max_len
        else:
            T = int(bucket)
            if T < max_len:
                raise ValueError(f"bucket {T} < longest sequence {max_len}")
        out = np.zeros((len(self.sequences), T) + self.sequences[0].shape[1:], dtype=self.dtype)
        for i, s in enumerate(self.sequences):
            out[i, :len(s)] = s
        return out, lens

    @staticmethod
    def from_padded(padded: np.ndarray, lengths: Sequence[int]) -> "LoDTensor":
        return LoDTensor([padded[i, :int(n)] for i, n in enumerate(lengths)])

    def __repr__(self):
        return f"LoDTensor(batch={len(self)}, lengths={self.lengths.tolist()})"


def create_lod_tensor(data, recursive_seq_lens, place=None) -> LoDTensor:
    """A ragged batch from a list of sequences, or from a flat array and its
    length-based LoD (the last level: outer levels flatten)."""
    if isinstance(data, LoDTensor):
        return data
    if isinstance(data, (list, tuple)) and not isinstance(data[0], (int, float)):
        arrs = [np.asarray(s) for s in data]
        if all(a.ndim >= 1 for a in arrs):
            return LoDTensor(arrs)
    flat = np.asarray(data)
    lens = [int(n) for n in recursive_seq_lens[-1]]
    if sum(lens) != flat.shape[0]:
        raise ValueError(f"sum of seq lens {sum(lens)} != leading dim {flat.shape[0]}")
    offsets = np.cumsum([0] + lens)
    return LoDTensor([flat[a:b] for a, b in zip(offsets[:-1], offsets[1:])])


class LoDTensorArray(list):
    """A tensor array: a list of arrays (a fetched `create_array` /
    `array_write` var comes back as one)."""

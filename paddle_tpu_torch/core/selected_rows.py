"""SelectedRows: the row-slab sparse gradient (counterpart of
paddle_tpu/core/selected_rows.py).

An `is_sparse=True` embedding table's gradient is the rows its lookups read
and one gradient row each: `rows` int32 [N] (ids may repeat), `values`
[N, D], and the table's row count `height`.  No dense V x D gradient ever
exists; the update ops (ops/optimizer_ops.py) read and write only the
touched rows.  Eager torch allows dynamic shapes, so `merged()` returns
exactly the unique rows, without the JAX package's sentinel slots.
"""
from __future__ import annotations

import numpy as np
import torch

from .dtypes import to_numpy


class SelectedRows:
    """rows: [N] int32 row ids (may repeat; ids equal to height are dropped
    by `to_dense`); values: [N, D] gradient rows; height: the table's rows."""

    def __init__(self, rows: torch.Tensor, values: torch.Tensor, height: int):
        self.rows = rows
        self.values = values
        self.height = int(height)

    @property
    def shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    def merged(self) -> "SelectedRows":
        """Sum the values of repeated rows (the reference's MergeAdd): a
        stable sort by row id, then each run of one id summed in order by
        `torch.segment_reduce`.  Which value adds to which, and in what
        order, follows from the ids alone: no float atomics, so the result
        is bitwise repeatable on the card."""
        if self.rows.numel() == 0:
            return self
        rows, order = torch.sort(self.rows, stable=True)
        uniq, counts = torch.unique_consecutive(rows, return_counts=True)
        summed = torch.segment_reduce(self.values[order], "sum", lengths=counts, axis=0,
                                      unsafe=True)
        return SelectedRows(uniq.to(torch.int32), summed, self.height)

    def to_dense(self) -> torch.Tensor:
        """The dense [height, D] gradient: repeated rows summed (merged),
        rows equal to height dropped, every other row 0."""
        m = self.merged()
        keep = m.rows < self.height
        dense = torch.zeros(self.shape, dtype=self.values.dtype, device=self.values.device)
        return dense.index_copy_(0, m.rows[keep].long(), m.values[keep])

    def numpy(self) -> np.ndarray:
        """The dense view as numpy, as `np.asarray` gives it in the JAX package."""
        return to_numpy(self.to_dense())

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, nnz={self.rows.shape[0]}, "
                f"d={tuple(self.values.shape[1:])})")

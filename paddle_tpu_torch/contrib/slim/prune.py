"""Pruning (counterpart of paddle_tpu/contrib/slim/prune.py): the
reference's group selection (StructurePruner.cal_pruned_idx over l1_norm
groups) and a mask-based prune-retrain loop over the Program:
`prune_parameters` zeroes the selected groups in the scope and returns the
masks, and `apply_masks` re-applies them after each optimizer step, so that
retraining keeps the pruned structure.  Physically dropping the groups
(`prune_tensor(lazy=False)`) is a deploy-time transform.

The math runs in numpy on host copies of the weights (`core.dtypes.to_numpy`),
as in the JAX package; each pruned weight goes back into the scope as a new
tensor on its device, in its dtype."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ...core.dtypes import to_numpy
from .quantization import put_like


class Pruner:
    """reference prune/pruner.py Pruner base."""

    def prune(self, param):
        raise NotImplementedError


class StructurePruner(Pruner):
    """Groups a parameter along `pruning_axis` and ranks the groups by
    `criterions` (l1_norm)."""

    def __init__(self, pruning_axis: Optional[Dict[str, int]] = None,
                 criterions: Optional[Dict[str, str]] = None):
        self.pruning_axis = pruning_axis or {"*": 0}
        self.criterions = criterions or {"*": "l1_norm"}

    def _lookup(self, table, name):
        return table.get(name, table.get("*"))

    def cal_pruned_idx(self, name, param, ratio, axis=None):
        """The indices of the lowest-l1 groups on `axis` that make up
        `ratio` of them."""
        if axis is None:
            axis = self._lookup(self.pruning_axis, name)
        criterion = self._lookup(self.criterions, name)
        if criterion != "l1_norm":
            raise ValueError(f"StructurePruner: unsupported criterion {criterion!r}")
        prune_num = int(round(param.shape[axis] * ratio))
        reduce_axes = tuple(i for i in range(param.ndim) if i != axis)
        scores = np.sum(np.abs(param), axis=reduce_axes)
        return np.argsort(scores)[:prune_num]

    def prune_tensor(self, tensor, pruned_idx, pruned_axis, lazy=False):
        """lazy=True zeroes the groups, lazy=False drops them (the shape
        shrinks)."""
        if lazy:
            out = np.array(tensor)
            sl = [slice(None)] * out.ndim
            sl[pruned_axis] = pruned_idx
            out[tuple(sl)] = 0.0
            return out
        return np.delete(tensor, pruned_idx, axis=pruned_axis)


def prune_parameters(program, scope, params, ratios, pruner: Optional[StructurePruner] = None):
    """Magnitude-prune the named parameters in the scope (mask mode) and
    return {param_name: mask} for retraining."""
    pruner = pruner or StructurePruner()
    masks = {}
    for name, ratio in zip(params, ratios):
        old = scope.find_var(name)
        w = to_numpy(old)
        axis = pruner._lookup(pruner.pruning_axis, name)
        idx = pruner.cal_pruned_idx(name, w, ratio, axis=axis)
        pruned = pruner.prune_tensor(w, idx, axis, lazy=True)
        mask = np.ones_like(w)
        sl = [slice(None)] * w.ndim
        sl[axis] = idx
        mask[tuple(sl)] = 0.0
        put_like(scope, name, pruned.astype(w.dtype), old)
        masks[name] = mask
    return masks


def apply_masks(scope, masks):
    """Re-zero the pruned groups (after each optimizer step, so that
    retraining keeps the pruned structure)."""
    for name, mask in masks.items():
        old = scope.find_var(name)
        w = to_numpy(old)
        put_like(scope, name, (w * mask).astype(w.dtype), old)


def sparsity(scope, masks):
    """The share of masked-out weights across the pruned parameters."""
    zeros = total = 0
    for name, mask in masks.items():
        zeros += int((mask == 0).sum())
        total += mask.size
    return zeros / max(total, 1)

"""Eager forms of 20 stateless fluid.layers functions (counterpart of
paddle_tpu/dygraph/functional.py).  Inside a `dygraph.guard()`,
`fluid.layers.<name>` dispatches here (layers/__init__.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..ops.common import canon_dtype
from .base import VarBase, _apply, promote


def _v(x):
    return x if isinstance(x, VarBase) else VarBase(x, stop_gradient=True)


def _axes(dim):
    return None if dim is None else tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)


def mean(x, **kw):
    return _apply("mean", lambda v: torch.mean(v).reshape((1,)), _v(x))


def relu(x, **kw):
    return _apply("relu", torch.relu, _v(x))


def sigmoid(x, **kw):
    return _apply("sigmoid", torch.sigmoid, _v(x))


def tanh(x, **kw):
    return _apply("tanh", torch.tanh, _v(x))


def sqrt(x, **kw):
    return _apply("sqrt", torch.sqrt, _v(x))


def square(x, **kw):
    return _apply("square", torch.square, _v(x))


def exp(x, **kw):
    return _apply("exp", torch.exp, _v(x))


def log(x, **kw):
    return _apply("log", torch.log, _v(x))


def softmax(x, axis=-1, **kw):
    return _apply("softmax", lambda v: torch.softmax(v, dim=axis), _v(x))


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, **kw):
    def fn(a, b):
        if transpose_x:
            a = torch.swapaxes(a, -1, -2)
        if transpose_y:
            b = torch.swapaxes(b, -1, -2)
        return torch.matmul(*promote(a, b)) * alpha

    return _apply("matmul", fn, _v(x), _v(y))


def reshape(x, shape, **kw):
    def fn(v):
        out_shape = [v.shape[i] if s == 0 else s for i, s in enumerate(shape)]
        return torch.reshape(v, out_shape)

    return _apply("reshape", fn, _v(x))


def transpose(x, perm, **kw):
    return _apply("transpose", lambda v: v.permute(*perm), _v(x))


def concat(xs, axis=0, **kw):
    vars_ = [_v(x) for x in xs]
    return _apply("concat", lambda *vs: torch.cat(vs, dim=axis), *vars_)


def _reduced(out, v):
    # jnp keeps an integer sum in the input's width, and x32 caps it at 32 bits
    return out if out.is_floating_point() else out.to(canon_dtype(v.dtype))


def reduce_sum(x, dim=None, keep_dim=False, **kw):
    axes = _axes(dim)

    def fn(v):
        out = torch.sum(v) if axes is None else torch.sum(v, dim=axes, keepdim=keep_dim)
        return _reduced(out, v)

    return _apply("reduce_sum", fn, _v(x))


def reduce_mean(x, dim=None, keep_dim=False, **kw):
    axes = _axes(dim)

    def fn(v):
        v = v if v.is_floating_point() else v.float()
        return torch.mean(v) if axes is None else torch.mean(v, dim=axes, keepdim=keep_dim)

    return _apply("reduce_mean", fn, _v(x))


def square_error_cost(input, label, **kw):
    return _apply("square_error_cost", lambda a, b: torch.square(a - b), _v(input), _v(label))


def _label_index(idx, x, ignore_index):
    """The label as a gather index of x's rank, and that index with the
    ignored label at 0 (the JAX package gathers a fill there, which its
    `where` then drops)."""
    if idx.ndim != x.ndim or idx.shape[-1] != 1:
        idx = idx[..., None]
    return idx, torch.where(idx == ignore_index, 0, idx).long()


def cross_entropy(input, label, soft_label=False, ignore_index=-100, **kw):
    lbl = _v(label)

    def fn(x):
        if soft_label:
            return -torch.sum(lbl.value * torch.log(torch.clamp_min(x, 1e-20)), dim=-1,
                              keepdim=True)
        idx, at = _label_index(lbl.value, x, ignore_index)
        picked = torch.gather(x, -1, at)
        loss = -torch.log(torch.clamp_min(picked, 1e-20))
        return torch.where(idx == ignore_index, 0.0, loss)

    return _apply("cross_entropy", fn, _v(input))


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                               return_softmax=False, **kw):
    lbl = _v(label)

    def fn(x):
        logp = torch.log_softmax(x, dim=-1)
        if soft_label:
            return -torch.sum(lbl.value * logp, dim=-1, keepdim=True)
        idx, at = _label_index(lbl.value, x, ignore_index)
        picked = torch.gather(logp, -1, at)
        return torch.where(idx == ignore_index, 0.0, -picked)

    loss = _apply("softmax_with_cross_entropy", fn, _v(logits))
    if return_softmax:
        sm = softmax(logits)
        return loss, sm
    return loss


def accuracy(input, label, k=1, **kw):
    x = _v(input)
    lab = _v(label)
    _, idx = torch.topk(x.value, k)
    correct = (idx == lab.value.to(idx.dtype)).any(dim=-1)
    return VarBase(torch.mean(correct.float()).reshape((1,)), stop_gradient=True)


def dropout(x, dropout_prob, is_test=False, dropout_implementation="downgrade_in_infer", **kw):
    xv = _v(x)
    if is_test:
        if dropout_implementation == "upscale_in_train":
            return xv
        return _apply("dropout", lambda v: v * (1.0 - dropout_prob), xv)
    # numpy's global generator, as the JAX package draws the mask
    mask = torch.from_numpy((np.random.rand(*xv.shape) >= dropout_prob).astype("float32")).to(
        xv.value.device)
    if dropout_implementation == "upscale_in_train":
        return _apply("dropout", lambda v: v * mask / (1.0 - dropout_prob), xv)
    return _apply("dropout", lambda v: v * mask, xv)

"""Dygraph NN layers (counterpart of paddle_tpu/dygraph/nn.py: Conv2D,
Pool2D, FC/Linear, BatchNorm, Embedding, LayerNorm, GRUUnit, ...).

Each forward composes eager torch calls through the tape (`_apply`), on the
same math as the graph-mode op lowerings, and promotes mixed floating
inputs as jnp does (a float32 master meets a bf16 input in float32).  No
layer launches a kernel of the port's own: the JAX layers are `jnp` and
`lax` and reach no Pallas kernel.  The random draws (Dropout's masks,
NCE's negatives, SpectralNorm's u and v) come from numpy's `RandomState`s
as in the JAX package and are uploaded to the layer's device.
"""
from __future__ import annotations

from typing import Optional, Sequence  # noqa: F401

import numpy as np
import torch
import torch.nn.functional as F

from ..core.initializer import ConstantInitializer, NormalInitializer
from .base import VarBase, _apply, _tape, promote  # noqa: F401
from .layers import Layer


def _pair(v, n=2):
    return [v] * n if isinstance(v, int) else list(v)


class Linear(Layer):
    def __init__(self, input_dim, output_dim, param_attr=None, bias_attr=None,
                 act=None, dtype="float32"):
        super().__init__("linear", dtype)
        self.weight = self.create_parameter([input_dim, output_dim], attr=param_attr)
        self.bias = self.create_parameter([output_dim], attr=bias_attr, is_bias=True)
        self.act = act

    def forward(self, x):
        def fn(xv, w, b):
            xv, w = promote(xv, w)
            return xv @ w + b

        return _activation(_apply("linear", fn, x, self.weight, self.bias), self.act)


# reference dygraph/nn.py FC flattens inputs; Linear covers the common case
FC = Linear


class Conv2D(Layer):
    def __init__(self, num_channels, num_filters, filter_size, stride=1, padding=0,
                 dilation=1, groups=1, param_attr=None, bias_attr=None, act=None,
                 dtype="float32"):
        super().__init__("conv2d", dtype)
        fs = _pair(filter_size)
        self._stride = _pair(stride)
        self._padding = _pair(padding)
        self._dilation = _pair(dilation)
        self._groups = groups or 1
        fan_in = (num_channels // self._groups) * fs[0] * fs[1]
        default_init = NormalInitializer(0.0, float(np.sqrt(2.0 / fan_in)))
        self.weight = self.create_parameter(
            [num_filters, num_channels // self._groups, fs[0], fs[1]],
            attr=param_attr, default_initializer=default_init)
        self.bias = self.create_parameter([num_filters], attr=bias_attr, is_bias=True)
        self.act = act

    def forward(self, x):
        stride, padding, dilation, groups = (
            tuple(self._stride), tuple(self._padding), tuple(self._dilation), self._groups)

        def fn(xv, w, b):
            xv, w = promote(xv, w)
            out = F.conv2d(xv, w, None, stride, padding, dilation, groups)
            return out + b.reshape(1, -1, 1, 1)

        return _activation(_apply("conv2d", fn, x, self.weight, self.bias), self.act)


class Pool2D(Layer):
    """As in the JAX package, `ceil_mode` and `exclusive` are accepted and
    not used: the windows are the floor ones, and an average divides by the
    whole window, padding included."""

    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0,
                 global_pooling=False, ceil_mode=False, exclusive=True):
        super().__init__("pool2d")
        self._size = _pair(pool_size)
        self._stride = _pair(pool_stride)
        self._padding = _pair(pool_padding)
        self._type = pool_type
        self._global = global_pooling

    def forward(self, x):
        size, stride, pads, ptype, glob = (
            self._size, self._stride, self._padding, self._type, self._global)

        def fn(xv):
            ks, st, pd = size, stride, pads
            if glob:
                ks = [xv.shape[2], xv.shape[3]]
                st = [1, 1]
                pd = [0, 0]
            # lax.reduce_window pads with the reduction's identity, to any width
            pad = (pd[1], pd[1], pd[0], pd[0])
            if ptype == "max":
                return F.max_pool2d(F.pad(xv, pad, value=float("-inf")), tuple(ks), tuple(st))
            s = F.avg_pool2d(F.pad(xv, pad), tuple(ks), tuple(st))
            return s

        return _apply("pool2d", fn, x)


class BatchNorm(Layer):
    def __init__(self, num_channels, act=None, is_test=False, momentum=0.9,
                 epsilon=1e-5, param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW"):
        super().__init__("batch_norm", dtype)
        self.weight = self.create_parameter(
            [num_channels], attr=param_attr, default_initializer=ConstantInitializer(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr, is_bias=True)
        self._mean = VarBase(np.zeros([num_channels], "float32"), stop_gradient=True,
                             persistable=True)
        self._variance = VarBase(np.ones([num_channels], "float32"), stop_gradient=True,
                                 persistable=True)
        self._momentum = momentum
        self._epsilon = epsilon
        self._layout = data_layout
        self.act = act

    def forward(self, x):
        ndim = x.value.ndim
        ch_axis = 1 if self._layout == "NCHW" else ndim - 1
        axes = tuple(i for i in range(ndim) if i != ch_axis)
        bshape = [1] * ndim
        bshape[ch_axis] = x.value.shape[ch_axis]
        eps = self._epsilon

        if self.training:
            # the running statistics move outside the tape, with the biased
            # variance
            with torch.no_grad():
                mean = torch.mean(x.value, dim=axes)
                var = torch.var(x.value, dim=axes, unbiased=False)
                self._mean.value = (self._momentum * self._mean.value
                                    + (1 - self._momentum) * mean)
                self._variance.value = (self._momentum * self._variance.value
                                        + (1 - self._momentum) * var)

            def fn(xv, scale, bias):
                m = torch.mean(xv, dim=axes)
                v = torch.var(xv, dim=axes, unbiased=False)
                inv = torch.rsqrt(v.reshape(bshape) + eps)
                return ((xv - m.reshape(bshape)) * inv * scale.reshape(bshape)
                        + bias.reshape(bshape))
        else:
            m_const = self._mean.value
            v_const = self._variance.value

            def fn(xv, scale, bias):
                inv = torch.rsqrt(v_const.reshape(bshape) + eps)
                return ((xv - m_const.reshape(bshape)) * inv * scale.reshape(bshape)
                        + bias.reshape(bshape))

        return _activation(_apply("batch_norm", fn, x, self.weight, self.bias), self.act)


class Embedding(Layer):
    def __init__(self, size, is_sparse=False, padding_idx=None, param_attr=None,
                 dtype="float32"):
        super().__init__("embedding", dtype)
        self.weight = self.create_parameter(list(size), attr=param_attr)
        self._padding_idx = padding_idx
        self._size = size

    def forward(self, ids):
        pad = self._padding_idx
        V = self._size[0]

        def fn(idv, w):
            flat = idv.reshape(idv.shape[:-1]) if idv.ndim and idv.shape[-1] == 1 else idv
            out = torch.index_select(w, 0, flat.reshape(-1).long()).reshape(
                tuple(flat.shape) + (w.shape[1],))
            if pad is not None:
                rp = pad if pad >= 0 else V + pad
                out = torch.where((flat == rp)[..., None], 0.0, out)
            return out

        return _apply("embedding", fn, ids, self.weight)


class LayerNorm(Layer):
    def __init__(self, normalized_shape, scale=True, shift=True, epsilon=1e-5,
                 param_attr=None, bias_attr=None, act=None, dtype="float32"):
        super().__init__("layer_norm", dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        n = int(np.prod(normalized_shape))
        self._shape = list(normalized_shape)
        self.weight = self.create_parameter(
            [n], attr=param_attr, default_initializer=ConstantInitializer(1.0)) if scale else None
        self.bias = self.create_parameter([n], attr=bias_attr, is_bias=True) if shift else None
        self._epsilon = epsilon
        self.act = act

    def forward(self, x):
        eps = self._epsilon
        norm_rank = len(self._shape)
        has_w, has_b = self.weight is not None, self.bias is not None

        def fn(xv, *wb):
            axes = tuple(range(xv.ndim - norm_rank, xv.ndim))
            m = torch.mean(xv, dim=axes, keepdim=True)
            v = torch.var(xv, dim=axes, unbiased=False, keepdim=True)
            y = (xv - m) * torch.rsqrt(v + eps)
            shape = (1,) * (xv.ndim - norm_rank) + tuple(xv.shape[xv.ndim - norm_rank:])
            i = 0
            if has_w:
                y = y * wb[i].reshape(shape)
                i += 1
            if has_b:
                y = y + wb[i].reshape(shape)
            return y

        args = [a for a in (self.weight, self.bias) if a is not None]
        return _activation(_apply("layer_norm", fn, x, *args), self.act)


class Dropout(Layer):
    def __init__(self, p=0.5):
        super().__init__("dropout")
        self._p = p
        self._rng = np.random.RandomState(0)

    def forward(self, x):
        if not self.training or self._p == 0:
            return x
        p = self._p
        mask = torch.from_numpy((self._rng.rand(*x.shape) >= p).astype(np.float32)).to(
            x.value.device)

        def fn(xv):
            return xv * mask / (1.0 - p)

        return _apply("dropout", fn, x)


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softmax": lambda v: torch.softmax(v, dim=-1),
    "gelu": lambda v: F.gelu(v, approximate="none"),
    "leaky_relu": lambda v: F.leaky_relu(v, negative_slope=0.02),
}


def _activation(x, act):
    if act is None:
        return x
    return _apply(act, _ACTIVATIONS[act], x)


class Conv2DTranspose(Layer):
    """reference dygraph/nn.py Conv2DTranspose (fluid filter layout)."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, param_attr=None, bias_attr=None, act=None,
                 dtype="float32"):
        super().__init__("conv2d_transpose", dtype)
        fs = _pair(filter_size)
        self._stride = _pair(stride)
        self._padding = _pair(padding)
        self.weight = self.create_parameter(
            [num_channels, num_filters, fs[0], fs[1]], attr=param_attr)
        self.bias = self.create_parameter([num_filters], attr=bias_attr, is_bias=True)
        self.act = act

    def forward(self, x):
        from ..ops.nn_ops import conv2d_transpose_math

        s, p = self._stride, self._padding

        def fn(xv, w, b):
            xv, w = promote(xv, w)
            return conv2d_transpose_math(xv, w, strides=s, pads=p) + b.reshape(1, -1, 1, 1)

        return _activation(_apply("conv2d_transpose", fn, x, self.weight, self.bias),
                           self.act)


class PRelu(Layer):
    """reference dygraph/nn.py PRelu (mode 'all'|'channel'|'element')."""

    def __init__(self, mode="all", channel=None, input_shape=None,
                 param_attr=None, dtype="float32"):
        super().__init__("prelu", dtype)
        self._mode = mode
        if mode == "all":
            shape = [1]
        elif mode == "channel":
            shape = [channel]
        else:
            # alpha is per element over the non-batch dims
            shape = list(input_shape)[1:]
        self.weight = self.create_parameter(
            shape, attr=param_attr, default_initializer=ConstantInitializer(0.25))

    def forward(self, x):
        mode = self._mode

        def fn(xv, a):
            if mode == "channel":
                ar = a.reshape((1, -1) + (1,) * (xv.ndim - 2))
            elif mode == "element":
                ar = a.reshape((1,) + tuple(a.shape))
            else:
                ar = a.reshape(())
            return torch.where(xv > 0, xv, ar * xv)

        return _apply("prelu", fn, x, self.weight)


class GRUUnit(Layer):
    """reference dygraph/nn.py GRUUnit: one GRU step (gate order u, r, c)."""

    def __init__(self, size, param_attr=None, bias_attr=None, dtype="float32",
                 origin_mode=False):
        super().__init__("gru_unit", dtype)
        d = size // 3
        self._d = d
        self._origin = origin_mode
        self.weight = self.create_parameter([d, 3 * d], attr=param_attr)
        self.bias = self.create_parameter([3 * d], attr=bias_attr, is_bias=True)

    def forward(self, x, hidden):
        d = self._d
        origin = self._origin

        def fn(xv, h, w, b):
            ur = torch.sigmoid(xv[:, :2 * d] + h @ w[:, :2 * d] + b[:2 * d])
            u, r = ur[:, :d], ur[:, d:]
            c = torch.tanh(xv[:, 2 * d:] + (r * h) @ w[:, 2 * d:] + b[2 * d:])
            if origin:
                hn = u * h + (1 - u) * c
            else:
                hn = (1 - u) * h + u * c
            # pack (hidden | r*h_prev) so both reference outputs come back
            return torch.cat([hn, r * h], dim=1)

        packed = _apply("gru_unit", fn, x, hidden, self.weight, self.bias)
        hn = _apply("gru_hidden", lambda pv: pv[:, :d], packed)
        reset_h = _apply("gru_reset_h", lambda pv: pv[:, d:], packed)
        return hn, reset_h, None  # gate tensor intentionally None


class GroupNorm(Layer):
    """reference dygraph/nn.py GroupNorm over group_norm_op semantics."""

    def __init__(self, channels, groups, epsilon=1e-05, param_attr=None,
                 bias_attr=None, act=None, data_layout="NCHW", dtype="float32"):
        super().__init__("group_norm", dtype)
        self._groups = groups
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [channels], attr=param_attr,
            default_initializer=ConstantInitializer(1.0))
        self.bias = self.create_parameter([channels], attr=bias_attr, is_bias=True)
        self.act = act

    def forward(self, x):
        g, eps = self._groups, self._epsilon

        def fn(xv, w, b):
            n, c = xv.shape[0], xv.shape[1]
            xf = xv.float().reshape((n, g, c // g) + tuple(xv.shape[2:]))
            axes = tuple(range(2, xf.ndim))
            m = torch.mean(xf, dim=axes, keepdim=True)
            v = torch.var(xf, dim=axes, unbiased=False, keepdim=True)
            y = ((xf - m) * torch.rsqrt(v + eps)).reshape(xv.shape)
            cshape = (1, c) + (1,) * (xv.ndim - 2)
            return (y * w.reshape(cshape) + b.reshape(cshape)).to(xv.dtype)

        return _activation(_apply("group_norm", fn, x, self.weight, self.bias),
                           self.act)


class SpectralNorm(Layer):
    """reference dygraph/nn.py SpectralNorm (spectral_norm_op.cc): weight /
    sigma with sigma from `power_iters` u-v iterations; u and v persist as
    non-trainable state, drawn by numpy's RandomState(0)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__("spectral_norm", dtype)
        from .base import current_device

        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = int(weight_shape[dim])
        w = int(np.prod(weight_shape)) // h
        rng = np.random.RandomState(0)
        device = current_device()
        self._u = torch.from_numpy(rng.randn(h).astype(dtype)).to(device)
        self._v = torch.from_numpy(rng.randn(w).astype(dtype)).to(device)

    def forward(self, weight):
        dim, iters, eps = self._dim, self._power_iters, self._eps

        # the power iteration advances outside the tape (the reference op
        # writes U and V back in place each forward, constants to the grad)
        wv = weight.value
        perm = (dim,) + tuple(i for i in range(wv.ndim) if i != dim)
        with torch.no_grad():
            mat = wv.permute(perm).reshape(wv.shape[dim], -1)
            u, v = self._u, self._v
            for _ in range(iters):
                v = mat.T @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
                u = mat @ v
                u = u / (torch.linalg.vector_norm(u) + eps)
        self._u, self._v = u, v

        def fn(w):
            m = w.permute(perm).reshape(w.shape[dim], -1)
            sigma = u @ m @ v
            return w / sigma

        return _apply("spectral_norm", fn, weight)


class BilinearTensorProduct(Layer):
    """reference dygraph/nn.py BilinearTensorProduct
    (bilinear_tensor_product_op.h): out[n, k] = x[n] W[k] y[n]^T + b."""

    def __init__(self, input1_dim, input2_dim, output_dim, name=None,
                 act=None, param_attr=None, bias_attr=None, dtype="float32"):
        super().__init__("bilinear_tensor_product", dtype)
        self.weight = self.create_parameter(
            [output_dim, input1_dim, input2_dim], attr=param_attr)
        self.bias = self.create_parameter([1, output_dim], attr=bias_attr,
                                          is_bias=True)
        self.act = act

    def forward(self, x, y):
        def fn(xv, yv, w, b):
            return torch.einsum("nd,kde,ne->nk", xv, w, yv) + b

        return _activation(
            _apply("bilinear_tensor_product", fn, x, y, self.weight, self.bias),
            self.act)


class NCE(Layer):
    """reference dygraph/nn.py NCE over nce_op.h: noise-contrastive
    estimation with uniform negatives, drawn by numpy's RandomState(seed)."""

    def __init__(self, num_total_classes, dim, sample_weight=None,
                 param_attr=None, bias_attr=None, num_neg_samples=10,
                 sampler="uniform", custom_dist=None, seed=0,
                 is_sparse=False, dtype="float32"):
        super().__init__("nce", dtype)
        if sampler != "uniform" or custom_dist is not None:
            raise NotImplementedError(
                "dygraph NCE: only the uniform sampler is wired; use the "
                "static layers.nce for log_uniform/custom_dist")
        self._num_total = num_total_classes
        self._num_neg = num_neg_samples
        self._rng = np.random.RandomState(seed or 0)
        self.weight = self.create_parameter([num_total_classes, dim],
                                            attr=param_attr)
        self.bias = self.create_parameter([num_total_classes],
                                          attr=bias_attr, is_bias=True)

    def forward(self, input, label):
        B = int(input.value.shape[0])
        negs = torch.from_numpy(self._rng.randint(
            0, self._num_total, (B, self._num_neg)).astype("int32")).to(input.value.device)
        num_neg, num_total = self._num_neg, self._num_total

        def fn(xv, lab, w, b):
            lab = lab.reshape(B, -1).to(torch.int32)
            samples = torch.cat([lab, negs], dim=1).long()
            ws = w[samples]
            logits = torch.einsum("bsd,bd->bs", ws, xv) + b[samples]
            o = torch.exp(logits)
            q = torch.full(samples.shape, 1.0 / num_total, device=xv.device)
            bb = q * num_neg
            num_true = lab.shape[1]
            true_cost = -torch.log(o[:, :num_true] / (o[:, :num_true] + bb[:, :num_true]))
            neg_cost = -torch.log(bb[:, num_true:] / (o[:, num_true:] + bb[:, num_true:]))
            return (torch.sum(true_cost, dim=1) + torch.sum(neg_cost, dim=1)).reshape(B, 1)

        return _apply("nce", fn, input, label, self.weight, self.bias)


class Conv3D(Layer):
    """reference dygraph/nn.py Conv3D (conv_op.cc conv3d)."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__("conv3d", dtype)
        fs = _pair(filter_size, 3)
        self._stride = _pair(stride, 3)
        self._padding = _pair(padding, 3)
        self._dilation = _pair(dilation, 3)
        self._groups = groups or 1
        fan_in = (num_channels // self._groups) * int(np.prod(fs))
        self.weight = self.create_parameter(
            [num_filters, num_channels // self._groups] + fs, attr=param_attr,
            default_initializer=NormalInitializer(0.0, float(np.sqrt(2.0 / fan_in))))
        self.bias = self.create_parameter([num_filters], attr=bias_attr, is_bias=True)
        self.act = act

    def forward(self, x):
        s, p, d, g = (tuple(self._stride), tuple(self._padding),
                      tuple(self._dilation), self._groups)

        def fn(xv, w, b):
            xv, w = promote(xv, w)
            return F.conv3d(xv, w, None, s, p, d, g) + b.reshape(1, -1, 1, 1, 1)

        return _activation(_apply("conv3d", fn, x, self.weight, self.bias), self.act)


class Conv3DTranspose(Layer):
    """reference dygraph/nn.py Conv3DTranspose (fluid filter layout)."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, param_attr=None, bias_attr=None, act=None,
                 dtype="float32"):
        super().__init__("conv3d_transpose", dtype)
        fs = _pair(filter_size, 3)
        self._stride = _pair(stride, 3)
        self._padding = _pair(padding, 3)
        self.weight = self.create_parameter(
            [num_channels, num_filters] + fs, attr=param_attr)
        self.bias = self.create_parameter([num_filters], attr=bias_attr, is_bias=True)
        self.act = act

    def forward(self, x):
        from ..ops.nn_ops import conv3d_transpose_math

        s, p = self._stride, self._padding

        def fn(xv, w, b):
            xv, w = promote(xv, w)
            return conv3d_transpose_math(xv, w, strides=s, pads=p) + b.reshape(1, -1, 1, 1, 1)

        return _activation(_apply("conv3d_transpose", fn, x, self.weight, self.bias),
                           self.act)


class TreeConv(Layer):
    """reference dygraph/nn.py TreeConv: TBCNN tree convolution (the
    tree_conv op's math, ops.misc_ops.tree_conv_math, a tree at a time)."""

    def __init__(self, feature_size, output_size, num_filters=1, max_depth=2,
                 act="tanh", param_attr=None, bias_attr=None, name=None,
                 dtype="float32"):
        super().__init__(name or "tree_conv", dtype)
        self._max_depth = max_depth
        self._act = act
        self.weight = self.create_parameter(
            [feature_size, 3, output_size, num_filters], attr=param_attr)
        self.bias = (self.create_parameter([num_filters], attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, nodes_vector, edge_set):
        from ..ops.misc_ops import tree_conv_math

        md = self._max_depth

        def fn(nv, es, w, *b):
            out = torch.stack([tree_conv_math(nv[i], es[i].to(torch.int32), w, md)
                               for i in range(nv.shape[0])])
            if b:
                out = out + b[0]
            return out

        args = [nodes_vector, edge_set, self.weight]
        if self.bias is not None:
            args.append(self.bias)
        return _activation(_apply("tree_conv", fn, *args), self._act)

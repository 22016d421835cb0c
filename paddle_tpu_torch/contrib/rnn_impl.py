"""contrib.layers.rnn_impl basic RNN cells (counterpart of
paddle_tpu/contrib/rnn_impl.py; reference
python/paddle/fluid/contrib/layers/rnn_impl.py BasicLSTMUnit/BasicGRUUnit):
dygraph Layers holding one step's parameters, made at the first call from
the input's width."""
from __future__ import annotations

import torch

from ..dygraph.base import _apply, promote
from ..dygraph.layers import Layer


class BasicLSTMUnit(Layer):
    """reference rnn_impl.BasicLSTMUnit: gates = [x, h] @ W + b with
    (i, j, f, o) gate order and a forget-gate bias."""

    def __init__(self, name_scope, hidden_size, param_attr=None,
                 bias_attr=None, gate_activation=None, activation=None,
                 forget_bias=1.0, dtype="float32"):
        super().__init__(name_scope or "basic_lstm_unit", dtype)
        self._hidden = hidden_size
        self._forget_bias = forget_bias
        self._input_size = None
        self._param_attr = param_attr
        self._bias_attr = bias_attr

    def _build_once(self, input_size):
        self.weight = self.create_parameter(
            [input_size + self._hidden, 4 * self._hidden],
            attr=self._param_attr)
        self.bias = self.create_parameter([4 * self._hidden],
                                          attr=self._bias_attr, is_bias=True)
        self._input_size = input_size

    def forward(self, input, pre_hidden, pre_cell):
        if self._input_size is None:
            self._build_once(int(input.value.shape[-1]))
        d, fb = self._hidden, self._forget_bias

        def fn(x, h, c, w, b):
            xh, w = promote(torch.cat([x, h], dim=1), w)
            gates = xh @ w + b
            i, j, f, o = (gates[:, :d], gates[:, d:2 * d],
                          gates[:, 2 * d:3 * d], gates[:, 3 * d:])
            new_c = c * torch.sigmoid(f + fb) + torch.sigmoid(i) * torch.tanh(j)
            new_h = torch.tanh(new_c) * torch.sigmoid(o)
            return torch.cat([new_h, new_c], dim=1)

        packed = _apply("basic_lstm_unit", fn, input, pre_hidden, pre_cell,
                        self.weight, self.bias)
        h = _apply("lstm_h", lambda pv: pv[:, :d], packed)
        c = _apply("lstm_c", lambda pv: pv[:, d:], packed)
        return h, c


class BasicGRUUnit(Layer):
    """reference rnn_impl.BasicGRUUnit: two fused gate matmuls (u, r) plus
    the candidate projection."""

    def __init__(self, name_scope, hidden_size, param_attr=None,
                 bias_attr=None, gate_activation=None, activation=None,
                 dtype="float32"):
        super().__init__(name_scope or "basic_gru_unit", dtype)
        self._hidden = hidden_size
        self._input_size = None
        self._param_attr = param_attr
        self._bias_attr = bias_attr

    def _build_once(self, input_size):
        d = self._hidden
        self.gate_weight = self.create_parameter([input_size + d, 2 * d],
                                                 attr=self._param_attr)
        self.gate_bias = self.create_parameter([2 * d], attr=self._bias_attr,
                                               is_bias=True)
        self.candidate_weight = self.create_parameter([input_size + d, d],
                                                      attr=self._param_attr)
        self.candidate_bias = self.create_parameter([d], attr=self._bias_attr,
                                                    is_bias=True)
        self._input_size = input_size

    def forward(self, input, pre_hidden):
        if self._input_size is None:
            self._build_once(int(input.value.shape[-1]))
        d = self._hidden

        def fn(x, h, gw, gb, cw, cb):
            xh, gw = promote(torch.cat([x, h], dim=1), gw)
            gates = torch.sigmoid(xh @ gw + gb)
            u, r = gates[:, :d], gates[:, d:]
            xrh, cw = promote(torch.cat([x, r * h], dim=1), cw)
            cand = torch.tanh(xrh @ cw + cb)
            return u * h + (1 - u) * cand

        return _apply("basic_gru_unit", fn, input, pre_hidden,
                      self.gate_weight, self.gate_bias,
                      self.candidate_weight, self.candidate_bias)

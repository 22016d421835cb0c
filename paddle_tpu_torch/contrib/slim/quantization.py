"""Quantization (counterpart of paddle_tpu/contrib/slim/quantization.py):
the QAT pass that puts fake-quantize ops on the weights and activations of
conv / mul / matmul, post-training weight quantization, and the freeze that
strips the fake-quantize ops for deployment.

What slim owns is the program rewrite and the weights' int8 grid.  Neither
package runs an int8 product: a quantized model is int8 on disk
(`io.save_quantized_inference_model`), dequantized into its serve dtype at
load, and runs in float on values that lie on the int8 grid.

The grid is computed in numpy on host copies of the weights
(`core.dtypes.to_numpy`: a bf16 weight is an ml_dtypes array), in the JAX
package's expressions and order, so that both packages snap a weight to the
same bits.  A snapped weight goes back into the scope as a new tensor on the
old one's device, in its dtype: the old tensor is never written, since
`io.save_quantized_inference_model` restores its snapshot by reference.

The fake-quantize ops' inference rules and cost rules are registered here,
as in the JAX package, so that `check_program` sees a QAT program and the
resource planner prices it (core/resource_plan.py)."""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from ...core import analysis as _A
from ...core import resource_plan as _RP
from ...core.dtypes import to_numpy, to_tensor
from ...core.program import Operator, Parameter

QUANTIZABLE = ("conv2d", "depthwise_conv2d", "mul", "matmul")
# the weight slot and the activation slot of each quantizable op type
WEIGHT_SLOT = {"conv2d": "Filter", "depthwise_conv2d": "Filter",
               "mul": "Y", "matmul": "Y"}
ACT_SLOT = {"conv2d": "Input", "depthwise_conv2d": "Input",
            "mul": "X", "matmul": "X"}


def put_like(scope, name: str, arr: np.ndarray, old) -> None:
    """Set `name` to the host array `arr` as a new tensor on `old`'s device
    (a numpy array where `old` is one)."""
    if isinstance(old, torch.Tensor):
        scope.set_var(name, to_tensor(arr, None, old.device))
    else:
        scope.set_var(name, arr)


def quant_aware(program, weight_bits: int = 8, activation_bits: int = 8,
                quantizable_op_types: Optional[Iterable[str]] = None,
                quantize_activations: bool = True,
                weight_quantize_type: str = "abs_max"):
    """QAT instrumentation: a fake-quantize op on each quantizable op's
    weight (a shared weight quantized once; `weight_quantize_type`
    "abs_max" or "channel_wise_abs_max") and, with `quantize_activations`,
    fake_quantize_abs_max on its activation input (a shared activation
    quantized once).  Returns the count of fake-quantize ops inserted."""
    targets = tuple(quantizable_op_types or QUANTIZABLE)
    block = program.global_block()
    n = 0
    new_ops = []
    quantized_weights = {}  # a shared weight -> its @QUANT name
    quantized_acts = {}  # a shared activation -> its @QUANT name

    if weight_quantize_type not in ("abs_max", "channel_wise_abs_max"):
        raise ValueError(f"quant_aware: unknown weight_quantize_type "
                         f"{weight_quantize_type!r}")
    w_op_type = ("fake_channel_wise_quantize_abs_max"
                 if weight_quantize_type == "channel_wise_abs_max"
                 else "fake_quantize_abs_max")

    def make_qop(src, bits, op_type="fake_quantize_abs_max", quant_axis=0):
        qname = f"{src}@QUANT"
        sname = f"{src}@QSCALE"
        v = block._find_var_recursive(src)
        block.create_var(qname, shape=getattr(v, "shape", None),
                         dtype=getattr(v, "dtype", "float32"))
        block.create_var(sname, dtype="float32")
        return qname, Operator(block, op_type, {"X": [src]},
                               {"Out": [qname], "OutScale": [sname]},
                               {"bit_length": bits, "quant_axis": quant_axis})

    for op in block.ops:
        if op.type in targets:
            wnames = op.inputs.get(WEIGHT_SLOT[op.type], [])
            if wnames:
                wname = wnames[0]
                if wname in quantized_weights:
                    op.inputs[WEIGHT_SLOT[op.type]] = [quantized_weights[wname]]
                elif isinstance(block._find_var_recursive(wname), Parameter):
                    # the output-channel axis: conv filters are [O, I, kh, kw]
                    # (0), mul / matmul Y weights [in, out] (1)
                    qaxis = 1 if op.type in ("mul", "matmul") else 0
                    qname, qop = make_qop(wname, weight_bits, w_op_type, qaxis)
                    new_ops.append(qop)
                    quantized_weights[wname] = qname
                    op.inputs[WEIGHT_SLOT[op.type]] = [qname]
                    n += 1
            if quantize_activations:
                anames = op.inputs.get(ACT_SLOT[op.type], [])
                if anames:
                    aname = anames[0]
                    # two consumers of one activation share one op: a second
                    # would be a second writer of the @QUANT var
                    if aname not in quantized_acts:
                        qname, qop = make_qop(aname, activation_bits)
                        new_ops.append(qop)
                        quantized_acts[aname] = qname
                        n += 1
                    op.inputs[ACT_SLOT[op.type]] = [quantized_acts[aname]]
        new_ops.append(op)
    block.ops = new_ops
    program._bump()
    return n


def post_training_quantize(scope, program, weight_bits: int = 8):
    """PTQ: snap every parameter of a quantizable op to a per-tensor
    symmetric weight_bits grid in the scope (the program runs unchanged on
    the dequantized values).  Returns {param_name: scale}."""
    qmax = float(2 ** (weight_bits - 1) - 1)
    scales = {}
    block = program.global_block()
    for op in block.ops:
        slot = WEIGHT_SLOT.get(op.type)
        if slot is None:
            continue
        for wname in op.inputs.get(slot, []):
            wvar = block._find_var_recursive(wname)
            if not isinstance(wvar, Parameter) or wname in scales:
                continue
            old = scope.find_var(wname)
            w = to_numpy(old)
            scale = float(np.max(np.abs(w))) or 1e-8
            q = np.round(w / scale * qmax)
            put_like(scope, wname, (q * scale / qmax).astype(w.dtype), old)
            scales[wname] = scale
    return scales


def convert_quant_model(program, scope=None, weight_bits: int = 8):
    """Freeze a QAT program for deployment: strip the fake-quantize ops,
    map every @QUANT input back to its source var and, with a scope, snap
    each quantized weight to its int8 grid (per tensor, or per channel
    along its quant_axis), so that the float program computes what int8
    storage holds.  Returns {"weights": {name: {"scale", "axis"}},
    "activations": {name: bits}}, the scale manifest that
    io.save_quantized_inference_model stores."""
    qmax = float(2 ** (weight_bits - 1) - 1)
    block = program.global_block()
    fake_types = ("fake_quantize_abs_max", "fake_channel_wise_quantize_abs_max")
    remap = {}  # "@QUANT" name -> its source
    weight_src = {}  # source weight -> quant_axis (None: per tensor)
    act_bits = {}  # source activation -> its op's bit_length
    for op in block.ops:
        if op.type in fake_types:
            src = op.inputs["X"][0]
            remap[op.outputs["Out"][0]] = src
            v = block._find_var_recursive(src)
            if isinstance(v, Parameter):
                weight_src[src] = (op.attrs.get("quant_axis", 0)
                                   if op.type == "fake_channel_wise_quantize_abs_max"
                                   else None)
            else:
                act_bits[src] = int(op.attrs.get("bit_length", 8))
    if not remap:
        return {"weights": {}, "activations": {}}
    block.ops = [op for op in block.ops if op.type not in fake_types]
    for op in block.ops:
        for slot, names in op.inputs.items():
            op.inputs[slot] = [remap.get(n, n) for n in names]
    program._bump()

    weight_scales = {}
    if scope is not None:
        for wname, qaxis in weight_src.items():
            old = scope.find_var(wname)
            w = to_numpy(old)
            if qaxis is None:
                scale = np.asarray(np.max(np.abs(w)) or 1e-8, np.float32)
            else:
                red = tuple(i for i in range(w.ndim) if i != qaxis)
                scale = np.maximum(np.abs(w).max(axis=red), 1e-8).astype(np.float32)
                shp = [1] * w.ndim
                shp[qaxis] = -1
                scale = scale.reshape(shp)
            q = np.clip(np.round(w / scale * qmax), -qmax - 1, qmax)
            put_like(scope, wname, (q * scale / qmax).astype(w.dtype), old)
            # the axis is stored: read off the shape, a square weight's
            # would be ambiguous
            weight_scales[wname] = {"scale": np.squeeze(scale), "axis": qaxis}
    return {"weights": weight_scales,
            "activations": {n: act_bits[n] for n in sorted(act_bits)}}


# --- build-time shape and dtype inference ------------------------------------
# OutScale is declared float32, as the JAX package declares it; its lowering
# (ops/math_ops.py) computes OutScale in X's dtype, as the JAX lowering does.

_FAKE_QUANT_TYPES = ("fake_quantize_abs_max",
                     "fake_quantize_moving_average_abs_max")


def _infer_fake_quant(ctx):
    xs = ctx.in_shape("X")
    if xs is None:
        return
    ctx.set_out("Out", tuple(xs), ctx.in_dtype("X"))
    ctx.set_out("OutScale", (1,), "float32")


_A.register_rule(list(_FAKE_QUANT_TYPES), _infer_fake_quant)


def _infer_fake_quant_channel(ctx):
    xs = ctx.in_shape("X")
    if xs is None:
        return
    ctx.set_out("Out", tuple(xs), ctx.in_dtype("X"))
    axis = ctx.op.attr("quant_axis", 0)
    if -len(xs) <= axis < len(xs):
        ctx.set_out("OutScale", (xs[axis],), "float32")
    else:
        ctx.fail(f"quant_axis={axis} out of range for X{tuple(xs)}",
                 var=ctx.op.input("X")[0])


_A.register_rule(["fake_channel_wise_quantize_abs_max"],
                 _infer_fake_quant_channel)


def _infer_fake_dequant(ctx):
    xs = ctx.in_shape("X")
    if xs is None:
        return
    ctx.set_out("Out", tuple(xs), ctx.in_dtype("X"))


_A.register_rule(["fake_dequantize_max_abs"], _infer_fake_dequant)

# abs + max-reduce + round + rescale ~= 4 flops/elem; dequant is one
# multiply-rescale.  Traffic is the plain elementwise stream (in + out).
_RP.register_elementwise_cost("fake_quantize_abs_max",
                              "fake_channel_wise_quantize_abs_max",
                              "fake_quantize_moving_average_abs_max",
                              flops_per_elem=4.0)
_RP.register_elementwise_cost("fake_dequantize_max_abs", flops_per_elem=1.0)

"""ONNX straight from the port's deploy model, with no `onnx` package (the
port's counterpart of `efficientteacher_tpu/export/onnx_jaxpr.py`, which
translates jaxprs).

`torch.onnx.export` needs the `onnx` package, which neither the port's
machines nor its tests have. So `export_onnx` traces the model's eval
forward with `torch.export.export`, lowers it to core ATen
(`run_decompositions`) and translates that graph node by node into
`onnx_proto` nodes at opset 13:

  - nodes that do not depend on the input (the decode's grids, anchors
    and strides) are evaluated here and written as initializers;
  - a BatchNorm whose input is a convolution used nowhere else is folded
    into that convolution's weight and bias (float64, then float32), so
    the graph holds no BatchNormalization node, as the reference's fused
    export and JAX's (`tests/test_onnx_export.py`) hold none; any other
    BatchNorm becomes a Mul and an Add;
  - the rest maps onto Conv / ConvTranspose, MaxPool, Resize (nearest),
    the elementwise ops, Concat, Reshape, Transpose, Slice, Split,
    Softmax and ReduceSum: the ops the five families below lower to. An
    ATen op outside that set raises NotImplementedError naming it.

The input is NCHW float `images` (already divided by 255), the output
`output` the decoded (B, N, 5 + nc) predictions, as JAX's file. The five
families of JAX's ONNX tests (YOLOv5, YOLOX, YOLOv6 deploy-fused, YOLOv7,
YOLOv8) are held against cv2.dnn in `tests/test_torch_export.py`.
"""

from __future__ import annotations

import operator
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from . import onnx_proto as P

aten = torch.ops.aten


class _Sym:
    """A value that depends on the graph input: its ONNX name and shape."""

    def __init__(self, name: str, shape):
        self.name = name
        self.shape = tuple(int(d) for d in shape)


class Decoded(nn.Module):
    """A detector called for its decoded predictions alone: the traced
    forward of the ONNX and TorchScript exports."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model(x, decode=True)[0]


class _Graph:
    def __init__(self):
        self.nodes: List[dict] = []
        self.inits: Dict[str, np.ndarray] = {}
        self._n = 0

    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def emit(self, op: str, inputs, n_out: int = 1, **attrs):
        outs = [self.fresh(op.lower()) for _ in range(n_out)]
        self.nodes.append({"op": op, "inputs": list(inputs), "outputs": outs,
                           "attrs": attrs})
        return outs[0] if n_out == 1 else outs

    def const(self, arr, dtype=np.float32) -> str:
        arr = np.asarray(arr, dtype)
        name = self.fresh("c")
        self.inits[name] = np.ascontiguousarray(arr)
        return name

    def ints(self, values) -> str:
        return self.const(np.asarray(values, np.int64).reshape(-1), np.int64)


def _tensor_const(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().float().cpu().numpy()
    return np.asarray([v], np.float32)


class _Translator:
    def __init__(self, b: _Graph):
        self.b = b
        self.conv_of: Dict[str, dict] = {}   # output name -> its Conv node

    def name(self, v) -> str:
        return v.name if isinstance(v, _Sym) else self.b.const(
            _tensor_const(v))

    def out(self, node, name):
        return _Sym(name, node.meta["val"].shape)

    # ------------------------------------------------------------- ops
    def convolution(self, node, x, w, bias, stride, padding, dilation,
                    transposed, output_padding, groups):
        w = w.detach().float().cpu().numpy()
        b = (bias.detach().float().cpu().numpy() if bias is not None
             else np.zeros(w.shape[1] * groups if transposed else w.shape[0],
                           np.float32))
        attrs = dict(kernel_shape=list(w.shape[2:]), strides=list(stride),
                     pads=list(padding) * 2, dilations=list(dilation),
                     group=int(groups))
        if transposed:
            attrs["output_padding"] = list(output_padding)
        op = "ConvTranspose" if transposed else "Conv"
        wn, bn = self.b.const(w), self.b.const(b)
        name = self.b.emit(op, [x.name, wn, bn], **attrs)
        if not transposed:
            self.conv_of[name] = self.b.nodes[-1]
        return self.out(node, name)

    def batch_norm(self, node, x, w, b, mean, var, momentum, eps):
        t = (w.double() / torch.sqrt(var.double() + eps)).cpu().numpy()
        shift = (b.double().cpu().numpy()
                 - mean.double().cpu().numpy() * t)
        conv = self.conv_of.get(x.name)
        if conv is not None and len(node.args[0].users) == 1:
            wn, bn = conv["inputs"][1:]
            self.b.inits[wn] = (self.b.inits[wn].astype(np.float64)
                                * t.reshape(-1, 1, 1, 1)).astype(np.float32)
            self.b.inits[bn] = (self.b.inits[bn].astype(np.float64) * t
                                + shift).astype(np.float32)
            return (x,)
        shape = (-1,) + (1,) * (len(x.shape) - 2)
        y = self.b.emit("Mul", [x.name, self.b.const(t.reshape(shape))])
        y = self.b.emit("Add", [y, self.b.const(shift.reshape(shape))])
        return (_Sym(y, x.shape),)

    def max_pool(self, node, x, kernel, stride=(), padding=(0, 0),
                 dilation=(1, 1), ceil_mode=False):
        y = self.b.emit("MaxPool", [x.name], kernel_shape=list(kernel),
                        strides=list(stride or kernel),
                        pads=list(padding) * 2, dilations=list(dilation),
                        ceil_mode=int(ceil_mode))
        return (_Sym(y, node.meta["val"][0].shape),)

    def upsample_nearest(self, node, x, output_size, scales):
        out = node.meta["val"].shape
        sc = [1.0, 1.0, out[2] / x.shape[2], out[3] / x.shape[3]]
        y = self.b.emit("Resize", [x.name, "", self.b.const(sc)],
                        mode="nearest",
                        coordinate_transformation_mode="asymmetric",
                        nearest_mode="floor")
        return self.out(node, y)

    def reshape(self, node, x, *_):
        return self.out(node, self.b.emit(
            "Reshape", [x.name, self.b.ints(node.meta["val"].shape)]))

    def permute(self, node, x, dims):
        rank = len(x.shape)
        return self.out(node, self.b.emit(
            "Transpose", [x.name], perm=[d % rank for d in dims]))

    def slice(self, node, x, dim=0, start=None, end=None, step=1):
        dim %= len(x.shape)
        size = x.shape[dim]
        start = 0 if start is None else start
        end = size if end is None else min(end, size)
        y = self.b.emit("Slice", [x.name, self.b.ints([start]),
                                  self.b.ints([end]), self.b.ints([dim]),
                                  self.b.ints([step])])
        return self.out(node, y)

    def split(self, node, x, sizes, dim=0):
        dim %= len(x.shape)
        ys = self.b.emit("Split", [x.name, self.b.ints(sizes)],
                         n_out=len(sizes), axis=dim)
        ys = [ys] if isinstance(ys, str) else ys
        return tuple(_Sym(y, v.shape) for y, v in zip(ys, node.meta["val"]))

    def cat(self, node, xs, dim=0):
        rank = len(node.meta["val"].shape)
        return self.out(node, self.b.emit(
            "Concat", [self.name(v) for v in xs], axis=dim % rank))

    def softmax(self, node, x, dim, half_to_float=False):
        return self.out(node, self.b.emit("Softmax", [x.name],
                                          axis=dim % len(x.shape)))

    def reduce_sum(self, node, x, dims, keepdim=False, dtype=None):
        rank = len(x.shape)
        return self.out(node, self.b.emit(
            "ReduceSum", [x.name, self.b.ints([d % rank for d in dims])],
            keepdims=int(keepdim)))

    def clamp(self, node, x, lo=None, hi=None):
        ins = [x.name, "" if lo is None else self.b.const(float(lo)),
               "" if hi is None else self.b.const(float(hi))]
        while ins[-1] == "":
            ins.pop()
        return self.out(node, self.b.emit("Clip", ins))

    def unary(self, op):
        return lambda node, x: self.out(node, self.b.emit(op, [x.name]))

    def leaky_relu(self, node, x, negative_slope=0.01):
        return self.out(node, self.b.emit("LeakyRelu", [x.name],
                                          alpha=float(negative_slope)))

    def binary(self, op):
        def f(node, a, b, alpha=1):
            if alpha != 1:
                b = _Sym(self.b.emit("Mul", [self.name(b), self.b.const(
                    float(alpha))]), node.meta["val"].shape)
            return self.out(node, self.b.emit(op, [self.name(a),
                                                   self.name(b)]))
        return f

    def identity(self, node, x, *_, **__):
        return x

    def full_like(self, node, x, value, **_):
        # its value depends on x's shape alone: a constant
        return torch.full(tuple(node.meta["val"].shape), float(value))

    def table(self):
        return {
            aten.convolution.default: self.convolution,
            aten._native_batch_norm_legit_no_training.default:
                self.batch_norm,
            aten.max_pool2d_with_indices.default: self.max_pool,
            aten.upsample_nearest2d.vec: self.upsample_nearest,
            aten.view.default: self.reshape,
            aten.permute.default: self.permute,
            aten.slice.Tensor: self.slice,
            aten.split_with_sizes.default: self.split,
            aten.cat.default: self.cat,
            aten._softmax.default: self.softmax,
            aten.sum.dim_IntList: self.reduce_sum,
            aten.clamp.default: self.clamp,
            aten.relu.default: self.unary("Relu"),
            aten.sigmoid.default: self.unary("Sigmoid"),
            aten.exp.default: self.unary("Exp"),
            aten.leaky_relu.default: self.leaky_relu,
            aten.add.Tensor: self.binary("Add"),
            aten.sub.Tensor: self.binary("Sub"),
            aten.mul.Tensor: self.binary("Mul"),
            aten.div.Tensor: self.binary("Div"),
            aten.pow.Tensor_Scalar: self.binary("Pow"),
            aten.clone.default: self.identity,
            aten.alias.default: self.identity,
            aten.full_like.default: self.full_like,
        }


def _is_sym(v) -> bool:
    if isinstance(v, _Sym):
        return True
    if isinstance(v, (list, tuple)):
        return any(_is_sym(x) for x in v)
    return False


def export_onnx(model: nn.Module, example: torch.Tensor, path,
                opset: int = 13) -> Dict[str, int]:
    """Write `model`'s eval forward on inputs shaped like `example` (NCHW
    float) as ONNX at `path`, the decode included (module docstring).
    Returns the op census {op_type: count}."""
    model = Decoded(model).eval()
    with torch.no_grad():
        ep = torch.export.export(model, (example,)).run_decompositions()
    b = _Graph()
    tr = _Translator(b)
    table = tr.table()
    sig = ep.graph_signature
    consts = {**ep.state_dict, **ep.constants}
    env = {}
    placeholders = [n for n in ep.graph.nodes if n.op == "placeholder"]
    for node, spec in zip(placeholders, sig.input_specs):
        if spec.kind.name == "USER_INPUT":
            env[node] = _Sym("images", node.meta["val"].shape)
            in_shape = env[node].shape
        else:
            env[node] = consts[spec.target].detach()
    result = None
    for node in ep.graph.nodes:
        if node.op == "placeholder":
            continue
        if node.op == "output":
            result = env[node.args[0][0]]
            break
        args = torch.fx.node.map_arg(node.args, lambda n: env[n])
        kwargs = torch.fx.node.map_arg(node.kwargs, lambda n: env[n])
        if node.target is operator.getitem:
            env[node] = args[0][args[1]]
        elif not _is_sym((args, kwargs)):
            env[node] = node.target(*args, **kwargs)   # a constant
        elif node.target is aten._assert_tensor_metadata.default:
            env[node] = None
        elif node.target in table:
            env[node] = table[node.target](node, *args, **kwargs)
        else:
            raise NotImplementedError(
                f"ONNX export: no translation for {node.target}")
    b.emit("Identity", [tr.name(result)])
    b.nodes[-1]["outputs"] = ["output"]
    live = {"output"}
    nodes = []
    for n in reversed(b.nodes):     # drop what the output does not need
        if any(o in live for o in n["outputs"]):
            nodes.append(n)
            live.update(i for i in n["inputs"] if i)
    nodes.reverse()
    inits = {k: v for k, v in b.inits.items() if k in live}
    out_shape = result.shape
    g = P.graph([P.node(n["op"], n["inputs"], n["outputs"], attrs=n["attrs"])
                 for n in nodes], "efficientteacher_torch",
                [P.tensor(k, v) for k, v in inits.items()],
                [P.value_info("images", np.float32, in_shape)],
                [P.value_info("output", np.float32, out_shape)])
    with open(path, "wb") as f:
        f.write(P.model(g, opset=opset))
    census: Dict[str, int] = {}
    for n in nodes:
        census[n["op"]] = census.get(n["op"], 0) + 1
    return census

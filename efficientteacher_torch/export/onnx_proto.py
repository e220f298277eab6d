"""Minimal ONNX protobuf writer — no `onnx` package dependency (a copy of
`efficientteacher_tpu/export/onnx_proto.py`).

The machines this port runs on have no `onnx` wheel (and
`torch.onnx.export` refuses to run without it), yet ONNX is the
reference's primary deploy interchange
(reference deploy/model_convert.py:75-130 export_onnx). Instead of
dep-gating the whole path, this module hand-encodes the small, stable
subset of onnx.proto3 (ModelProto/GraphProto/NodeProto/TensorProto/
AttributeProto/ValueInfoProto) straight to protobuf wire format.

Field numbers follow the upstream onnx.proto3 schema, unchanged since
IR version 4 (2019). Output files load in onnxruntime, cv2.dnn
(readNetFromONNX — verified in tests/test_torch_export.py), netron and
the `onnx` checker.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Union

import numpy as np

# TensorProto.DataType
F32, U8, I8, I32, I64, BOOL, F16, F64 = 1, 2, 3, 6, 7, 9, 10, 11

_NP_TO_ONNX = {
    np.dtype(np.float32): F32,
    np.dtype(np.uint8): U8,
    np.dtype(np.int8): I8,
    np.dtype(np.int32): I32,
    np.dtype(np.int64): I64,
    np.dtype(np.bool_): BOOL,
    np.dtype(np.float16): F16,
    np.dtype(np.float64): F64,
}


def onnx_dtype(dt) -> int:
    dt = np.dtype(dt)
    if dt not in _NP_TO_ONNX:
        raise ValueError(f"no ONNX mapping for dtype {dt}")
    return _NP_TO_ONNX[dt]


# ---------------------------------------------------------------- wire format

def _varint(n: int) -> bytes:
    if n < 0:
        n &= (1 << 64) - 1  # two's-complement int64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _f_bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _f_str(field: int, value: str) -> bytes:
    return _f_bytes(field, value.encode("utf-8"))


def _f_packed_i64(field: int, values: Sequence[int]) -> bytes:
    return _f_bytes(field, b"".join(_varint(int(v)) for v in values))


def _f_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


# ------------------------------------------------------------------- messages

def tensor(name: str, arr: np.ndarray) -> bytes:
    """TensorProto with raw_data (little-endian)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    out = b""
    if arr.ndim:
        out += _f_packed_i64(1, arr.shape)  # dims
    out += _f_varint(2, onnx_dtype(arr.dtype))  # data_type
    out += _f_str(8, name)  # name
    out += _f_bytes(9, arr.tobytes())  # raw_data
    return out


# AttributeProto.AttributeType
_ATTR_FLOAT, _ATTR_INT, _ATTR_STRING, _ATTR_TENSOR = 1, 2, 3, 4
_ATTR_FLOATS, _ATTR_INTS, _ATTR_STRINGS = 6, 7, 8

AttrValue = Union[float, int, str, bytes, np.ndarray, Sequence]


def attribute(name: str, value: AttrValue) -> bytes:
    out = _f_str(1, name)
    if isinstance(value, bool):
        out += _f_varint(3, int(value)) + _f_varint(20, _ATTR_INT)
    elif isinstance(value, (int, np.integer)):
        out += _f_varint(3, int(value)) + _f_varint(20, _ATTR_INT)
    elif isinstance(value, (float, np.floating)):
        out += _f_float(2, float(value)) + _f_varint(20, _ATTR_FLOAT)
    elif isinstance(value, str):
        out += _f_bytes(4, value.encode()) + _f_varint(20, _ATTR_STRING)
    elif isinstance(value, bytes):
        out += _f_bytes(4, value) + _f_varint(20, _ATTR_STRING)
    elif isinstance(value, np.ndarray):
        out += _f_bytes(5, tensor("", value)) + _f_varint(20, _ATTR_TENSOR)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            out += _f_packed_i64(8, value) + _f_varint(20, _ATTR_INTS)
        elif all(isinstance(v, (float, np.floating)) for v in value):
            body = b"".join(struct.pack("<f", float(v)) for v in value)
            out += _f_bytes(7, body) + _f_varint(20, _ATTR_FLOATS)
        elif all(isinstance(v, str) for v in value):
            for v in value:
                out += _f_bytes(9, v.encode())
            out += _f_varint(20, _ATTR_STRINGS)
        else:
            raise TypeError(f"mixed attribute list for {name!r}")
    else:
        raise TypeError(f"unsupported attribute {name!r}: {type(value)}")
    return out


def node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
         name: str = "", attrs: Dict[str, AttrValue] | None = None) -> bytes:
    out = b""
    for i in inputs:
        out += _f_str(1, i)
    for o in outputs:
        out += _f_str(2, o)
    if name:
        out += _f_str(3, name)
    out += _f_str(4, op_type)
    for k, v in (attrs or {}).items():
        out += _f_bytes(5, attribute(k, v))
    return out


def value_info(name: str, dtype, shape: Sequence[int]) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += _f_bytes(1, _f_str(3, d))  # dim_param
        else:
            dims += _f_bytes(1, _f_varint(1, int(d)))  # dim_value
    tensor_type = _f_varint(1, onnx_dtype(dtype)) + _f_bytes(2, dims)
    type_proto = _f_bytes(1, tensor_type)
    return _f_str(1, name) + _f_bytes(2, type_proto)


def graph(nodes: List[bytes], name: str, initializers: List[bytes],
          inputs: List[bytes], outputs: List[bytes]) -> bytes:
    # one join: a detector's initializers are hundreds of MB
    return b"".join([_f_bytes(1, n) for n in nodes] + [_f_str(2, name)]
                    + [_f_bytes(5, t) for t in initializers]
                    + [_f_bytes(11, i) for i in inputs]
                    + [_f_bytes(12, o) for o in outputs])


def model(graph_bytes: bytes, opset: int = 13, ir_version: int = 8,
          producer: str = "efficientteacher_torch") -> bytes:
    opset_id = _f_str(1, "") + _f_varint(2, opset)
    return (
        _f_varint(1, ir_version)
        + _f_str(2, producer)
        + _f_bytes(7, graph_bytes)
        + _f_bytes(8, opset_id)
    )

"""Minimal ONNX weight extractor — no ``onnx``/``onnxruntime`` dependency.

The reference runs MDX models through ONNX Runtime
(``uvr5/multiprocess_cuda_infer.py:225-238``); here we only need the
*initializer tensors* out of the ``.onnx`` file to rebuild the network in
PyTorch. A copy of ``lemas_tts_tpu/uvr5/onnx_weights.py`` (the port imports
nothing of the JAX package). This module hand-parses the protobuf wire format for the narrow subset:

  ModelProto.graph (field 7) → GraphProto.initializer (field 5, repeated
  TensorProto) → TensorProto {dims=1, data_type=2, name=8, raw_data=9,
  float_data=4, int64_data=7}.

torch.onnx export preserves the module state-dict names for parameters, so
the resulting {name: ndarray} loads into ``mdxnet.ConvTDFNet`` with
``load_state_dict`` as it is.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

# ONNX TensorProto.DataType → numpy
_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
           6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
           11: np.float64, 12: np.uint32, 13: np.uint64}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, bytes | int]]:
    """Iterate (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims = []
    dtype = np.float32
    name = ""
    raw = None
    floats = []
    int64s = []
    for field, wire, val in _fields(buf):
        if field == 1:  # dims
            if wire == 0:
                dims.append(val)
            else:  # packed
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    dims.append(v)
        elif field == 2:
            dtype = _DTYPES.get(val, np.float32)
        elif field == 4:  # float_data
            if wire == 2:
                floats.extend(np.frombuffer(val, np.float32))
            else:
                floats.append(np.frombuffer(val, np.float32)[0])
        elif field == 7:  # int64_data (unpacked varints OR packed wire 2 —
            # proto3 packs repeated scalars by default)
            if wire == 0:
                int64s.append(val)
            elif wire == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int64s.append(v)
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = val
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif floats:
        arr = np.asarray(floats, dtype=np.float32)
    elif int64s:
        # varints are unsigned on the wire: wrap to two's complement so a
        # stored -1 (common axis constant) doesn't OverflowError
        arr = np.asarray(int64s, dtype=np.uint64).astype(np.int64)
    else:
        arr = np.zeros(0, dtype=dtype)
    return name, arr.reshape(dims) if dims else arr


def load_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """Parse an .onnx file and return {initializer_name: ndarray}."""
    with open(path, "rb") as f:
        model = f.read()
    graph = None
    for field, wire, val in _fields(model):
        if field == 7 and wire == 2:  # ModelProto.graph
            graph = val
            break
    if graph is None:
        raise ValueError(f"{path}: no graph found (not an ONNX ModelProto?)")
    out: Dict[str, np.ndarray] = {}
    for field, wire, val in _fields(graph):
        if field == 5 and wire == 2:  # GraphProto.initializer
            name, arr = _parse_tensor(val)
            out[name] = arr
    return out

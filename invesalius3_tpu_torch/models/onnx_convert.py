"""ONNX checkpoint ingestion (port of invesalius3_tpu/models/onnx_convert.py,
the same code): a minimal protobuf wire-format reader (and writer, used by
tests) for the initializer graph of an ONNX model.

The reference distributes FastSurfer parcellation weights as ONNX and runs
them through a vendored tinygrad runner (reference
invesalius/segmentation/tinygrad_extra/onnx.py ``OnnxRunner``, and
fastsurfer_subpart/inference.py:159 ``TinyGradInference``).  No ONNX
*runtime* is needed — the architectures are PyTorch modules here — only the
weights.  torch's ONNX exporter preserves parameter names as initializer
names ("enc1.conv1.weight", "enc1.bn1.running_mean", ...), so extracting
``graph.initializer`` yields exactly the state dict the port's modules
(models/fastsurfer.py ``FastSurferCNN``, models/unet2d.py,
models/unet3d.py) load.

No ``onnx`` package is needed: the protobuf wire format is parsed by hand.
Only the containers traversed are decoded (ModelProto.graph ->
GraphProto.initializer -> TensorProto); everything else is skipped
field-by-field.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# --- protobuf wire primitives ---------------------------------------------

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes, int]]:
    """Yield (field_number, wire_type, payload_bytes, varint_value)."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == _WIRE_VARINT:
            val, pos = _read_varint(buf, pos)
            yield field, wire, b"", val
        elif wire == _WIRE_LEN:
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + ln], 0
            pos += ln
        elif wire == _WIRE_I64:
            yield field, wire, buf[pos:pos + 8], 0
            pos += 8
        elif wire == _WIRE_I32:
            yield field, wire, buf[pos:pos + 4], 0
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _packed_varints(payload: bytes) -> List[int]:
    out = []
    pos = 0
    while pos < len(payload):
        v, pos = _read_varint(payload, pos)
        out.append(v)
    return out


# --- TensorProto decode ----------------------------------------------------

# onnx TensorProto.DataType -> (numpy dtype, raw itemsize)
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
_BFLOAT16 = 16


def _decode_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    data_type = 0
    name = ""
    raw: Optional[bytes] = None
    float_data: List[float] = []
    int_data: List[int] = []
    double_data: List[float] = []
    for field, wire, payload, val in _iter_fields(buf):
        if field == 1:  # dims (packed or not)
            if wire == _WIRE_LEN:
                dims.extend(_packed_varints(payload))
            else:
                dims.append(val)
        elif field == 2:
            data_type = val
        elif field == 4:  # float_data
            if wire == _WIRE_LEN:
                float_data.extend(struct.unpack(f"<{len(payload) // 4}f", payload))
            else:
                float_data.append(struct.unpack("<f", payload)[0])
        elif field in (5, 7, 11):  # int32_data / int64_data / uint64_data
            if wire == _WIRE_LEN:
                int_data.extend(_packed_varints(payload))
            else:
                int_data.append(val)
        elif field == 8:
            name = payload.decode("utf-8")
        elif field == 9:
            raw = payload
        elif field == 10:  # double_data
            if wire == _WIRE_LEN:
                double_data.extend(struct.unpack(f"<{len(payload) // 8}d", payload))
            else:
                double_data.append(struct.unpack("<d", payload)[0])
        elif field == 13:
            raise ValueError(
                f"initializer {name!r} uses external data; not supported")
    shape = tuple(dims)
    if data_type == _BFLOAT16:
        if raw is None:
            raise ValueError(f"bfloat16 initializer {name!r} without raw_data")
        u16 = np.frombuffer(raw, dtype="<u2")
        arr = (u16.astype(np.uint32) << 16).view(np.float32).reshape(shape)
        return name, arr
    if data_type not in _DTYPES:
        raise ValueError(f"initializer {name!r}: unsupported dtype {data_type}")
    dt = np.dtype(_DTYPES[data_type]).newbyteorder("<")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dt).reshape(shape)
    elif float_data:
        arr = np.asarray(float_data, dtype=np.float32).astype(dt).reshape(shape)
    elif double_data:
        arr = np.asarray(double_data, dtype=np.float64).astype(dt).reshape(shape)
    elif int_data:
        if data_type == 7:  # int64 stored as two's-complement varints
            int_data = [v - (1 << 64) if v >= (1 << 63) else v for v in int_data]
        elif data_type == 6:
            int_data = [v - (1 << 32) if v >= (1 << 31) else v for v in int_data]
        arr = np.asarray(int_data).astype(dt).reshape(shape)
    else:
        arr = np.zeros(shape, dtype=dt)  # legal: all-zero tensor
    return name, np.ascontiguousarray(arr)


# --- ModelProto traversal --------------------------------------------------

def parse_onnx_initializers(data: bytes) -> Dict[str, np.ndarray]:
    """Extract ``graph.initializer`` tensors from serialized ModelProto bytes."""
    graph = None
    for field, wire, payload, _ in _iter_fields(data):
        if field == 7 and wire == _WIRE_LEN:  # ModelProto.graph
            graph = payload
            break
    if graph is None:
        raise ValueError("not an ONNX ModelProto (no graph field)")
    out: Dict[str, np.ndarray] = {}
    for field, wire, payload, _ in _iter_fields(graph):
        if field == 5 and wire == _WIRE_LEN:  # GraphProto.initializer
            name, arr = _decode_tensor(payload)
            out[name] = arr
    return out


def onnx_state_dict(path) -> Dict[str, np.ndarray]:
    """Read an .onnx file into a torch-style ``{name: ndarray}`` state dict.

    Drops non-parameter bookkeeping entries and strips uniform wrapper
    prefixes, matching models/torch_convert.py ``torch_state_dict``.
    """
    from .torch_convert import strip_wrapper_prefixes

    with open(path, "rb") as f:
        data = f.read()
    state = parse_onnx_initializers(data)
    state = {k: v for k, v in state.items()
             if not k.endswith("num_batches_tracked")
             and not k.startswith("onnx::")}
    state = {k: v.astype(np.float32) if v.dtype == np.float16 else v
             for k, v in state.items()}
    return strip_wrapper_prefixes(state)


# --- writer (tests + interchange) ------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int, payload: bytes) -> bytes:
    return _varint((num << 3) | wire) + (
        _varint(len(payload)) + payload if wire == _WIRE_LEN else payload)


_NP_TO_ONNX = {
    np.dtype(np.float32): 1, np.dtype(np.uint8): 2, np.dtype(np.int8): 3,
    np.dtype(np.uint16): 4, np.dtype(np.int16): 5, np.dtype(np.int32): 6,
    np.dtype(np.int64): 7, np.dtype(np.bool_): 9, np.dtype(np.float16): 10,
    np.dtype(np.float64): 11, np.dtype(np.uint32): 12, np.dtype(np.uint64): 13,
}


def _encode_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _NP_TO_ONNX:
        raise ValueError(f"cannot encode dtype {arr.dtype}")
    parts = []
    for d in arr.shape:
        parts.append(_varint((1 << 3) | _WIRE_VARINT) + _varint(int(d)))
    parts.append(_varint((2 << 3) | _WIRE_VARINT) + _varint(_NP_TO_ONNX[arr.dtype]))
    parts.append(_field(8, _WIRE_LEN, name.encode("utf-8")))
    parts.append(_field(9, _WIRE_LEN, arr.astype(arr.dtype.newbyteorder("<")).tobytes()))
    return b"".join(parts)


def write_onnx(path, state: Dict[str, np.ndarray],
               producer: str = "invesalius3_tpu") -> None:
    """Serialize ``state`` as an ONNX ModelProto holding only initializers.

    Good enough for weight interchange and for exercising the reader; no
    compute nodes are emitted.
    """
    inits = b"".join(_field(5, _WIRE_LEN, _encode_tensor(k, np.asarray(v)))
                     for k, v in state.items())
    graph = _field(2, _WIRE_LEN, b"weights") + inits
    model = (
        _varint((1 << 3) | _WIRE_VARINT) + _varint(8)  # ir_version
        + _field(2, _WIRE_LEN, producer.encode("utf-8"))
        + _field(7, _WIRE_LEN, graph)
    )
    with open(path, "wb") as f:
        f.write(model)

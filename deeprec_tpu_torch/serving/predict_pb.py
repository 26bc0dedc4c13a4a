"""Pure-python protobuf wire codec for the reference serving protocol.

The reference's processor speaks protobuf on its C ABI: hosts serialize
``tensorflow.eas.PredictRequest`` and parse ``PredictResponse``
(the reference's serving/processor/serving/predict.proto, parsed in
message_coding.cc ParseRequestFromBuf/ParseResponseToBuf). For a host
built against that contract to call our ``libdeeprec_processor.so``, the
bytes on the wire must be the same — so this module implements the
proto3 wire format for exactly those messages, by hand, with no protobuf
runtime dependency (the image has none we may rely on, and the schema is
four small messages).

Wire-format notes (proto3):
- varint fields: int32/int64/enum/bool. Negative int32/int64 are encoded
  as 10-byte sign-extended varints.
- packed repeated scalars: length-delimited blob of the scalar encoding.
  Parsers must ALSO accept the unpacked form (one tagged entry per
  element) — protobuf's compatibility rule — and we do.
- map<string, ArrayProto>: repeated embedded message with field 1 = key
  (string), field 2 = value (message).
- Unknown fields are skipped by wire type, like any conforming parser.

Numpy mapping: DT_FLOAT/f4 via float_val, DT_DOUBLE/f8 via double_val,
DT_INT64/i8 via int64_val, DT_INT32 (and the narrow ints, which protobuf
carries as int32) via int_val, DT_BOOL via bool_val, DT_STRING via
string_val (object arrays of bytes).

The port's copy of `deeprec_tpu/serving/predict_pb.py` (it imports no jax; the port keeps its
own copy, as it does of every module it needs).
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------- dtypes

DT_INVALID = 0
DT_FLOAT = 1
DT_DOUBLE = 2
DT_INT32 = 3
DT_UINT8 = 4
DT_INT16 = 5
DT_INT8 = 6
DT_STRING = 7
DT_INT64 = 9
DT_BOOL = 10

_NP_TO_DT = {
    np.dtype(np.float32): DT_FLOAT,
    np.dtype(np.float64): DT_DOUBLE,
    np.dtype(np.int32): DT_INT32,
    np.dtype(np.uint8): DT_UINT8,
    np.dtype(np.int16): DT_INT16,
    np.dtype(np.int8): DT_INT8,
    np.dtype(np.int64): DT_INT64,
    np.dtype(np.bool_): DT_BOOL,
}
_DT_TO_NP = {
    DT_FLOAT: np.float32,
    DT_DOUBLE: np.float64,
    DT_INT32: np.int32,
    DT_UINT8: np.uint8,
    DT_INT16: np.int16,
    DT_INT8: np.int8,
    DT_INT64: np.int64,
    DT_BOOL: np.bool_,
}

# ---------------------------------------------------------- wire helpers

_WT_VARINT = 0
_WT_I64 = 1
_WT_LEN = 2
_WT_I32 = 5


def _enc_varint(v: int) -> bytes:
    if v < 0:  # sign-extend to 64 bits, like protobuf int32/int64
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _dec_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & ((1 << 64) - 1), pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def _to_signed64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _to_signed32(v: int) -> int:
    v &= (1 << 32) - 1
    return v - (1 << 32) if v >= 1 << 31 else v


def _tag(field: int, wt: int) -> bytes:
    return _enc_varint((field << 3) | wt)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, _WT_LEN) + _enc_varint(len(payload)) + payload


def _skip(buf: bytes, pos: int, wt: int) -> int:
    if wt == _WT_VARINT:
        _, pos = _dec_varint(buf, pos)
    elif wt == _WT_I64:
        pos += 8
    elif wt == _WT_LEN:
        n, pos = _dec_varint(buf, pos)
        pos += n
    elif wt == _WT_I32:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wt}")
    if pos > len(buf):
        raise ValueError("truncated field")
    return pos


def _fields(buf: bytes) -> Iterator[Tuple[int, int, int, int]]:
    """Yield (field_number, wire_type, value_start, value_end_or_varint).

    For LEN fields the slice [start:end] is the payload; for varints the
    third element is the decoded value and end is the next position.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _dec_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == _WT_VARINT:
            val, pos = _dec_varint(buf, pos)
            yield field, wt, val, pos
        elif wt == _WT_LEN:
            ln, pos = _dec_varint(buf, pos)
            if pos + ln > n:
                raise ValueError("truncated length-delimited field")
            yield field, wt, pos, pos + ln
            pos += ln
        else:
            end = _skip(buf, pos, wt)
            yield field, wt, pos, end
            pos = end


def _packed_varints(payload: bytes) -> List[int]:
    out = []
    pos = 0
    while pos < len(payload):
        v, pos = _dec_varint(payload, pos)
        out.append(v)
    return out


# ------------------------------------------------------------ ArrayProto


class ArrayProto:
    """tensorflow.eas.ArrayProto (predict.proto:42-67)."""

    __slots__ = ("dtype", "shape", "values", "string_val")

    def __init__(self, dtype: int = DT_INVALID, shape: Optional[List[int]] = None,
                 values: Optional[np.ndarray] = None,
                 string_val: Optional[List[bytes]] = None):
        self.dtype = dtype
        self.shape = list(shape) if shape is not None else []
        self.values = values
        self.string_val = string_val or []

    # -- numpy bridge

    @classmethod
    def from_numpy(cls, arr: np.ndarray) -> "ArrayProto":
        arr = np.asarray(arr)
        if arr.dtype.kind in ("U", "S", "O"):
            flat = [
                s.encode() if isinstance(s, str) else bytes(s)
                for s in arr.reshape(-1)
            ]
            return cls(DT_STRING, list(arr.shape), string_val=flat)
        dt = _NP_TO_DT.get(arr.dtype)
        if dt is None:  # best-effort upcast (e.g. float16 -> float32)
            if arr.dtype.kind == "f":
                arr, dt = arr.astype(np.float32), DT_FLOAT
            elif arr.dtype.kind in "iu":
                arr, dt = arr.astype(np.int64), DT_INT64
            else:
                raise ValueError(f"unsupported dtype {arr.dtype}")
        return cls(dt, list(arr.shape), values=arr.reshape(-1))

    def to_numpy(self) -> np.ndarray:
        shape = self.shape or None
        if self.dtype == DT_STRING:
            arr = np.asarray(self.string_val, dtype=object)
        elif self.values is not None:
            arr = np.asarray(self.values, dtype=_DT_TO_NP[self.dtype])
        else:
            arr = np.zeros(0, dtype=_DT_TO_NP.get(self.dtype, np.float32))
        if shape:
            arr = arr.reshape(shape)
        return arr

    # -- wire

    def serialize(self) -> bytes:
        out = bytearray()
        if self.dtype:
            out += _tag(1, _WT_VARINT) + _enc_varint(self.dtype)
        if self.shape:
            dims = b"".join(_enc_varint(d) for d in self.shape)
            out += _len_field(2, _len_field(1, dims))
        v = self.values
        if v is not None and len(v):
            v = np.asarray(v)
            if self.dtype == DT_FLOAT:
                out += _len_field(
                    3, struct.pack(f"<{len(v)}f", *v.astype(np.float32)))
            elif self.dtype == DT_DOUBLE:
                out += _len_field(
                    4, struct.pack(f"<{len(v)}d", *v.astype(np.float64)))
            elif self.dtype in (DT_INT32, DT_UINT8, DT_INT16, DT_INT8):
                out += _len_field(
                    5, b"".join(_enc_varint(int(x)) for x in v))
            elif self.dtype == DT_INT64:
                out += _len_field(
                    7, b"".join(_enc_varint(int(x)) for x in v))
            elif self.dtype == DT_BOOL:
                out += _len_field(8, bytes(int(bool(x)) for x in v))
        for s in self.string_val:
            out += _len_field(6, s)
        return bytes(out)

    @classmethod
    def parse(cls, buf: bytes) -> "ArrayProto":
        self = cls()
        ints: List[int] = []
        floats: List[float] = []
        which = None  # field number the scalar payload came from
        for field, wt, a, b in _fields(buf):
            if field == 1 and wt == _WT_VARINT:
                self.dtype = a
            elif field == 2 and wt == _WT_LEN:
                for f2, wt2, a2, b2 in _fields(buf[a:b]):
                    if f2 == 1 and wt2 == _WT_LEN:
                        self.shape.extend(
                            _to_signed64(x)
                            for x in _packed_varints(buf[a:b][a2:b2]))
                    elif f2 == 1 and wt2 == _WT_VARINT:
                        self.shape.append(_to_signed64(a2))
            elif field == 3:  # float_val
                which = 3
                if wt == _WT_LEN:
                    floats.extend(
                        struct.unpack(f"<{(b - a) // 4}f", buf[a:b]))
                elif wt == _WT_I32:
                    floats.append(struct.unpack("<f", buf[a:b])[0])
            elif field == 4:  # double_val
                which = 4
                if wt == _WT_LEN:
                    floats.extend(
                        struct.unpack(f"<{(b - a) // 8}d", buf[a:b]))
                elif wt == _WT_I64:
                    floats.append(struct.unpack("<d", buf[a:b])[0])
            elif field in (5, 7, 8):  # int_val / int64_val / bool_val
                which = field
                if wt == _WT_LEN:
                    ints.extend(_packed_varints(buf[a:b]))
                elif wt == _WT_VARINT:
                    ints.append(a)
            elif field == 6 and wt == _WT_LEN:
                self.string_val.append(buf[a:b])
        if which in (3, 4):
            self.values = np.asarray(
                floats, np.float32 if which == 3 else np.float64)
        elif which == 5:
            self.values = np.asarray([_to_signed32(x) for x in ints],
                                     np.int64)
        elif which == 7:
            self.values = np.asarray([_to_signed64(x) for x in ints],
                                     np.int64)
        elif which == 8:
            self.values = np.asarray([bool(x) for x in ints])
        return self


# ------------------------------------------------- request/response msgs


def _map_entry(key: str, value: bytes) -> bytes:
    body = _len_field(1, key.encode()) + _len_field(2, value)
    return body


class PredictRequest:
    """tensorflow.eas.PredictRequest (predict.proto:72-93)."""

    __slots__ = ("signature_name", "inputs", "output_filter")

    def __init__(self, signature_name: str = "",
                 inputs: Optional[Dict[str, ArrayProto]] = None,
                 output_filter: Optional[List[str]] = None):
        self.signature_name = signature_name
        self.inputs: Dict[str, ArrayProto] = inputs or {}
        self.output_filter: List[str] = output_filter or []

    def serialize(self) -> bytes:
        out = bytearray()
        if self.signature_name:
            out += _len_field(1, self.signature_name.encode())
        for k, v in self.inputs.items():
            out += _len_field(2, _map_entry(k, v.serialize()))
        for f in self.output_filter:
            out += _len_field(3, f.encode())
        return bytes(out)

    @classmethod
    def parse(cls, buf: bytes) -> "PredictRequest":
        self = cls()
        for field, wt, a, b in _fields(buf):
            if field == 1 and wt == _WT_LEN:
                self.signature_name = buf[a:b].decode("utf-8", "replace")
            elif field == 2 and wt == _WT_LEN:
                key, val = "", b""
                for f2, wt2, a2, b2 in _fields(buf[a:b]):
                    if f2 == 1 and wt2 == _WT_LEN:
                        key = buf[a:b][a2:b2].decode("utf-8", "replace")
                    elif f2 == 2 and wt2 == _WT_LEN:
                        val = buf[a:b][a2:b2]
                self.inputs[key] = ArrayProto.parse(val)
            elif field == 3 and wt == _WT_LEN:
                self.output_filter.append(buf[a:b].decode("utf-8", "replace"))
        return self


class PredictResponse:
    """tensorflow.eas.PredictResponse (predict.proto:96-99)."""

    __slots__ = ("outputs",)

    def __init__(self, outputs: Optional[Dict[str, ArrayProto]] = None):
        self.outputs: Dict[str, ArrayProto] = outputs or {}

    def serialize(self) -> bytes:
        out = bytearray()
        for k, v in self.outputs.items():
            out += _len_field(1, _map_entry(k, v.serialize()))
        return bytes(out)

    @classmethod
    def parse(cls, buf: bytes) -> "PredictResponse":
        self = cls()
        for field, wt, a, b in _fields(buf):
            if field == 1 and wt == _WT_LEN:
                key, val = "", b""
                for f2, wt2, a2, b2 in _fields(buf[a:b]):
                    if f2 == 1 and wt2 == _WT_LEN:
                        key = buf[a:b][a2:b2].decode("utf-8", "replace")
                    elif f2 == 2 and wt2 == _WT_LEN:
                        val = buf[a:b][a2:b2]
                self.outputs[key] = ArrayProto.parse(val)
        return self


class ServingModelInfo:
    """tensorflow.eas.ServingModelInfo (predict.proto:102-105)."""

    __slots__ = ("model_path",)

    def __init__(self, model_path: str = ""):
        self.model_path = model_path

    def serialize(self) -> bytes:
        if not self.model_path:
            return b""
        return _len_field(1, self.model_path.encode())

    @classmethod
    def parse(cls, buf: bytes) -> "ServingModelInfo":
        self = cls()
        for field, wt, a, b in _fields(buf):
            if field == 1 and wt == _WT_LEN:
                self.model_path = buf[a:b].decode("utf-8", "replace")
        return self

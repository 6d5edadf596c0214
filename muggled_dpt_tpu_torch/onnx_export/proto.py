"""Minimal protobuf wire codec for the ONNX schema subset this repo emits.

No `onnx` / `protobuf` dependency exists in the serving image, so the ONNX
ModelProto is read and written directly at the protobuf wire-format level
(varint / length-delimited records), against a hand-transcribed subset of the
public onnx.proto schema (github.com/onnx/onnx/blob/main/onnx/onnx.proto).

The schema transcription is validated in CI by round-tripping and by parsing
a file produced by an independent producer (torch's C++ torchscript ONNX
exporter, tests/test_torch_onnx_export.py) — field numbers or wire types
wrong in either direction would fail those structural checks. The port's own
copy of the JAX package's ``onnx_export/proto.py``.

Messages are represented as plain dicts keyed by field name; repeated fields
are lists; sub-messages are nested dicts; scalars are Python int/float/str/
bytes. Unknown fields encountered while parsing are preserved under the key
``_unknown`` (list of (field_number, wire_type, raw_value) tuples) so foreign
files survive a parse → serialize round trip of the fields we understand.
"""

from __future__ import annotations

import struct

# ---------------------------------------------------------------------------
# Schema subset (field name -> (field_number, kind)); kind is one of:
#   'int'     varint int64/int32/enum          'string'  length-delimited utf8
#   'bytes'   length-delimited raw             'float'   fixed32
#   'double'  fixed64
#   'msg:<Name>' nested message
# A trailing '*' on kind marks a repeated field. Packed encoding is used for
# repeated scalars on write and accepted in either form on read (onnx.proto
# is proto3: packed is the default for repeated numerics).
# ---------------------------------------------------------------------------

SCHEMAS: dict[str, dict[str, tuple[int, str]]] = {
    "ModelProto": {
        "ir_version": (1, "int"),
        "producer_name": (2, "string"),
        "producer_version": (3, "string"),
        "domain": (4, "string"),
        "model_version": (5, "int"),
        "doc_string": (6, "string"),
        "graph": (7, "msg:GraphProto"),
        "opset_import": (8, "msg:OperatorSetIdProto*"),
        "metadata_props": (14, "msg:StringStringEntryProto*"),
    },
    "OperatorSetIdProto": {"domain": (1, "string"), "version": (2, "int")},
    "StringStringEntryProto": {"key": (1, "string"), "value": (2, "string")},
    "GraphProto": {
        "node": (1, "msg:NodeProto*"),
        "name": (2, "string"),
        "initializer": (5, "msg:TensorProto*"),
        "doc_string": (10, "string"),
        "input": (11, "msg:ValueInfoProto*"),
        "output": (12, "msg:ValueInfoProto*"),
        "value_info": (13, "msg:ValueInfoProto*"),
    },
    "NodeProto": {
        "input": (1, "string*"),
        "output": (2, "string*"),
        "name": (3, "string"),
        "op_type": (4, "string"),
        "attribute": (5, "msg:AttributeProto*"),
        "doc_string": (6, "string"),
        "domain": (7, "string"),
    },
    "AttributeProto": {
        "name": (1, "string"),
        "f": (2, "float"),
        "i": (3, "int"),
        "s": (4, "bytes"),
        "t": (5, "msg:TensorProto"),
        "g": (6, "msg:GraphProto"),
        "floats": (7, "float*"),
        "ints": (8, "int*"),
        "strings": (9, "bytes*"),
        "tensors": (10, "msg:TensorProto*"),
        "doc_string": (13, "string"),
        "type": (20, "int"),
    },
    "TensorProto": {
        "dims": (1, "int*"),
        "data_type": (2, "int"),
        "float_data": (4, "float*"),
        "int32_data": (5, "int*"),
        "string_data": (6, "bytes*"),
        "int64_data": (7, "int*"),
        "name": (8, "string"),
        "raw_data": (9, "bytes"),
        "double_data": (10, "double*"),
        "uint64_data": (11, "int*"),
        "doc_string": (12, "string"),
    },
    "ValueInfoProto": {
        "name": (1, "string"),
        "type": (2, "msg:TypeProto"),
        "doc_string": (3, "string"),
    },
    "TypeProto": {"tensor_type": (1, "msg:TypeProto.Tensor")},
    "TypeProto.Tensor": {"elem_type": (1, "int"), "shape": (2, "msg:TensorShapeProto")},
    "TensorShapeProto": {"dim": (1, "msg:TensorShapeProto.Dimension*")},
    "TensorShapeProto.Dimension": {
        "dim_value": (1, "int"),
        "dim_param": (2, "string"),
        "denotation": (3, "string"),
    },
}

# AttributeProto.type enum values (onnx.proto AttributeProto.AttributeType)
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR, ATTR_GRAPH = 1, 2, 3, 4, 5
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS, ATTR_TENSORS = 6, 7, 8, 9

# TensorProto.DataType enum values
DT_FLOAT, DT_UINT8, DT_INT8, DT_INT32, DT_INT64 = 1, 2, 3, 6, 7
DT_BOOL, DT_FLOAT16, DT_DOUBLE, DT_BFLOAT16 = 9, 10, 11, 16


# ---------------------------------------------------------------------------
# Low-level wire primitives
# ---------------------------------------------------------------------------


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement int64, per protobuf
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return result, pos


def _signed64(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


def _tag(field_number: int, wire_type: int) -> int:
    return (field_number << 3) | wire_type


# wire types
_VARINT, _FIXED64, _LEN, _FIXED32 = 0, 1, 2, 5


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def encode_message(schema_name: str, msg: dict) -> bytes:
    schema = SCHEMAS[schema_name]
    out = bytearray()
    for name, value in msg.items():
        if name == "_unknown":
            # re-emit fields outside the transcribed schema verbatim (field
            # order is not semantic in protobuf), so foreign files survive a
            # parse -> serialize round trip as the module docstring promises
            for field_number, wire_type, raw in value:
                _write_varint(out, _tag(field_number, wire_type))
                if wire_type == _VARINT:
                    _write_varint(out, int(raw))
                elif wire_type == _LEN:
                    _write_varint(out, len(raw))
                    out += raw
                else:  # _FIXED64 / _FIXED32 raw bytes
                    out += raw
            continue
        if name not in schema:
            raise KeyError(f"{schema_name} has no field {name!r}")
        field_number, kind = schema[name]
        repeated = kind.endswith("*")
        base = kind[:-1] if repeated else kind
        values = value if repeated else [value]
        if base in ("int", "float", "double") and repeated:
            # packed encoding for repeated scalars (proto3 default)
            payload = bytearray()
            for v in values:
                if base == "int":
                    _write_varint(payload, int(v))
                elif base == "float":
                    payload += struct.pack("<f", float(v))
                else:
                    payload += struct.pack("<d", float(v))
            _write_varint(out, _tag(field_number, _LEN))
            _write_varint(out, len(payload))
            out += payload
            continue
        for v in values:
            if base == "int":
                _write_varint(out, _tag(field_number, _VARINT))
                _write_varint(out, int(v))
            elif base == "float":
                _write_varint(out, _tag(field_number, _FIXED32))
                out += struct.pack("<f", float(v))
            elif base == "double":
                _write_varint(out, _tag(field_number, _FIXED64))
                out += struct.pack("<d", float(v))
            elif base in ("string", "bytes"):
                payload = v.encode() if isinstance(v, str) else bytes(v)
                _write_varint(out, _tag(field_number, _LEN))
                _write_varint(out, len(payload))
                out += payload
            elif base.startswith("msg:"):
                payload = encode_message(base[4:], v)
                _write_varint(out, _tag(field_number, _LEN))
                _write_varint(out, len(payload))
                out += payload
            else:  # pragma: no cover - schema typo guard
                raise ValueError(f"unknown kind {kind!r} for {schema_name}.{name}")
    return bytes(out)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_message(schema_name: str, data: bytes, start: int = 0, end: int | None = None) -> dict:
    schema = SCHEMAS[schema_name]
    by_number = {fn: (name, kind) for name, (fn, kind) in schema.items()}
    msg: dict = {}
    pos = start
    end = len(data) if end is None else end
    while pos < end:
        tag, pos = _read_varint(data, pos)
        field_number, wire_type = tag >> 3, tag & 7
        entry = by_number.get(field_number)
        if entry is None:
            # unknown field: skip but preserve raw bytes
            if wire_type == _VARINT:
                raw, pos = _read_varint(data, pos)
            elif wire_type == _FIXED64:
                raw, pos = data[pos : pos + 8], pos + 8
            elif wire_type == _FIXED32:
                raw, pos = data[pos : pos + 4], pos + 4
            elif wire_type == _LEN:
                n, pos = _read_varint(data, pos)
                raw, pos = data[pos : pos + n], pos + n
            else:
                raise ValueError(f"unsupported wire type {wire_type} in {schema_name}")
            msg.setdefault("_unknown", []).append((field_number, wire_type, raw))
            continue
        name, kind = entry
        repeated = kind.endswith("*")
        base = kind[:-1] if repeated else kind

        def _store(value):
            if repeated:
                msg.setdefault(name, []).append(value)
            else:
                msg[name] = value

        if base == "int":
            if wire_type == _VARINT:
                v, pos = _read_varint(data, pos)
                _store(_signed64(v))
            elif wire_type == _LEN:  # packed
                n, pos = _read_varint(data, pos)
                stop = pos + n
                while pos < stop:
                    v, pos = _read_varint(data, pos)
                    _store(_signed64(v))
            else:
                raise ValueError(f"bad wire type {wire_type} for int {schema_name}.{name}")
        elif base == "float":
            if wire_type == _FIXED32:
                _store(struct.unpack_from("<f", data, pos)[0])
                pos += 4
            elif wire_type == _LEN:  # packed
                n, pos = _read_varint(data, pos)
                for v in struct.unpack_from(f"<{n // 4}f", data, pos):
                    _store(v)
                pos += n
            else:
                raise ValueError(f"bad wire type {wire_type} for float {schema_name}.{name}")
        elif base == "double":
            if wire_type == _FIXED64:
                _store(struct.unpack_from("<d", data, pos)[0])
                pos += 8
            elif wire_type == _LEN:
                n, pos = _read_varint(data, pos)
                for v in struct.unpack_from(f"<{n // 8}d", data, pos):
                    _store(v)
                pos += n
            else:
                raise ValueError(f"bad wire type {wire_type} for double {schema_name}.{name}")
        elif base in ("string", "bytes"):
            n, pos = _read_varint(data, pos)
            raw = data[pos : pos + n]
            pos += n
            _store(raw.decode() if base == "string" else raw)
        elif base.startswith("msg:"):
            n, pos = _read_varint(data, pos)
            _store(decode_message(base[4:], data, pos, pos + n))
            pos += n
        else:  # pragma: no cover
            raise ValueError(f"unknown kind {kind!r}")
    return msg

"""ONNX GraphProto builder on top of the wire codec (proto.py).

Thin, explicit helper used by the DPT emitter (emit_dpt.py): tracks nodes,
initializers and value names, converts numpy arrays to TensorProto raw_data,
and assembles a serializable ModelProto dict whose producer is
``muggled_dpt_tpu_torch``. The port's own copy of the JAX package's
``onnx_export/builder.py`` (numpy only), so that the port imports nothing of
that package.
"""

from __future__ import annotations

import numpy as np

from .proto import (
    ATTR_FLOAT,
    ATTR_FLOATS,
    ATTR_INT,
    ATTR_INTS,
    ATTR_STRING,
    DT_BOOL,
    DT_DOUBLE,
    DT_FLOAT,
    DT_INT32,
    DT_INT64,
    DT_INT8,
    DT_UINT8,
    encode_message,
)

_NP_TO_DT = {
    np.dtype(np.float32): DT_FLOAT,
    np.dtype(np.float64): DT_DOUBLE,
    np.dtype(np.int64): DT_INT64,
    np.dtype(np.int32): DT_INT32,
    np.dtype(np.int8): DT_INT8,
    np.dtype(np.uint8): DT_UINT8,
    np.dtype(np.bool_): DT_BOOL,
}
DT_TO_NP = {v: k for k, v in _NP_TO_DT.items()}


def tensor_proto(name: str, array: np.ndarray) -> dict:
    array = np.ascontiguousarray(array)
    dt = _NP_TO_DT.get(array.dtype)
    if dt is None:
        raise TypeError(f"unsupported dtype for ONNX initializer: {array.dtype}")
    return {
        "name": name,
        "dims": list(array.shape),
        "data_type": dt,
        "raw_data": array.tobytes(),
    }


def tensor_to_numpy(t: dict) -> np.ndarray:
    dtype = DT_TO_NP[t["data_type"]]
    dims = t.get("dims", [])
    if "raw_data" in t:
        return np.frombuffer(t["raw_data"], dtype=dtype).reshape(dims).copy()
    # fall back to the typed repeated fields (float_data / int64_data / ...)
    for key in ("float_data", "int64_data", "int32_data", "double_data"):
        if key in t:
            return np.asarray(t[key], dtype=dtype).reshape(dims)
    return np.zeros(dims, dtype=dtype)


def value_info(name: str, shape, elem_type: int = DT_FLOAT) -> dict:
    """Shape entries may be ints (dim_value) or strings (dim_param — the
    dynamic-axis declaration, mirroring the reference's dynamic_axes export,
    reference experiments/export_onnx.py:117-130)."""
    dims = [
        {"dim_param": d} if isinstance(d, str) else {"dim_value": int(d)}
        for d in shape
    ]
    return {
        "name": name,
        "type": {
            "tensor_type": {
                "elem_type": elem_type,
                "shape": {"dim": dims},
            }
        },
    }


def _attr(name: str, value) -> dict:
    if isinstance(value, float):
        return {"name": name, "f": value, "type": ATTR_FLOAT}
    if isinstance(value, bool):
        return {"name": name, "i": int(value), "type": ATTR_INT}
    if isinstance(value, int):
        return {"name": name, "i": value, "type": ATTR_INT}
    if isinstance(value, str):
        return {"name": name, "s": value.encode(), "type": ATTR_STRING}
    if isinstance(value, (list, tuple)):
        if all(isinstance(v, int) for v in value):
            return {"name": name, "ints": list(value), "type": ATTR_INTS}
        return {"name": name, "floats": [float(v) for v in value], "type": ATTR_FLOATS}
    raise TypeError(f"unsupported attribute value for {name!r}: {value!r}")


class GraphBuilder:
    """Accumulates nodes/initializers; `op` returns the (single) output name."""

    def __init__(self, name: str = "muggled_dpt_tpu_torch"):
        self.name = name
        self.nodes: list[dict] = []
        self.initializers: list[dict] = []
        self.inputs: list[dict] = []
        self.outputs: list[dict] = []
        self._counter = 0

    def fresh(self, hint: str) -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    def add_input(self, name: str, shape, elem_type: int = DT_FLOAT) -> str:
        self.inputs.append(value_info(name, shape, elem_type))
        return name

    def add_output(self, name: str, shape, elem_type: int = DT_FLOAT) -> None:
        self.outputs.append(value_info(name, shape, elem_type))

    def init(self, hint: str, array: np.ndarray) -> str:
        name = self.fresh(hint)
        self.initializers.append(tensor_proto(name, np.asarray(array)))
        return name

    def op(self, op_type: str, inputs: list[str], out: str | None = None, **attrs) -> str:
        out = out or self.fresh(op_type.lower())
        node = {"op_type": op_type, "input": list(inputs), "output": [out], "name": self.fresh(op_type)}
        if attrs:
            node["attribute"] = [_attr(k, v) for k, v in attrs.items()]
        self.nodes.append(node)
        return out

    def model(self, opset: int = 17, producer: str = "muggled_dpt_tpu_torch", doc: str = "") -> dict:
        graph = {
            "node": self.nodes,
            "name": self.name,
            "initializer": self.initializers,
            "input": self.inputs,
            "output": self.outputs,
        }
        if doc:
            graph["doc_string"] = doc
        return {
            "ir_version": 8,  # IR 8 <-> opset 17 era (ONNX 1.13)
            "producer_name": producer,
            "producer_version": "1.0",
            "graph": graph,
            "opset_import": [{"version": opset}],
        }

    def serialize(self, opset: int = 17, **kw) -> bytes:
        return encode_message("ModelProto", self.model(opset=opset, **kw))

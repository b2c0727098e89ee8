"""Minimal ONNX weight extractor (no onnx/onnxruntime dependency).

The reference runs Silero VAD from a .onnx file via onnxruntime
(reference: vad_silero.py:12-23); this image has neither onnx nor
onnxruntime, so real VAD weights are imported by parsing the ONNX
protobuf wire format directly — only the pieces needed to pull
initializer tensors out of a model file:

  ModelProto.graph (field 7) -> GraphProto.initializer (field 5, repeated)
  TensorProto: dims(1, repeated varint), data_type(2), name(8),
               float_data(4, packed), raw_data(9)

Returns {tensor_name: np.ndarray}; callers map names onto framework
params (e.g. the Silero-shaped VAD in models/vad.py).

Copied from asr_streaming_tpu/tools/onnx_weights.py.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np

# ONNX TensorProto.DataType values we support
_DTYPES = {
    1: np.float32,
    6: np.int32,
    7: np.int64,
    10: np.float16,
    11: np.float64,
}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:                       # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:                     # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:                     # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:                     # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims = []
    dtype_code = 1
    name = ""
    raw = None
    float_data = []
    int_data = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 0:        # dims
            dims.append(val)
        elif field == 2 and wire == 0:      # data_type
            dtype_code = val
        elif field == 8 and wire == 2:      # name
            name = val.decode("utf-8", errors="replace")
        elif field == 9 and wire == 2:      # raw_data
            raw = val
        elif field == 4:                    # float_data
            if wire == 2:                   # packed
                float_data.extend(
                    struct.unpack(f"<{len(val) // 4}f", val))
            else:
                float_data.append(struct.unpack("<f", val)[0])
        elif field == 7 and wire == 0:      # int64_data
            int_data.append(val)
    dtype = _DTYPES.get(dtype_code)
    if dtype is None:
        return name, np.zeros(0)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=np.float32)
    elif int_data:
        arr = np.asarray(int_data, dtype=np.int64)
    else:
        arr = np.zeros(0, dtype=dtype)
    if dims:
        arr = arr.reshape(dims)
    return name, arr


def parse_onnx_initializers(data: bytes) -> Dict[str, np.ndarray]:
    """Extract all initializer tensors from ONNX model bytes."""
    out: Dict[str, np.ndarray] = {}
    for field, wire, val in _fields(data):
        if field == 7 and wire == 2:        # ModelProto.graph
            for gfield, gwire, gval in _fields(val):
                if gfield == 5 and gwire == 2:   # GraphProto.initializer
                    name, arr = _parse_tensor(gval)
                    if name:
                        out[name] = arr
    return out


def load_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        return parse_onnx_initializers(f.read())


# -------------------------------------------------------------- test helper

def encode_test_model(tensors: Dict[str, np.ndarray]) -> bytes:
    """Encode {name: array} into minimal ONNX ModelProto bytes (used by
    tests; real files come from upstream exporters)."""

    def varint(v: int) -> bytes:
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b7 | 0x80])
            else:
                out += bytes([b7])
                return out

    def field(num: int, wire: int, payload: bytes) -> bytes:
        return varint((num << 3) | wire) + payload

    def ld(num: int, payload: bytes) -> bytes:
        return field(num, 2, varint(len(payload)) + payload)

    inits = b""
    for name, arr in tensors.items():
        dtype_code = {np.dtype(np.float32): 1, np.dtype(np.int64): 7,
                      np.dtype(np.float16): 10}[arr.dtype]
        t = b""
        for d in arr.shape:
            t += field(1, 0, varint(d))
        t += field(2, 0, varint(dtype_code))
        t += ld(8, name.encode())
        t += ld(9, arr.tobytes())
        inits += ld(5, t)       # GraphProto.initializer
    return ld(7, inits)          # ModelProto.graph


def convert_silero(onnx_path: str, out_path: str) -> dict:
    """silero_vad.onnx (v5) -> framework npz for the serving VAD
    (models/vad.py, server config key ``vad_weights``)."""
    from asr_streaming_tpu_torch.models.vad import (
        SileroConfig, silero_params_from_onnx,
    )
    from asr_streaming_tpu_torch.utils.checkpoint import save_params

    inits = load_onnx_initializers(onnx_path)
    params = silero_params_from_onnx(inits, SileroConfig())
    save_params(out_path, {"vad": params})
    return params


def main():
    import argparse
    parser = argparse.ArgumentParser(
        description="Extract/convert ONNX weights (Silero VAD).")
    parser.add_argument("onnx")
    parser.add_argument("output", help=".npz output")
    parser.add_argument("--list", action="store_true",
                        help="only list initializer names/shapes")
    args = parser.parse_args()
    if args.list:
        for name, arr in sorted(load_onnx_initializers(args.onnx).items()):
            print(f"{name:60s} {arr.shape} {arr.dtype}")
        return
    convert_silero(args.onnx, args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()

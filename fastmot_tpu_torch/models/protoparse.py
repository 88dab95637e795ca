"""Minimal protobuf wire-format reader for checkpoint ingestion.

The reference distributes its pretrained models as ONNX files
(osnet_x0_25_msmt17.onnx, yolov4_crowdhuman.onnx) and TensorFlow frozen
graphs (ssd_*_coco.pb) — see scripts/download_models.sh — and consumes
them through onnx/uff/TensorRT. This environment ships neither the onnx
nor the tensorflow package, and the only thing a weight converter needs
from either format is the named constant tensors. Both formats are
protobuf messages, and protobuf's wire format is tiny: varints, 64-bit,
length-delimited, 32-bit. So this module walks the wire format directly:

  * ``onnx_initializers(data)``  — {name: ndarray} from a .onnx ModelProto
    (graph.initializer, i.e. every weight tensor; onnx.proto fields:
    ModelProto.graph=7, GraphProto.initializer=5).
  * ``graphdef_constants(data)`` — {node_name: ndarray} for every Const
    node in a TF frozen GraphDef (node=1; NodeDef name=1/op=2/attr=5;
    AttrValue.tensor=8; TF TensorProto dtype=1/shape=2/content=4).

No instructions are executed from the files — only tensors are read.
"""
from __future__ import annotations

import numpy as np

_WT_VARINT = 0
_WT_I64 = 1
_WT_LEN = 2
_WT_I32 = 5


def _read_varint(buf, pos):
    result = 0
    shift = 0
    end = len(buf)
    while True:
        if pos >= end:
            raise ValueError('truncated varint')
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError('malformed varint')


def iter_fields(buf):
    """Yield (field_number, wire_type, value) for one serialized message.

    ``value`` is an int for varint/fixed fields and a memoryview for
    length-delimited fields (submessages, strings, packed arrays).
    """
    buf = memoryview(buf)
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == _WT_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wt == _WT_I64:
            val = int.from_bytes(buf[pos:pos + 8], 'little')
            pos += 8
        elif wt == _WT_LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == _WT_I32:
            val = int.from_bytes(buf[pos:pos + 4], 'little')
            pos += 4
        else:
            raise ValueError(f'unsupported wire type {wt} (field {field})')
        yield field, wt, val


def fields(buf):
    """Collect a message's fields into {field_number: [values...]}."""
    out = {}
    for f, _, v in iter_fields(buf):
        out.setdefault(f, []).append(v)
    return out


def _signed64(v):
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def _repeated_varints(values, wire_types):
    """Decode a repeated int field that may be packed or not."""
    out = []
    for v, wt in zip(values, wire_types):
        if wt == _WT_VARINT:
            out.append(_signed64(v))
        else:                     # packed: length-delimited run of varints
            pos = 0
            while pos < len(v):
                x, pos = _read_varint(v, pos)
                out.append(_signed64(x))
    return out


def _field_raw(buf, want):
    """[(value, wire_type)] for one field number of a message."""
    return [(v, wt) for f, wt, v in iter_fields(buf) if f == want]


# ---------------------------------------------------------------------------
# ONNX ModelProto
# ---------------------------------------------------------------------------

# onnx TensorProto.DataType -> numpy
_ONNX_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _onnx_tensor(buf):
    """Decode one onnx TensorProto -> (name, ndarray)."""
    dims, dtype, name = [], 1, ''
    raw = None
    typed = {4: [], 5: [], 7: [], 10: []}   # float/int32/int64/double _data
    for f, wt, v in iter_fields(buf):
        if f == 1:                              # dims (repeated int64)
            dims.extend(_repeated_varints([v], [wt]))
        elif f == 2 and wt == _WT_VARINT:       # data_type
            dtype = v
        elif f == 8 and wt == _WT_LEN:          # name
            name = bytes(v).decode('utf-8')
        elif f == 9 and wt == _WT_LEN:          # raw_data
            raw = v
        elif f == 4 and wt == _WT_LEN:          # packed float_data
            typed[4].append(np.frombuffer(v, np.float32))
        elif f == 4 and wt == _WT_I32:
            typed[4].append(np.frombuffer(
                v.to_bytes(4, 'little'), np.float32))
        elif f == 5:                            # int32_data
            typed[5].extend(_repeated_varints([v], [wt]))
        elif f == 7:                            # int64_data
            typed[7].extend(_repeated_varints([v], [wt]))
        elif f == 10 and wt == _WT_LEN:         # packed double_data
            typed[10].append(np.frombuffer(v, np.float64))
        elif f == 10 and wt == _WT_I64:
            typed[10].append(np.frombuffer(
                v.to_bytes(8, 'little'), np.float64))
    np_dtype = _ONNX_DTYPES.get(dtype)
    if np_dtype is None:
        raise ValueError(f'tensor {name!r}: unsupported onnx dtype {dtype}')
    if raw is not None:
        arr = np.frombuffer(bytes(raw), np_dtype)
    elif typed[4]:
        arr = np.concatenate(typed[4]).astype(np_dtype, copy=False)
    elif typed[10]:
        arr = np.concatenate(typed[10]).astype(np_dtype, copy=False)
    elif typed[7]:
        arr = np.array(typed[7], np.int64).astype(np_dtype, copy=False)
    elif typed[5]:
        # int32_data carries int32/int16/int8/uint8/bool/float16 payloads;
        # per the ONNX spec float16 entries are raw uint16 BIT PATTERNS,
        # so they must be bit-cast, not value-cast.
        if np_dtype == np.float16:
            arr = np.array(typed[5], np.int64).astype(np.uint16)
            arr = arr.view(np.float16)
        else:
            arr = np.array(typed[5], np.int64).astype(np_dtype, copy=False)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims) if dims else arr


def onnx_initializers(data):
    """Extract {name: ndarray} for every initializer in a .onnx file."""
    graphs = [v for f, wt, v in iter_fields(data)
              if f == 7 and wt == _WT_LEN]     # ModelProto.graph
    if not graphs:
        raise ValueError('no GraphProto in ONNX model (field 7)')
    out = {}
    for g in graphs:
        for f, wt, v in iter_fields(g):
            if f == 5 and wt == _WT_LEN:       # GraphProto.initializer
                name, arr = _onnx_tensor(v)
                out[name] = arr
    return out


# ---------------------------------------------------------------------------
# TensorFlow GraphDef (frozen .pb)
# ---------------------------------------------------------------------------

# tensorflow DataType -> numpy
_TF_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 9: np.int64, 10: np.bool_, 17: np.uint16, 19: np.float16,
    22: np.uint32, 23: np.uint64,
}


def _tf_shape(buf):
    dims = []
    for f, wt, v in iter_fields(buf):          # TensorShapeProto.dim = 2
        if f == 2 and wt == _WT_LEN:
            for f2, wt2, v2 in iter_fields(v):  # Dim.size = 1
                if f2 == 1:
                    dims.extend(_repeated_varints([v2], [wt2]))
    return dims


def _tf_tensor(buf):
    """Decode a tensorflow TensorProto -> ndarray.

    Field numbers follow tensorflow's tensor.proto: dtype=1, shape=2,
    tensor_content=4, float_val=5, double_val=6, int_val=7, string_val=8,
    scomplex_val=9, int64_val=10, bool_val=11, half_val=13. Scalar and
    small constants are stored in the typed *_val fields (tensor_content
    is only used for larger arrays), so getting these numbers right is
    what makes the reference's released ssd_*_coco.pb files readable.
    """
    dtype, dims, content = 1, [], None
    floats, doubles, ints, halves = [], [], [], []
    for f, wt, v in iter_fields(buf):
        if f == 1 and wt == _WT_VARINT:         # dtype
            dtype = v
        elif f == 2 and wt == _WT_LEN:          # tensor_shape
            dims = _tf_shape(v)
        elif f == 4 and wt == _WT_LEN:          # tensor_content
            content = v
        elif f == 5:                            # float_val (packed or I32)
            if wt == _WT_LEN:
                floats.append(np.frombuffer(v, np.float32))
            else:
                floats.append(np.frombuffer(
                    v.to_bytes(4, 'little'), np.float32))
        elif f == 6:                            # double_val (packed or I64)
            if wt == _WT_LEN:
                doubles.append(np.frombuffer(v, np.float64))
            else:
                doubles.append(np.frombuffer(
                    v.to_bytes(8, 'little'), np.float64))
        elif f in (7, 10, 11):                  # int_val/int64_val/bool_val
            ints.extend(_repeated_varints([v], [wt]))
        elif f == 13:                           # half_val (uint16 bits)
            halves.extend(_repeated_varints([v], [wt]))
        # f == 8 string_val / f == 9 scomplex_val: unsupported, skipped
    np_dtype = _TF_DTYPES.get(dtype)
    if np_dtype is None:
        raise ValueError(f'unsupported tf dtype {dtype}')
    n = int(np.prod(dims)) if dims else 1
    if content is not None:
        arr = np.frombuffer(bytes(content), np_dtype)
    elif floats:
        arr = np.concatenate(floats).astype(np_dtype, copy=False)
    elif doubles:
        arr = np.concatenate(doubles).astype(np_dtype, copy=False)
    elif halves:
        # half_val carries raw float16 bit patterns in an int field
        arr = np.array(halves, np.uint16).view(np.float16)
        arr = arr.astype(np_dtype, copy=False)
    elif ints:
        arr = np.array(ints, np.int64).astype(np_dtype, copy=False)
    else:
        return np.zeros(dims, np_dtype)
    if arr.size == 1 and n > 1:
        arr = np.broadcast_to(arr, (n,))        # splat-encoded tensor
    return arr.reshape(dims) if dims else arr


def graphdef_constants(data):
    """Extract {node_name: ndarray} for every Const node in a frozen
    GraphDef. This is the complete weight set of a frozen inference graph
    (variables are converted to Consts at freeze time)."""
    out = {}
    for f, wt, node in iter_fields(data):
        if f != 1 or wt != _WT_LEN:             # GraphDef.node
            continue
        name, op, tensor = '', '', None
        for f2, wt2, v2 in iter_fields(node):
            if f2 == 1 and wt2 == _WT_LEN:      # NodeDef.name
                name = bytes(v2).decode('utf-8')
            elif f2 == 2 and wt2 == _WT_LEN:    # NodeDef.op
                op = bytes(v2).decode('utf-8')
            elif f2 == 5 and wt2 == _WT_LEN:    # NodeDef.attr (map entry)
                key, attr = '', None
                for f3, wt3, v3 in iter_fields(v2):
                    if f3 == 1 and wt3 == _WT_LEN:
                        key = bytes(v3).decode('utf-8')
                    elif f3 == 2 and wt3 == _WT_LEN:
                        attr = v3
                if key == 'value' and attr is not None:
                    for f4, wt4, v4 in iter_fields(attr):
                        if f4 == 8 and wt4 == _WT_LEN:  # AttrValue.tensor
                            tensor = v4
        if op == 'Const' and tensor is not None:
            try:
                out[name] = _tf_tensor(tensor)
            except ValueError:
                continue                        # non-numeric Const (string)
    return out

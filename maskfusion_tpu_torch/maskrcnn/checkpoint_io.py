"""The repository's Mask R-CNN checkpoint format, in numpy only.

Port of ``maskfusion_tpu/maskrcnn/checkpoint_io.py``: a flat float16 .npz of
the flax parameter tree, one array a "/"-joined path, plus a JSON
``__meta__``.  ``load_params`` returns the same nested tree of flax names
(float32) as the JAX package's; ``maskfusion_tpu_torch.convert.
maskrcnn_state_dict`` carries it into the port's model.  ``load_msgpack``
reads what ``flax.serialization.msgpack_serialize`` writes, without
msgpack or flax.
"""

from __future__ import annotations

import json
import struct

import numpy as np


def _flatten(params, prefix=""):
    out = {}
    if hasattr(params, "items"):
        for k, v in params.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(params)
    return out


def save_params(path: str, params, meta: dict | None = None):
    """Write a nested tree of arrays (flax names) as float16."""
    arrays = {k: v.astype(np.float16) for k, v in _flatten(params).items()}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_params(path: str):
    """Returns (nested float32 param dict, meta dict)."""
    meta = {}
    tree: dict = {}
    with np.load(path) as data:
        for k in data.files:
            if k == "__meta__":
                meta = json.loads(bytes(data[k]).decode())
                continue
            node = tree
            parts = k.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[k].astype(np.float32)
    return tree, meta


# ------------------------------------------------------------ flax msgpack
# flax/serialization.py: msgpack maps and arrays, with three ext types
# (_MsgpackExtType) whose payloads are msgpack themselves, and arrays above
# 2^30 bytes split into a map of flat chunks (_chunk)
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, buf = _unpackb(payload)
    if name == "bfloat16":              # numpy has no bfloat16: widen it
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape)


def _ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == _EXT_COMPLEX:
        re, im = _unpackb(payload)
        return complex(re, im)
    raise ValueError(f"msgpack ext type {code} is not flax's")


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_LENGTH = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H",
           0xdb: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I",
           0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
_CONST = {0xc0: None, 0xc2: False, 0xc3: True}


def _decode(buf: bytes, i: int):
    """One msgpack object at ``buf[i]``: (value, next index)."""
    b = buf[i]
    i += 1
    if b <= 0x7f:
        return b, i
    if b >= 0xe0:
        return b - 0x100, i
    if b in _CONST:
        return _CONST[b], i
    if b in _FIXED:
        fmt = _FIXED[b]
        return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)
    if 0xd4 <= b <= 0xd8:                        # fixext 1..16
        n = 1 << (b - 0xd4)
        return _ext(struct.unpack_from(">b", buf, i)[0],
                    bytes(buf[i + 1:i + 1 + n])), i + 1 + n
    kind = b & 0xf0
    if kind in (0x80, 0x90) or 0xa0 <= b <= 0xbf:
        n = b & (0x1f if b >= 0xa0 else 0x0f)
    elif b in _LENGTH:
        fmt = _LENGTH[b]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
    else:
        raise ValueError(f"not a msgpack type byte: {b:#x}")
    if 0xa0 <= b <= 0xbf or b in (0xd9, 0xda, 0xdb):         # str
        return bytes(buf[i:i + n]).decode(), i + n
    if b in (0xc4, 0xc5, 0xc6):                               # bin
        return bytes(buf[i:i + n]), i + n
    if b in (0xc7, 0xc8, 0xc9):                               # ext
        code = struct.unpack_from(">b", buf, i)[0]
        return _ext(code, bytes(buf[i + 1:i + 1 + n])), i + 1 + n
    if kind == 0x90 or b in (0xdc, 0xdd):                     # array
        out = []
        for _ in range(n):
            v, i = _decode(buf, i)
            out.append(v)
        return out, i
    out = {}                                                  # map
    for _ in range(n):
        k, i = _decode(buf, i)
        out[k], i = _decode(buf, i)
    return out, i


def _unpackb(buf: bytes):
    value, end = _decode(memoryview(buf), 0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} bytes after the msgpack object")
    return value


def _unchunk(tree):
    """flax's chunked array leaves back into arrays (_unchunk)."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)]
                  for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_msgpack(path: str):
    """The tree ``flax.serialization.msgpack_serialize`` wrote to ``path``
    (``msgpack_restore``'s result): nested dicts with numpy leaves (bfloat16
    widened to float32), lists for msgpack arrays."""
    with open(path, "rb") as f:
        return _unchunk(_unpackb(f.read()))

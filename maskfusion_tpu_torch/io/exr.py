"""Minimal OpenEXR scanline codec (read + write).

Copy of ``maskfusion_tpu/io/exr.py`` for the PyTorch port, code unchanged.
The Co-Fusion/MaskFusion datasets store depth as single-channel EXR
(Depth####.exr; ImageLogReader.cpp:249-270 reads them via OpenCV).  OpenCV
builds often lack EXR support, so this codec implements the subset of the
format those files use: scanline storage, NONE/ZIPS/ZIP compression,
HALF/FLOAT channels.  Reference: the OpenEXR 2.x file-format documentation
(openexr.com/en/latest/OpenEXRFileLayout.html).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = 20000630
_PIXELTYPE_SIZE = {0: 4, 1: 2, 2: 4}       # UINT, HALF, FLOAT
_PIXELTYPE_DTYPE = {0: np.uint32, 1: np.float16, 2: np.float32}
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP = 0, 1, 2, 3
_LINES_PER_BLOCK = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}


def _read_cstr(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\0", off)
    return buf[off:end].decode(), end + 1


def _unpredict(data: bytearray) -> bytearray:
    arr = np.frombuffer(bytes(data), np.uint8).astype(np.int64)
    arr = np.cumsum(arr - 128) + data[0] - (arr[0] - 128)
    # equivalent to: d[i] = d[i-1] + raw[i] - 128 with d[0] = raw[0]
    out = (arr & 0xFF).astype(np.uint8)
    return bytearray(out.tobytes())


def _predict(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8).astype(np.int16)
    diff = np.empty_like(arr)
    diff[0] = arr[0]
    diff[1:] = arr[1:] - arr[:-1] + 128
    return (diff & 0xFF).astype(np.uint8).tobytes()


def _deinterleave(data: bytes) -> bytes:
    n = len(data)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    src = np.frombuffer(data, np.uint8)
    out[0::2] = src[:half]
    out[1::2] = src[half:half + n // 2]
    return out.tobytes()


def _interleave(data: bytes) -> bytes:
    src = np.frombuffer(data, np.uint8)
    n = len(src)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[:half] = src[0::2]
    out[half:] = src[1::2]
    return out.tobytes()


def read_exr(path: str) -> Dict[str, np.ndarray]:
    """Returns {channel_name: (H, W) float32 array}."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise NotImplementedError("tiled EXR not supported")
    off = 8

    channels: List[Tuple[str, int]] = []
    compression = _COMP_NONE
    data_window = None
    while True:
        name, off = _read_cstr(buf, off)
        if not name:
            break
        attr_type, off = _read_cstr(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        payload = buf[off:off + size]
        off += size
        if name == "channels":
            coff = 0
            while payload[coff] != 0:
                cname, coff = _read_cstr(payload, coff)
                ptype = struct.unpack_from("<i", payload, coff)[0]
                coff += 16  # type, pLinear+pad, xSampling, ySampling
                channels.append((cname, ptype))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", payload)

    if compression not in _LINES_PER_BLOCK:
        raise NotImplementedError(f"EXR compression {compression} unsupported")
    x0, y0, x1, y1 = data_window
    W = x1 - x0 + 1
    H = y1 - y0 + 1
    lpb = _LINES_PER_BLOCK[compression]
    n_blocks = (H + lpb - 1) // lpb
    offsets = struct.unpack_from(f"<{n_blocks}q", buf, off)

    bytes_per_px = sum(_PIXELTYPE_SIZE[t] for _, t in channels)
    out = {c: np.empty((H, W), np.float32) for c, _ in channels}

    for bi, boff in enumerate(offsets):
        y, size = struct.unpack_from("<ii", buf, boff)
        payload = buf[boff + 8: boff + 8 + size]
        lines = min(lpb, H - (y - y0))
        raw_size = lines * W * bytes_per_px
        if compression == _COMP_NONE or size == raw_size:
            raw = payload
        else:
            raw = zlib.decompress(payload)
            raw = bytes(_unpredict(bytearray(raw)))
            raw = _deinterleave(raw)
        # per scanline, channels in file order (alphabetical)
        pos = 0
        for li in range(lines):
            yy = y - y0 + li
            for cname, ptype in channels:
                nbytes = W * _PIXELTYPE_SIZE[ptype]
                row = np.frombuffer(raw[pos:pos + nbytes],
                                    _PIXELTYPE_DTYPE[ptype])
                out[cname][yy] = row.astype(np.float32)
                pos += nbytes
    return out


def read_exr_depth(path: str) -> np.ndarray:
    """Depth convention of the reference reader (ImageLogReader.cpp:249-257):
    single channel, or first channel of RGB float images."""
    chans = read_exr(path)
    for pref in ("Y", "Z", "R", "B"):
        if pref in chans:
            return chans[pref]
    return next(iter(chans.values()))


def write_exr(path: str, channels: Dict[str, np.ndarray],
              compression: int = _COMP_ZIP, half: bool = False):
    """Scanline EXR writer (NONE or ZIP)."""
    names = sorted(channels)
    H, W = channels[names[0]].shape
    ptype = 1 if half else 2
    dtype = np.float16 if half else np.float32

    def attr(name: str, atype: str, payload: bytes) -> bytes:
        return (name.encode() + b"\0" + atype.encode() + b"\0"
                + struct.pack("<i", len(payload)) + payload)

    chan_payload = b""
    for n in names:
        chan_payload += (n.encode() + b"\0" + struct.pack("<i", ptype)
                         + struct.pack("<i", 0) + struct.pack("<ii", 1, 1))
    chan_payload += b"\0"

    dw = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = struct.pack("<ii", _MAGIC, 2)
    header += attr("channels", "chlist", chan_payload)
    header += attr("compression", "compression", bytes([compression]))
    header += attr("dataWindow", "box2i", dw)
    header += attr("displayWindow", "box2i", dw)
    header += attr("lineOrder", "lineOrder", b"\0")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    lpb = _LINES_PER_BLOCK[compression]
    n_blocks = (H + lpb - 1) // lpb
    blocks = []
    for bi in range(n_blocks):
        y = bi * lpb
        lines = min(lpb, H - y)
        raw = b""
        for li in range(lines):
            for n in names:
                raw += channels[n][y + li].astype(dtype).tobytes()
        if compression == _COMP_NONE:
            payload = raw
        else:
            packed = zlib.compress(_predict(_interleave(raw)))
            payload = packed if len(packed) < len(raw) else raw
        blocks.append((y, payload))

    offset_table_pos = len(header)
    data_start = offset_table_pos + 8 * n_blocks
    offsets = []
    pos = data_start
    for y, payload in blocks:
        offsets.append(pos)
        pos += 8 + len(payload)

    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{n_blocks}q", *offsets))
        for y, payload in blocks:
            f.write(struct.pack("<ii", y, len(payload)))
            f.write(payload)

"""Pure-Python TensorBoard event writer and reader — no TensorFlow and no
Pillow (a copy of ``text_to_image_tpu/utils/tensorboard.py`` whose PNG
encoder is written with ``zlib`` and ``struct``, so the port needs no image
library).

The reference logs scalars and sample-image summaries through
``tf.summary``/``FileWriter`` to TensorBoard (SURVEY.md §5.5).  This module
produces byte-compatible event files by hand-encoding the two formats
involved:

* **TFRecord framing**: ``len:uint64le  crc(len):uint32le  data
  crc(data):uint32le`` where crc is the *masked CRC32-C* (Castagnoli
  polynomial 0x82F63B78, mask rot-right-15 + 0xa282ead8).
* **Event protobuf** (``tensorflow.Event``): wall_time(1:double),
  step(2:int64), file_version(3:string) | summary(5:Summary);
  ``Summary.Value``: tag(1:string), simple_value(2:float),
  image(4:Image{height,width,colorspace,encoded_image_string}).

Only the scalar + image subset the reference uses is implemented; both are
loadable by stock TensorBoard.
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib
from typing import Optional

import numpy as np

# -- CRC32-C (Castagnoli), table-driven -------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf wire encoding ------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # proto int64 two's-complement
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _field_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _field_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _field_varint(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _field_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _encode_event(wall_time: float, step: int = 0,
                  file_version: Optional[str] = None,
                  summary: Optional[bytes] = None) -> bytes:
    out = _field_double(1, wall_time)
    if step:
        out += _field_varint(2, step)
    if file_version is not None:
        out += _field_bytes(3, file_version.encode())
    if summary is not None:
        out += _field_bytes(5, summary)
    return out


def _scalar_value(tag: str, value: float) -> bytes:
    return _field_bytes(1, tag.encode()) + _field_float(2, value)


def _image_value(tag: str, png: bytes, height: int, width: int,
                 channels: int) -> bytes:
    img = (_field_varint(1, height) + _field_varint(2, width)
           + _field_varint(3, channels) + _field_bytes(4, png))
    return _field_bytes(1, tag.encode()) + _field_bytes(4, img)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


_PNG_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}   # channels → grey, grey+α, RGB, RGBA


def encode_png(image: np.ndarray) -> bytes:
    """uint8 HWC array (C in 1..4) → PNG bytes: 8 bits a sample, every
    scanline with filter 0, one zlib stream in one IDAT chunk."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim == 2:
        image = image[:, :, None]
    h, w, c = image.shape
    if c not in _PNG_COLOR_TYPE:
        raise ValueError(f"PNG needs 1 to 4 channels, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           image.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


class TBEventWriter:
    """Writes ``events.out.tfevents.*`` files TensorBoard can load."""

    def __init__(self, log_dir: str, wall_time: Optional[float] = None):
        os.makedirs(log_dir, exist_ok=True)
        t = wall_time if wall_time is not None else time.time()
        host = socket.gethostname()
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(t)}.{host}")
        self._f = open(self.path, "ab")
        # every event file opens with a version record
        self._write_record(_encode_event(t, file_version="brain.Event:2"))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        summary = _field_bytes(1, _scalar_value(tag, float(value)))
        self._write_record(_encode_event(
            wall_time if wall_time is not None else time.time(),
            step=int(step), summary=summary))

    def add_image(self, tag: str, image: np.ndarray, step: int,
                  wall_time: Optional[float] = None) -> None:
        """image: uint8 [H, W, C] (C in {1, 3, 4})."""
        image = np.asarray(image)
        assert image.dtype == np.uint8 and image.ndim == 3, image.shape
        h, w, c = image.shape
        summary = _field_bytes(
            1, _image_value(tag, encode_png(image), h, w, c))
        self._write_record(_encode_event(
            wall_time if wall_time is not None else time.time(),
            step=int(step), summary=summary))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


# -- reader (tests + offline inspection; also documents the format) ---------


def read_events(path: str):
    """Parse an event file → list of dicts
    ``{wall_time, step, scalars: {tag: value}, images: {tag: png_bytes}}``.
    Validates both masked CRCs of every record."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return out
            if len(header) != 8:
                raise ValueError("truncated record header")
            (n,) = struct.unpack("<Q", header)
            (hc,) = struct.unpack("<I", f.read(4))
            if hc != _masked_crc(header):
                raise ValueError("header crc mismatch")
            data = f.read(n)
            (dc,) = struct.unpack("<I", f.read(4))
            if dc != _masked_crc(data):
                raise ValueError("data crc mismatch")
            out.append(_decode_event(data))


def _read_varint(buf: bytes, i: int):
    shift = v = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def _iter_fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, v


def _decode_event(data: bytes) -> dict:
    ev = {"wall_time": None, "step": 0, "file_version": None,
          "scalars": {}, "images": {}}
    for field, wire, v in _iter_fields(data):
        if field == 1 and wire == 1:
            ev["wall_time"] = struct.unpack("<d", v)[0]
        elif field == 2:
            ev["step"] = v
        elif field == 3:
            ev["file_version"] = v.decode()
        elif field == 5:
            for f2, w2, val in _iter_fields(v):  # Summary.value (repeated)
                if f2 != 1:
                    continue
                tag, scalar, png = None, None, None
                for f3, w3, v3 in _iter_fields(val):
                    if f3 == 1:
                        tag = v3.decode()
                    elif f3 == 2 and w3 == 5:
                        scalar = struct.unpack("<f", v3)[0]
                    elif f3 == 4 and w3 == 2:
                        for f4, _, v4 in _iter_fields(v3):
                            if f4 == 4:
                                png = v4
                if tag is not None and scalar is not None:
                    ev["scalars"][tag] = scalar
                if tag is not None and png is not None:
                    ev["images"][tag] = png
    return ev

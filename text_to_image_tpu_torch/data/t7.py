"""Minimal, dependency-free torch7 (.t7) binary deserializer (a copy of
``text_to_image_tpu/data/t7.py``).

The reference's embeddings ship as torch7 files from reedscot/icml2016
(SURVEY.md §2 "Preprocess scripts": char-CNN-RNN `.t7` embeddings).  The
usual reader is the `torchfile` pip package, which is not available in this
environment — and the format is simple enough to parse directly: a typed
little-endian record stream (the public torch7 `File:writeObject` format).

Supported records: nil, number, boolean, string, table, and torch Tensor /
Storage classes of every numeric dtype.  That covers embedding files; lua
functions are rejected with a clear error.

Layout (all ints int32 LE, longs int64 LE):
    object   := typeidx:int32 payload
    number   := float64
    string   := size:int32 bytes
    boolean  := int32 (0/1)
    table    := index:int32 size:int32 (key:object value:object)*size
    torch    := index:int32 version:string [classname:string]
                class-specific payload
    Tensor   := ndim:int32 size:int64[ndim] stride:int64[ndim]
                storageOffset:int64(1-based) storage:object
    Storage  := size:int64 data:dtype[size]

`index` memoizes shared/recursive references within one file.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Dict

import numpy as np

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5
TYPE_FUNCTION = 6
TYPE_LEGACY_RECUR_FUNCTION = 7
TYPE_RECUR_FUNCTION = 8

_TENSOR_DTYPES = {
    "torch.DoubleTensor": np.float64,
    "torch.FloatTensor": np.float32,
    "torch.HalfTensor": np.float16,
    "torch.LongTensor": np.int64,
    "torch.IntTensor": np.int32,
    "torch.ShortTensor": np.int16,
    "torch.CharTensor": np.int8,
    "torch.ByteTensor": np.uint8,
}
_STORAGE_DTYPES = {
    k.replace("Tensor", "Storage"): v for k, v in _TENSOR_DTYPES.items()
}


class T7ReadError(ValueError):
    pass


class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.memo: Dict[int, Any] = {}

    # -- primitives -------------------------------------------------------

    def _read(self, n: int) -> bytes:
        b = self.f.read(n)
        if len(b) != n:
            raise T7ReadError(f"truncated .t7: wanted {n} bytes, got {len(b)}")
        return b

    def read_int(self) -> int:
        return struct.unpack("<i", self._read(4))[0]

    def read_long(self) -> int:
        return struct.unpack("<q", self._read(8))[0]

    def read_double(self) -> float:
        return struct.unpack("<d", self._read(8))[0]

    def read_string(self) -> bytes:
        return self._read(self.read_int())

    def read_longs(self, n: int) -> np.ndarray:
        return np.frombuffer(self._read(8 * n), dtype="<i8")

    # -- objects ----------------------------------------------------------

    def read_object(self) -> Any:
        t = self.read_int()
        if t == TYPE_NIL:
            return None
        if t == TYPE_NUMBER:
            v = self.read_double()
            return int(v) if v.is_integer() else v
        if t == TYPE_BOOLEAN:
            return self.read_int() != 0
        if t == TYPE_STRING:
            raw = self.read_string()
            try:
                return raw.decode("utf-8")
            except UnicodeDecodeError:
                return raw
        if t == TYPE_TABLE:
            return self._read_table()
        if t == TYPE_TORCH:
            return self._read_torch()
        if t in (TYPE_FUNCTION, TYPE_RECUR_FUNCTION,
                 TYPE_LEGACY_RECUR_FUNCTION):
            raise T7ReadError("lua functions in .t7 files are not supported")
        raise T7ReadError(f"unknown .t7 type tag {t}")

    def _read_table(self) -> Any:
        index = self.read_int()
        if index in self.memo:
            return self.memo[index]
        table: Dict[Any, Any] = {}
        self.memo[index] = table  # before recursing: tables may self-reference
        for _ in range(self.read_int()):
            k = self.read_object()
            v = self.read_object()
            table[k] = v
        # lua arrays serialize as {1: v1, ..., n: vn} — return a list then
        if table and all(isinstance(k, int) for k in table):
            keys = sorted(table)
            if keys == list(range(1, len(keys) + 1)):
                lst = [table[k] for k in keys]
                self.memo[index] = lst
                return lst
        return table

    def _read_torch(self) -> Any:
        index = self.read_int()
        if index in self.memo:
            return self.memo[index]
        version = self.read_string()
        if version.startswith(b"V "):
            class_name = self.read_string().decode("ascii")
        else:  # pre-versioning files: the string IS the class name
            class_name = version.decode("ascii")
        if class_name in _TENSOR_DTYPES:
            obj = self._read_tensor(_TENSOR_DTYPES[class_name])
        elif class_name in _STORAGE_DTYPES:
            obj = self._read_storage(_STORAGE_DTYPES[class_name])
        else:
            raise T7ReadError(f"unsupported torch class {class_name!r} "
                              "(only Tensors/Storages are supported)")
        self.memo[index] = obj
        return obj

    def _read_tensor(self, dtype) -> np.ndarray:
        ndim = self.read_int()
        size = self.read_longs(ndim)
        stride = self.read_longs(ndim)
        offset = self.read_long() - 1  # torch storageOffset is 1-based
        storage = self.read_object()
        if ndim == 0 or storage is None:
            return np.empty((0,), dtype=dtype)
        itemsize = np.dtype(dtype).itemsize
        arr = np.lib.stride_tricks.as_strided(
            storage[offset:], shape=tuple(size),
            strides=tuple(int(s) * itemsize for s in stride))
        return np.ascontiguousarray(arr)

    def _read_storage(self, dtype) -> np.ndarray:
        n = self.read_long()
        return np.frombuffer(
            self._read(n * np.dtype(dtype).itemsize), dtype=dtype).copy()


def load_t7(path: str) -> Any:
    """Deserialize a torch7 binary file → nested Python objects
    (tensors become numpy arrays, tables become dicts/lists)."""
    with open(path, "rb") as f:
        return _Reader(f).read_object()

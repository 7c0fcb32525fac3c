"""The subset of MessagePack that flax writes (the JAX package's checkpoint
format, ``flax.serialization.msgpack_serialize`` / ``msgpack_restore``),
encoded and decoded here without ``msgpack`` or ``flax``.

What it carries:

- maps with ``str`` keys, arrays (lists), ``int``, ``float`` (float64),
  ``str``, ``bool``, ``None`` and ``bytes``, each in the smallest encoding
  MessagePack allows, as ``msgpack.packb(use_bin_type=True)`` picks it;
- ExtType 1, an ndarray: the MessagePack of ``(shape, dtype name, raw
  C-order bytes)``;
- ExtType 3, a numpy scalar (the same payload at shape ``()``);
- map keys in sorted order, as ``msgpack_serialize`` writes them;
- flax's chunked form of a leaf over ``MAX_CHUNK_SIZE`` bytes: a map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...}, "chunks":
  {"0": flat piece, ...}}``, written for array values of maps (and a bare
  array) as flax writes it, and turned back into one array on read.

Array leaves may be numpy arrays or CPU torch tensors.  ``bfloat16`` has no
numpy dtype here: a ``torch.bfloat16`` tensor is written through its uint16
view under the dtype name ``bfloat16``, and such a leaf reads back as a
``torch.bfloat16`` tensor; every other leaf reads back as a numpy array (a
read-only view of the input bytes, as flax returns it).

``encode`` yields the bytes piece by piece (array data is not copied
where it is contiguous) and ``write`` streams them to a file with their
crc32, so a large tree is never held twice; ``dumps`` joins them.
"""

from __future__ import annotations

import struct
import zlib
from typing import Any, Iterator

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30       # flax's chunking threshold, bytes per leaf
CHUNK_MARK = "__msgpack_chunked_array__"

# leaf dtypes the checkpoints hold (bfloat16 apart: no numpy dtype)
DTYPES = ("float32", "float16", "int32", "int64", "uint32", "uint8", "bool")
_TORCH_NAMES = {torch.float32: "float32", torch.float16: "float16",
                torch.int32: "int32", torch.int64: "int64",
                torch.uint8: "uint8", torch.bool: "bool",
                torch.bfloat16: "bfloat16"}


# ----------------------------------------------------------------------
# Encoding
# ----------------------------------------------------------------------

def _int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return bytes((x,))
    if x >= 0:
        for tag, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                              (0xce, ">I", 0xffffffff),
                              (0xcf, ">Q", 0xffffffffffffffff)):
            if x <= top:
                return bytes((tag,)) + struct.pack(fmt, x)
        raise OverflowError(f"integer {x} does not fit MessagePack")
    if x >= -32:
        return struct.pack(">b", x)
    for tag, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                          (0xd2, ">i", -0x80000000),
                          (0xd3, ">q", -0x8000000000000000)):
        if x >= low:
            return bytes((tag,)) + struct.pack(fmt, x)
    raise OverflowError(f"integer {x} does not fit MessagePack")


def _sized(n: int, fix: int | None, fix_max: int, tags) -> bytes:
    """The header of a str/bin/array/map of ``n`` items or bytes."""
    if fix is not None and n <= fix_max:
        return bytes((fix | n,))
    for tag, fmt, top in tags:
        if n <= top:
            return bytes((tag,)) + struct.pack(fmt, n)
    raise OverflowError(f"length {n} does not fit MessagePack")


_STR = ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff), (0xdb, ">I", 0xffffffff))
_BIN = ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff), (0xc6, ">I", 0xffffffff))
_ARRAY = ((0xdc, ">H", 0xffff), (0xdd, ">I", 0xffffffff))
_MAP = ((0xde, ">H", 0xffff), (0xdf, ">I", 0xffffffff))


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _sized(len(raw), 0xa0, 31, _STR) + raw


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        return bytes((fixed[n], code))
    for tag, fmt, top in ((0xc7, ">B", 0xff), (0xc8, ">H", 0xffff),
                          (0xc9, ">I", 0xffffffff)):
        if n <= top:
            return bytes((tag,)) + struct.pack(fmt, n) + bytes((code,))
    raise OverflowError(f"ext payload of {n} bytes does not fit MessagePack")


def _array_parts(x) -> tuple[tuple, str, memoryview]:
    """(shape, dtype name, C-order bytes) of an array leaf, no copy for a
    contiguous one."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError("serialize host tensors: copy the leaf to the "
                             "CPU first")
        name = _TORCH_NAMES.get(x.dtype)
        if name is None:
            raise ValueError(f"unsupported tensor dtype {x.dtype}")
        flat = x.detach().contiguous().reshape(-1).view(torch.uint8)
        return tuple(x.shape), name, memoryview(flat.numpy())
    arr = np.asarray(x)
    if arr.dtype.name not in DTYPES:
        raise ValueError(f"unsupported array dtype {arr.dtype}")
    flat = np.ascontiguousarray(arr).reshape(-1)
    return arr.shape, arr.dtype.name, memoryview(flat.view(np.uint8))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(x.nbytes)


def _itemsize(x) -> int:
    return x.element_size() if isinstance(x, torch.Tensor) else x.itemsize


def _chunk(x) -> dict:
    """flax's ``_chunk``: a leaf over MAX_CHUNK_SIZE as flat pieces."""
    size = max(1, int(MAX_CHUNK_SIZE / _itemsize(x)))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {CHUNK_MARK: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _pieces(x, sort: bool = True) -> Iterator:
    """The MessagePack of ``x``, piece by piece: an array leaf's bytes are
    produced (a contiguous copy only where the leaf is not contiguous) when
    its turn comes, so a writer streaming the pieces holds one at a time."""
    if x is None:
        yield b"\xc0"
    elif x is True:
        yield b"\xc3"
    elif x is False:
        yield b"\xc2"
    elif type(x) is int:
        yield _int(x)
    elif type(x) is float:
        yield b"\xcb" + struct.pack(">d", x)
    elif type(x) is str:
        yield _str(x)
    elif type(x) in (bytes, bytearray):
        yield _sized(len(x), None, 0, _BIN) + bytes(x)
    elif type(x) in (list, tuple):
        yield _sized(len(x), 0x90, 15, _ARRAY)
        for item in x:
            yield from _pieces(item, sort)
    elif type(x) is dict:
        yield _sized(len(x), 0x80, 15, _MAP)
        if any(type(k) is not str for k in x):
            raise TypeError("map keys must be str")
        for k, v in (sorted(x.items()) if sort else x.items()):
            yield _str(k)
            if _is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE:
                yield from _pieces(_chunk(v), sort=False)
            else:
                yield from _pieces(v, sort)
    elif _is_array(x) or isinstance(x, np.generic):
        code = EXT_NDARRAY if _is_array(x) else EXT_NPSCALAR
        shape, name, raw = _array_parts(x if _is_array(x) else np.asarray(x))
        head = (bytes((0x93,)) + _sized(len(shape), 0x90, 15, _ARRAY)
                + b"".join(_int(int(d)) for d in shape) + _str(name)
                + _sized(raw.nbytes, None, 0, _BIN))
        yield _ext_header(code, len(head) + raw.nbytes) + head
        yield raw
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def encode(tree) -> Iterator:
    """The MessagePack of ``tree`` as an iterator of byte pieces (bytes, or
    memoryviews of the array leaves' memory).  Map keys are written in
    sorted order, as ``msgpack_serialize`` writes them (it rebuilds the
    tree with ``jax.tree_util``, which sorts dict keys); the maps of a
    chunked leaf keep flax's own order."""
    if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _pieces(_chunk(tree), sort=False)
    return _pieces(tree)


def dumps(tree) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``'s bytes."""
    return b"".join(encode(tree))


def write(f, tree) -> tuple[int, int]:
    """Stream the MessagePack of ``tree`` into the binary file ``f``;
    returns (bytes written, their crc32)."""
    n = crc = 0
    for piece in encode(tree):
        f.write(piece)
        n += len(piece) if isinstance(piece, bytes) else piece.nbytes
        crc = zlib.crc32(piece, crc)
    return n, crc


# ----------------------------------------------------------------------
# Decoding
# ----------------------------------------------------------------------

class _Reader:
    def __init__(self, raw):
        self.buf = memoryview(raw).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated MessagePack input")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED_EXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_UINT = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q"}
_SINT = {0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LEN = {0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xc4: ">B", 0xc5: ">H",
        0xc6: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I",
        0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}


def _array_from(payload: memoryview):
    shape, name, raw = _read(_Reader(payload), view=True)
    shape = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(raw, np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    if name not in DTYPES:
        raise ValueError(f"unsupported array dtype {name!r} in the input")
    return np.frombuffer(raw, np.dtype(name)).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _read(r: _Reader, view: bool = False) -> Any:
    """One object; ``bin`` values as memoryviews of the input when
    ``view``, else as bytes."""
    b = r.take(1)[0]
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _read_map(r, b & 0x0f, view)
    if 0x90 <= b <= 0x9f:
        return [_read(r, view) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return str(r.take(b & 0x1f), "utf-8")
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in _UINT:
        return r.unpack(_UINT[b])
    if b in _SINT:
        return r.unpack(_SINT[b])
    if b == 0xca:
        return r.unpack(">f")
    if b == 0xcb:
        return r.unpack(">d")
    if b in (0xd9, 0xda, 0xdb):
        return str(r.take(r.unpack(_LEN[b])), "utf-8")
    if b in (0xc4, 0xc5, 0xc6):
        raw = r.take(r.unpack(_LEN[b]))
        return raw if view else bytes(raw)
    if b in (0xdc, 0xdd):
        return [_read(r, view) for _ in range(r.unpack(_LEN[b]))]
    if b in (0xde, 0xdf):
        return _read_map(r, r.unpack(_LEN[b]), view)
    if b in _FIXED_EXT or b in (0xc7, 0xc8, 0xc9):
        n = _FIXED_EXT[b] if b in _FIXED_EXT else r.unpack(_LEN[b])
        code = r.take(1)[0]
        payload = r.take(n)
        if code == EXT_NDARRAY:
            return _array_from(payload)
        if code == EXT_NPSCALAR:
            arr = _array_from(payload)
            return arr.reshape(()).item() if isinstance(
                arr, torch.Tensor) else arr[()]
        raise ValueError(f"unsupported MessagePack ext type {code}")
    raise ValueError(f"unsupported MessagePack byte 0x{b:02x}")


def _read_map(r: _Reader, n: int, view: bool) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r, view)
        out[key] = _read(r, view)
    if CHUNK_MARK in out:
        return _unchunk(out)
    return out


def loads(raw) -> Any:
    """``flax.serialization.msgpack_restore(raw)``: the tree, with ndarray
    leaves as numpy arrays viewing ``raw`` (bfloat16 leaves as torch
    tensors) and flax-chunked leaves joined back into one array."""
    r = _Reader(raw)
    out = _read(r)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes after the "
                         "MessagePack object")
    return out

"""Flax msgpack checkpoints without flax or the ``msgpack`` package.

``flax.serialization.to_bytes`` writes a state dict (nested maps with
string keys) as msgpack, with three extension types:

  - 1, ndarray: the msgpack of ``(shape, dtype name, C-order bytes)``;
  - 2, complex: the msgpack of ``(real, imag)``;
  - 3, numpy scalar: an ndarray of shape ``()``.

An array above ``MAX_CHUNK_BYTES`` is written as a map
``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...}, "chunks":
{"0": flat piece, ...}}`` of flat pieces of at most that many bytes.

:func:`loads`/:func:`load` read such bytes into nested dicts with numpy
leaves (a ``bfloat16`` array comes back as a ``torch.bfloat16`` tensor,
since numpy has no such dtype); :func:`dumps`/:func:`dump` write nested
dicts of numpy arrays or torch tensors, str, bytes, int, float, bool,
None and lists, in the form flax reads.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple, Union

import numpy as np
import torch

MAX_CHUNK_BYTES = 2**30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

_TORCH_NAMES = {torch.float32: "float32", torch.float16: "float16",
                torch.float64: "float64", torch.bfloat16: "bfloat16",
                torch.int64: "int64", torch.int32: "int32",
                torch.int16: "int16", torch.int8: "int8",
                torch.uint8: "uint8", torch.bool: "bool"}


# -- reading -------------------------------------------------------------------

class _Reader:
    """Decodes one msgpack object; ``bin`` payloads come back as bytes, or
    as views of ``data`` with ``copy_bin=False`` (an array's payload)."""

    def __init__(self, data, copy_bin: bool = True):
        self.buf = memoryview(data)
        self.pos = 0
        self.copy_bin = copy_bin

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n)) if self.copy_bin else self.take(n)
            return getattr(self, kind)(n)
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _EXT:
            return self.ext(self.unpack(_EXT[b]))
        raise ValueError(f"msgpack byte 0x{b:02x} is not a known type")

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def array(self, n: int) -> List[Any]:
        return [self.read() for _ in range(n)]

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_NPSCALAR:
            arr = _ndarray(data)
            return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
        if code == EXT_COMPLEX:
            real, imag = _Reader(data).read()
            return complex(real, imag)
        raise ValueError(f"msgpack ext type {code} is not a flax type")


_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


def _ndarray(data) -> Union[np.ndarray, torch.Tensor]:
    """An ndarray extension's payload: ``(shape, dtype name, bytes)``."""
    shape, name, raw = _Reader(data, copy_bin=False).read()
    if isinstance(name, (bytes, memoryview)):
        name = bytes(name).decode()
    if name == "bfloat16":
        flat = np.frombuffer(raw, dtype=np.int16)
        return torch.from_numpy(flat.copy()).view(torch.bfloat16).reshape(
            shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _unchunk(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if node.get(CHUNKED) is True:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def loads(data) -> Any:
    """The tree of flax msgpack bytes, chunked arrays joined."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("bytes left after the msgpack object")
    return _unchunk(tree)


def load(path: Union[str, Path]) -> Any:
    return loads(Path(path).read_bytes())


# -- writing -------------------------------------------------------------------

def _header(small: int, limits: Tuple[Tuple[int, int, str], ...], n: int,
            fix_max: int) -> bytes:
    """A length header: the fix form below ``fix_max``, else the first of
    ``limits`` (marker, largest length, struct format) that holds n."""
    if n < fix_max:
        return bytes([small | n])
    for marker, largest, fmt in limits:
        if n <= largest:
            return bytes([marker]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _int(x: int) -> bytes:
    """The shortest msgpack integer, in the order msgpack-python picks."""
    if 0 <= x < 0x80:
        return bytes([x])
    if -32 <= x < 0:
        return struct.pack(">b", x)
    for marker, lo, hi, fmt in ((0xCC, 0, 0xFF, ">B"),
                                (0xD0, -0x80, 0x7F, ">b"),
                                (0xCD, 0, 0xFFFF, ">H"),
                                (0xD1, -0x8000, 0x7FFF, ">h"),
                                (0xCE, 0, 0xFFFFFFFF, ">I"),
                                (0xD2, -2**31, 2**31 - 1, ">i"),
                                (0xCF, 0, 2**64 - 1, ">Q"),
                                (0xD3, -2**63, 2**63 - 1, ">q")):
        if lo <= x <= hi:
            return bytes([marker]) + struct.pack(fmt, x)
    raise ValueError(f"integer {x} does not fit msgpack")


_MAP = ((0xDE, 0xFFFF, ">H"), (0xDF, 0xFFFFFFFF, ">I"))
_ARRAY = ((0xDC, 0xFFFF, ">H"), (0xDD, 0xFFFFFFFF, ">I"))
_STR = ((0xD9, 0xFF, ">B"), (0xDA, 0xFFFF, ">H"), (0xDB, 0xFFFFFFFF, ">I"))
_BIN = ((0xC4, 0xFF, ">B"), (0xC5, 0xFFFF, ">H"), (0xC6, 0xFFFFFFFF, ">I"))


def _bin_header(n: int) -> bytes:
    for marker, largest, fmt in _BIN:
        if n <= largest:
            return bytes([marker]) + struct.pack(fmt, n)
    raise ValueError(f"bin object of {n} bytes is too long")


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = next(bytes([m]) + struct.pack(f, n)
                    for m, largest, f in ((0xC7, 0xFF, ">B"),
                                          (0xC8, 0xFFFF, ">H"),
                                          (0xC9, 0xFFFFFFFF, ">I"))
                    if n <= largest)
    return head + struct.pack(">b", code)


def _as_numpy(x) -> Tuple[Tuple[int, ...], str, memoryview]:
    """(shape, dtype name, C-order bytes) of an array or tensor."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype not in _TORCH_NAMES:
            raise ValueError(f"tensor dtype {t.dtype} has no flax name")
        name = _TORCH_NAMES[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.numpy()
    else:
        arr = np.asarray(x)  # ascontiguousarray would make a scalar 1-D
        if not arr.flags.c_contiguous:
            arr = arr.copy(order="C")
        if arr.dtype.hasobject:
            raise ValueError("object arrays cannot be written")
        name = arr.dtype.name
    return tuple(arr.shape), name, memoryview(arr.reshape(-1).view(np.uint8))


class _Writer:
    def __init__(self, emit: Callable[[Any], None], max_chunk_bytes: int):
        self.emit = emit
        self.max_chunk_bytes = max_chunk_bytes

    def write(self, x: Any) -> None:
        emit = self.emit
        if x is None:
            emit(b"\xc0")
        elif isinstance(x, (bool, np.bool_)):
            emit(b"\xc3" if x else b"\xc2")
        elif isinstance(x, int):
            emit(_int(x))
        elif isinstance(x, float):
            emit(b"\xcb" + struct.pack(">d", x))
        elif isinstance(x, complex):
            payload = (b"\x92" + b"\xcb" + struct.pack(">d", x.real)
                       + b"\xcb" + struct.pack(">d", x.imag))
            emit(_ext_header(EXT_COMPLEX, len(payload)) + payload)
        elif isinstance(x, str):
            raw = x.encode("utf-8")
            emit(_header(0xA0, _STR, len(raw), 32) + raw)
        elif isinstance(x, (bytes, bytearray, memoryview)):
            emit(_bin_header(len(x)))
            emit(x)
        elif isinstance(x, dict):
            # in sorted key order, as flax's tree_map copy leaves them
            for key in x:
                if not isinstance(key, str):
                    raise ValueError(f"map key {key!r} is not a str")
            self.map(sorted(x.items()))
        elif isinstance(x, (list, tuple)):
            emit(_header(0x90, _ARRAY, len(x), 16))
            for item in x:
                self.write(item)
        elif isinstance(x, np.generic):
            self.array(np.asarray(x), EXT_NPSCALAR)
        elif isinstance(x, (np.ndarray, torch.Tensor)):
            nbytes = x.numel() * x.element_size() if isinstance(
                x, torch.Tensor) else x.nbytes
            if nbytes > self.max_chunk_bytes:
                self.chunked(x)
            else:
                self.array(x, EXT_NDARRAY)
        else:
            raise ValueError(f"cannot write {type(x).__name__} as msgpack")

    def array(self, x, code: int) -> None:
        shape, name, raw = _as_numpy(x)
        pieces: List[bytes] = []
        inner = _Writer(pieces.append, self.max_chunk_bytes)
        pieces.append(b"\x93")  # (shape, dtype name, bytes)
        inner.write(list(shape))
        inner.write(name)
        pieces.append(_bin_header(len(raw)))
        head = b"".join(pieces)
        self.emit(_ext_header(code, len(head) + len(raw)) + head)
        self.emit(raw)

    def map(self, items) -> None:
        self.emit(_header(0x80, _MAP, len(items), 16))
        for key, value in items:
            self.write(key)
            self.write(value)

    def chunked(self, x) -> None:
        """The chunked form; its maps keep flax's insertion order."""
        itemsize = x.element_size() if isinstance(x, torch.Tensor) \
            else x.dtype.itemsize
        size = max(1, self.max_chunk_bytes // itemsize)
        flat = x.reshape(-1)
        self.emit(_header(0x80, _MAP, 3, 16))
        self.write(CHUNKED)
        self.write(True)
        self.write("shape")
        self.map([(str(i), int(d)) for i, d in enumerate(x.shape)])
        self.write("chunks")
        self.map([(str(i), flat[s:s + size]) for i, s in
                  enumerate(range(0, flat.shape[0], size))])


def dumps(tree: Any, max_chunk_bytes: int = MAX_CHUNK_BYTES) -> bytes:
    """Flax msgpack bytes of ``tree``; arrays above ``max_chunk_bytes``
    are written in the chunked form."""
    pieces: List[Any] = []
    _Writer(pieces.append, max_chunk_bytes).write(tree)
    return b"".join(pieces)


def dump(tree: Any, path: Union[str, Path],
         max_chunk_bytes: int = MAX_CHUNK_BYTES) -> None:
    """Write ``tree`` to ``path`` as :func:`dumps` would, streaming each
    array's bytes to the file instead of joining them in memory."""
    with open(path, "wb") as f:
        _Writer(f.write, max_chunk_bytes).write(tree)

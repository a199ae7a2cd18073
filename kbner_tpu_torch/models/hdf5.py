"""A reader of HDF5 files, in numpy alone, for the layouts that ``h5py``
writes by default (HDF5 file format specification 3.0, the parts named
below); :meth:`~.embedders.ELMoEmbedder.load_hdf5` reads ELMo weight
files with it, without ``h5py``.

What it reads:
  - superblock versions 0 and 1, any size of offsets and lengths;
  - version 1 object headers, their continuation blocks included;
  - groups stored as symbol tables: a version 1 B-tree of type 0, its
    ``SNOD`` leaves and the group's local ``HEAP`` of link names;
  - datasets: the dataspace (simple or scalar), the datatype (little- or
    big-endian IEEE floats of 2, 4 or 8 bytes, signed or unsigned
    integers of 1, 2, 4 or 8 bytes) and the layout (version 1 to 3:
    compact, contiguous, or chunked without filters, its chunks found
    through a version 1 B-tree of type 1).

Anything else raises :class:`HDF5Error`, naming the object and the
structure met there: a filter pipeline (compression), version 2 object
headers or superblocks, groups of the newer link storage, an external
or virtual layout, storage never written. The reader never makes up
data.

    with HDF5File(path) as f:
        f.keys()                      # the root group's member names
        "CNN/W_cnn_0" in f
        arr = f["CNN/W_cnn_0"][()]   # a numpy array of its own memory
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
# object header message types
MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE = 0x0001, 0x0002, 0x0003
MSG_LINK, MSG_EXTERNAL, MSG_LAYOUT = 0x0006, 0x0007, 0x0008
MSG_FILTERS, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0x000B, 0x0010, 0x0011


class HDF5Error(ValueError):
    """A structure this reader does not read, or a malformed file."""


class _Reader:
    """Little-endian fields at absolute addresses of one open file."""

    def __init__(self, fh, size_offsets: int = 8, size_lengths: int = 8,
                 base: int = 0):
        self.fh = fh
        self.so = size_offsets
        self.sl = size_lengths
        self.base = base  # addresses count from the base address
        self.undefined = (1 << (8 * size_offsets)) - 1

    def bytes(self, addr: int, n: int) -> bytes:
        self.fh.seek(self.base + addr)
        out = self.fh.read(n)
        if len(out) != n:
            raise HDF5Error(f"the file ends inside {n} bytes at {addr}")
        return out

    @staticmethod
    def uint(buf: bytes, pos: int, n: int) -> int:
        return int.from_bytes(buf[pos:pos + n], "little")


class Dataset:
    """A dataset's shape, dtype and storage; ``ds[()]`` (or
    ``np.asarray(ds)``) reads it."""

    def __init__(self, file: "HDF5File", name: str, messages):
        self.file = file
        self.name = name
        self._messages = messages
        self.shape = _dataspace(
            self._one(messages, MSG_DATASPACE, "dataspace"), file._rd.sl,
            name)
        self.dtype = _datatype(self._one(messages, MSG_DATATYPE, "datatype"),
                               name)
        if any(t == MSG_FILTERS for t, _ in messages):
            raise HDF5Error(f"dataset {name!r}: a filter pipeline "
                            "(compressed or filtered storage) is not read")
        if any(t == MSG_EXTERNAL for t, _ in messages):
            raise HDF5Error(f"dataset {name!r}: external storage is not read")
        self._layout = self._one(messages, MSG_LAYOUT, "layout")

    def _one(self, messages, kind: int, what: str) -> bytes:
        for t, body in messages:
            if t == kind:
                return body
        raise HDF5Error(f"dataset {self.name!r} has no {what} message")

    def __getitem__(self, key) -> np.ndarray:
        if key != () and key != Ellipsis:
            raise TypeError("only ds[()] or ds[...] is read")
        return self.read()

    def __array__(self, dtype=None, copy=None):
        arr = self.read()
        return arr if dtype is None else arr.astype(dtype)

    def read(self) -> np.ndarray:
        rd = self.file._rd
        body = self._layout
        version = body[0]
        n = int(np.prod(self.shape, dtype=np.int64))
        nbytes = n * self.dtype.itemsize
        if version in (1, 2):
            ndims, cls = body[1], body[2]
            pos = 8
            if cls == 0:  # compact: dims, then the raw data's size and data
                pos += 4 * ndims
                size = _Reader.uint(body, pos, 4)
                return self._from(body[pos + 4:pos + 4 + size], n)
            addr = _Reader.uint(body, pos, rd.so)
            pos += rd.so
            dims = [_Reader.uint(body, pos + 4 * i, 4) for i in range(ndims)]
            if cls == 1:
                return self._contiguous(addr, nbytes, n)
            if cls == 2:
                return self._chunked(addr, dims)
            raise HDF5Error(f"dataset {self.name!r}: layout class {cls} "
                            "is not read")
        if version == 3:
            cls = body[1]
            if cls == 0:
                size = _Reader.uint(body, 2, 2)
                return self._from(body[4:4 + size], n)
            if cls == 1:
                return self._contiguous(_Reader.uint(body, 2, rd.so),
                                        nbytes, n)
            if cls == 2:
                ndims = body[2]
                addr = _Reader.uint(body, 3, rd.so)
                pos = 3 + rd.so
                dims = [_Reader.uint(body, pos + 4 * i, 4)
                        for i in range(ndims)]
                return self._chunked(addr, dims)
            raise HDF5Error(f"dataset {self.name!r}: layout class {cls} "
                            "(virtual) is not read")
        raise HDF5Error(f"dataset {self.name!r}: layout message version "
                        f"{version} is not read")

    def _from(self, raw: bytes, n: int, shape=None) -> np.ndarray:
        """``n`` elements of ``raw`` in native byte order, of their own
        memory, shaped as the dataset (or ``shape``)."""
        if len(raw) < n * self.dtype.itemsize:
            raise HDF5Error(f"dataset {self.name!r}: {len(raw)} bytes of "
                            f"data for {n} elements")
        arr = np.frombuffer(raw, self.dtype, count=n).reshape(
            self.shape if shape is None else shape)
        return arr.astype(self.dtype.newbyteorder("="))

    def _contiguous(self, addr: int, nbytes: int, n: int) -> np.ndarray:
        if addr == self.file._rd.undefined:
            if n == 0:
                return np.zeros(self.shape, self.dtype.newbyteorder("="))
            raise HDF5Error(f"dataset {self.name!r}: its storage was never "
                            "written")
        return self._from(self.file._rd.bytes(addr, nbytes), n)

    def _chunked(self, btree: int, dims: List[int]) -> np.ndarray:
        """Every chunk found through the dataset's B-tree, placed at its
        offsets; chunks at the edges are cut to the dataset."""
        rank = len(self.shape)
        chunk = tuple(dims[:rank])  # the last dimension is the element size
        out = np.empty(self.shape, self.dtype.newbyteorder("="))
        filled = np.zeros(self.shape, bool)
        csize = int(np.prod(chunk, dtype=np.int64)) * self.dtype.itemsize
        for offsets, addr, nbytes, fmask in _chunk_entries(
                self.file._rd, btree, rank + 1, self.name):
            if fmask or nbytes != csize:
                raise HDF5Error(
                    f"dataset {self.name!r}: a chunk of {nbytes} bytes with "
                    f"filter mask {fmask} (filtered chunks are not read)")
            data = self._from(self.file._rd.bytes(addr, csize),
                              int(np.prod(chunk, dtype=np.int64)), chunk)
            sl = tuple(slice(o, min(o + c, s))
                       for o, c, s in zip(offsets, chunk, self.shape))
            out[sl] = data[tuple(slice(0, s.stop - s.start) for s in sl)]
            filled[sl] = True
        if not filled.all():
            raise HDF5Error(f"dataset {self.name!r}: chunks never written "
                            f"({int((~filled).sum())} elements)")
        return out


class Group:
    """A group's members by name (``keys()``, ``g[name]``, ``in``); a
    name may be a path of ``/``-separated parts."""

    def __init__(self, file: "HDF5File", name: str, links: Dict[str, int]):
        self.file = file
        self.name = name
        self._links = links

    def keys(self) -> List[str]:
        return list(self._links)

    def __iter__(self):
        return iter(self._links)

    def _get(self, path: str):
        node = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group) or part not in node._links:
                return None
            child = f"{node.name.rstrip('/')}/{part}"
            node = self.file._object(node._links[part], child)
        return node

    def __contains__(self, path: str) -> bool:
        return self._get(path) is not None

    def __getitem__(self, path: str):
        node = self._get(path)
        if node is None:
            raise KeyError(f"{path!r} is not in {self.name!r}")
        return node


class HDF5File(Group):
    """An HDF5 file open for reading; the root group."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self._fh = open(self.path, "rb")
        try:
            rd, root = self._superblock()
        except BaseException:
            self._fh.close()
            raise
        self._rd = rd
        self._cache: Dict[int, object] = {}
        super().__init__(self, "/", self._links_of(root, "/"))

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "HDF5File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _superblock(self) -> Tuple[_Reader, int]:
        """The reader's field sizes and the root group's object header
        address. The superblock sits at 0 or at 512, 1024, ... bytes."""
        size = self.path.stat().st_size
        base = 0
        while True:
            if base + 8 > size:
                raise HDF5Error(f"{self.path}: no HDF5 signature")
            self._fh.seek(base)
            if self._fh.read(8) == SIGNATURE:
                break
            base = 512 if base == 0 else 2 * base
        head = _Reader(self._fh).bytes(base, 24)
        version = head[8]
        if version not in (0, 1):
            raise HDF5Error(f"{self.path}: superblock version {version} "
                            "(written with libver='latest') is not read")
        so, sl = head[13], head[14]
        pos = base + 24 + (4 if version == 1 else 0)
        # the superblock's four addresses (the base address first), then
        # the root group's symbol table entry
        fields = _Reader(self._fh).bytes(pos, 4 * so + 2 * so + 8 + 16)
        rd = _Reader(self._fh, so, sl, base=_Reader.uint(fields, 0, so))
        return rd, _Reader.uint(fields, 4 * so + so, so)

    def _object(self, addr: int, name: str):
        if addr not in self._cache:
            messages = self._messages(addr, name)
            kinds = {t for t, _ in messages}
            if MSG_SYMBOL_TABLE in kinds or MSG_LINK_INFO in kinds \
                    or MSG_LINK in kinds:
                obj = Group(self, name, self._links_of(addr, name, messages))
            elif MSG_LAYOUT in kinds:
                obj = Dataset(self, name, messages)
            else:
                raise HDF5Error(f"object {name!r} is neither a group nor a "
                                "dataset this reader knows")
            self._cache[addr] = obj
        return self._cache[addr]

    def _messages(self, addr: int, name: str) -> List[Tuple[int, bytes]]:
        """Every message of a version 1 object header, continuation
        blocks included, as (type, body)."""
        rd = self._rd
        head = rd.bytes(addr, 16)
        if head[:4] == b"OHDR":
            raise HDF5Error(f"object {name!r}: version 2 object headers "
                            "(written with libver='latest') are not read")
        if head[0] != 1:
            raise HDF5Error(f"object {name!r}: object header version "
                            f"{head[0]} is not read")
        n_msgs = _Reader.uint(head, 2, 2)
        blocks = [(addr + 16, _Reader.uint(head, 8, 4))]
        out: List[Tuple[int, bytes]] = []
        while blocks and len(out) < n_msgs:
            start, length = blocks.pop(0)
            buf = rd.bytes(start, length)
            pos = 0
            while pos + 8 <= length and len(out) < n_msgs:
                kind = _Reader.uint(buf, pos, 2)
                size = _Reader.uint(buf, pos + 2, 2)
                body = buf[pos + 8:pos + 8 + size]
                if buf[pos + 4] & 0x02 and kind != MSG_CONTINUATION:
                    raise HDF5Error(f"object {name!r}: a shared message of "
                                    f"type {kind:#x} is not read")
                pos += 8 + size
                if kind == MSG_CONTINUATION:
                    blocks.append((_Reader.uint(body, 0, rd.so),
                                   _Reader.uint(body, rd.so, rd.sl)))
                out.append((kind, body))
        return out

    def _links_of(self, addr: int, name: str,
                  messages=None) -> Dict[str, int]:
        """A symbol-table group's members: name -> object header address."""
        rd = self._rd
        messages = messages if messages is not None else self._messages(
            addr, name)
        table = [body for t, body in messages if t == MSG_SYMBOL_TABLE]
        if not table:
            raise HDF5Error(f"group {name!r}: link messages or dense link "
                            "storage (the newer group format) are not read")
        btree = _Reader.uint(table[0], 0, rd.so)
        heap = _Reader.uint(table[0], rd.so, rd.so)
        hp = rd.bytes(heap, 8 + 2 * rd.sl + rd.so)
        if hp[:4] != b"HEAP":
            raise HDF5Error(f"group {name!r}: no local heap at {heap}")
        seg_size = _Reader.uint(hp, 8, rd.sl)
        seg_addr = _Reader.uint(hp, 8 + 2 * rd.sl, rd.so)
        names = rd.bytes(seg_addr, seg_size)
        links: Dict[str, int] = {}
        for snod in _group_leaves(rd, btree, name):
            sn = rd.bytes(snod, 8)
            if sn[:4] != b"SNOD":
                raise HDF5Error(f"group {name!r}: no symbol node at {snod}")
            count = _Reader.uint(sn, 6, 2)
            width = 2 * rd.so + 8 + 16
            entries = rd.bytes(snod + 8, count * width)
            for i in range(count):
                e = entries[i * width:(i + 1) * width]
                off = _Reader.uint(e, 0, rd.so)
                end = names.index(b"\0", off)
                links[names[off:end].decode("utf-8")] = _Reader.uint(
                    e, rd.so, rd.so)
        return links


def _btree_node(rd: _Reader, addr: int, kind: int, key_size: int,
                name: str):
    """(level, keys, children) of a version 1 B-tree node of ``kind``."""
    head = rd.bytes(addr, 8 + 2 * rd.so)
    if head[:4] != b"TREE" or head[4] != kind:
        raise HDF5Error(f"{name!r}: no B-tree node of type {kind} at {addr}")
    level = head[5]
    used = _Reader.uint(head, 6, 2)
    body = rd.bytes(addr + 8 + 2 * rd.so,
                    used * (key_size + rd.so) + key_size)
    keys, children = [], []
    pos = 0
    for _ in range(used):
        keys.append(body[pos:pos + key_size])
        children.append(_Reader.uint(body, pos + key_size, rd.so))
        pos += key_size + rd.so
    return level, keys, children


def _group_leaves(rd: _Reader, addr: int, name: str) -> List[int]:
    """The symbol node addresses under a group's B-tree, in key order."""
    level, _, children = _btree_node(rd, addr, 0, rd.sl, name)
    if level == 0:
        return children
    return [leaf for c in children for leaf in _group_leaves(rd, c, name)]


def _chunk_entries(rd: _Reader, addr: int, ndims: int, name: str):
    """(offsets, address, size, filter mask) of every chunk under a
    dataset's B-tree."""
    key_size = 8 + 8 * ndims
    level, keys, children = _btree_node(rd, addr, 1, key_size, name)
    for key, child in zip(keys, children):
        if level > 0:
            yield from _chunk_entries(rd, child, ndims, name)
            continue
        size, fmask = struct.unpack_from("<II", key, 0)
        offsets = struct.unpack_from(f"<{ndims}Q", key, 8)[:-1]
        yield offsets, child, size, fmask


def _dataspace(body: bytes, sl: int, name: str) -> Tuple[int, ...]:
    version, rank = body[0], body[1]
    if version == 1:
        pos = 8
    elif version == 2:
        if body[3] == 2:
            raise HDF5Error(f"dataset {name!r}: a null dataspace holds no "
                            "data")
        pos = 4
    else:
        raise HDF5Error(f"dataset {name!r}: dataspace version {version} "
                        "is not read")
    return tuple(_Reader.uint(body, pos + sl * i, sl) for i in range(rank))


def _datatype(body: bytes, name: str) -> np.dtype:
    cls = body[0] & 0x0F
    bits = body[1]
    size = _Reader.uint(body, 4, 4)
    order = ">" if bits & 1 else "<"
    if cls == 0 and size in (1, 2, 4, 8):  # fixed point
        return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1 and size in (2, 4, 8) and not bits & 0x40:  # IEEE float
        return np.dtype(f"{order}f{size}")
    raise HDF5Error(f"dataset {name!r}: datatype class {cls} of {size} "
                    f"bytes (flags {bits:#x}) is not read")

"""HDF5 files in pure Python (numpy and zlib): the port's reader and writer
of its data files, with a small h5py-shaped interface.

The port's H5 files (``data/synthetic.py``, ``dataprep/pipeline.py``,
``dataprep/esm.py``) go through this module alone, so the port needs no
``h5py``; the machine with the card has none.

Reading. It reads what ``h5py.File(path, "w")`` writes by default
(HDF5's earliest file format) for the repository's schema:
- superblock version 0, 8-byte offsets and lengths;
- version-1 object headers, continuation messages;
- symbol-table groups (v1 B-tree of type 0, local heap, SNOD nodes);
- dataspaces, scalar and simple (versions 1 and 2);
- little-endian IEEE floats and two's-complement integers, and
  variable-length UTF-8 strings, whose bytes lie in global heap
  collections;
- compact, contiguous and chunked layouts (layout version 3), the chunks
  indexed by a v1 B-tree of type 1 and stored plain or through the
  deflate filter;
- attribute messages (versions 1 to 3);
- fill values: storage never written (a contiguous dataset without an
  address, chunks missing from the index) reads as zeros where the fill
  value is zero, the library default.
Anything else raises ``UnsupportedH5`` and names the feature: an object
header message of another type, an external data file, storage left
unwritten under a nonzero fill value. Nothing is guessed.

Writing. It writes a subset of the same format that h5py and HDF5 read
back as written: superblock 0, version-1 object headers, symbol-table
groups, contiguous datasets, or with ``compression="gzip"`` the dataset
as one chunk through the deflate filter (level 4, h5py's default; h5py
picks smaller chunks), variable-length UTF-8 strings in one global heap
collection, attributes; ``create_dataset`` takes no other storage
option (chunks, shuffle, ...). Modes ``"w"`` and ``"a"`` write the file on
close, ``"a"`` after reading the whole of it, each dataset compressed as it
was (the files are small); an error inside the ``with`` block leaves the
file as it was.

Values come back as h5py gives them: a dataset's ``[()]`` / ``[:]`` is a
numpy array (a scalar string dataset gives ``bytes``); an attribute is a
numpy scalar or array, or ``str`` for a string.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Iterator, Optional, Union

import numpy as np

__all__ = ["File", "Group", "Dataset", "AttributeManager", "UnsupportedH5"]

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
_LEAF_K = 4        # group leaf node K: a symbol node holds 2K entries
_INTERNAL_K = 16   # group internal node K: a B-tree node holds 2K children
_ISTORE_K = 32     # indexed-storage (chunk B-tree) internal node K of superblock 0
GZIP_LEVEL = 4     # h5py's default level for compression="gzip"


class UnsupportedH5(ValueError):
    """The file uses a part of HDF5 this module does not read."""


def _unsupported(what: str, path: str) -> UnsupportedH5:
    return UnsupportedH5(f"{path}: {what} is not supported by "
                         "protein_ensemble_vae_torch.data.h5file")


# ---- datatypes --------------------------------------------------------------

class _VlenStr:
    """A variable-length string datatype (its values are ``str``)."""

    itemsize = 16   # length (4), global heap collection address (8), index (4)


def _parse_dtype(buf: bytes, pos: int, path: str):
    """(datatype, bytes read) of a datatype message at ``buf[pos:]``: a
    numpy dtype or ``_VlenStr``."""
    cv = buf[pos]
    cls, version = cv & 0x0F, cv >> 4
    bits = buf[pos + 1] | buf[pos + 2] << 8 | buf[pos + 3] << 16
    size = struct.unpack_from("<I", buf, pos + 4)[0]
    if version not in (1, 2, 3):
        raise _unsupported(f"datatype message version {version}", path)
    if cls == 0:   # fixed-point
        if bits & 1:
            raise _unsupported("big-endian integers", path)
        offset, precision = struct.unpack_from("<HH", buf, pos + 8)
        if offset != 0 or precision != 8 * size or size not in (1, 2, 4, 8):
            raise _unsupported(f"an integer of {precision} bits at offset {offset} "
                               f"in {size} bytes", path)
        return np.dtype(f"<{'i' if bits & 8 else 'u'}{size}"), 12
    if cls == 1:   # floating point
        if bits & 1 or bits & 0x40:
            raise _unsupported("big-endian or VAX floats", path)
        offset, precision, eloc, esize, mloc, msize, bias = struct.unpack_from(
            "<HHBBBBI", buf, pos + 8)
        want = {2: (16, 10, 5, 0, 10, 15), 4: (32, 23, 8, 0, 23, 127),
                8: (64, 52, 11, 0, 52, 1023)}.get(size)
        if offset != 0 or want != (precision, eloc, esize, mloc, msize, bias):
            raise _unsupported(f"a non-IEEE float of {size} bytes", path)
        return np.dtype(f"<f{size}"), 20
    if cls == 9:   # variable-length
        if bits & 0x0F != 1:
            raise _unsupported("variable-length sequences (other than strings)", path)
        base, n = _parse_dtype(buf, pos + 8, path)
        if base not in (np.dtype("u1"), np.dtype("i1")):
            raise _unsupported("a variable-length string of a base type other than bytes", path)
        return _VlenStr(), 8 + n
    names = {2: "time", 3: "fixed-length string", 4: "bitfield", 5: "opaque",
             6: "compound", 7: "reference", 8: "enum (h5py's bool)", 10: "array"}
    raise _unsupported(f"datatype class {names.get(cls, cls)}", path)


def _encode_dtype(dt) -> bytes:
    """The datatype message of a numpy dtype or ``_VlenStr``."""
    if isinstance(dt, _VlenStr):
        base = bytes([0x10, 0, 0, 0]) + struct.pack("<IHH", 1, 0, 8)   # 8-bit unsigned
        # variable-length string: null-terminated padding, UTF-8
        return bytes([0x19, 0x01, 0x01, 0x00]) + struct.pack("<I", 16) + base
    dt = np.dtype(dt)
    if dt.kind in "iu":
        bits = 0x08 if dt.kind == "i" else 0
        return bytes([0x10, bits, 0, 0]) + struct.pack("<IHH", dt.itemsize, 0, 8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in (2, 4, 8):
        p, eloc, esize, msize, bias = {2: (16, 10, 5, 10, 15), 4: (32, 23, 8, 23, 127),
                                       8: (64, 52, 11, 52, 1023)}[dt.itemsize]
        # mantissa normalisation 2 (implied leading 1), sign at bit p - 1
        return (bytes([0x11, 0x20, p - 1, 0]) + struct.pack("<I", dt.itemsize)
                + struct.pack("<HHBBBBI", 0, p, eloc, esize, 0, msize, bias))
    raise TypeError(f"h5file writes integers, IEEE floats and str, not {dt}")


# ---- reading ----------------------------------------------------------------

class _Reader:
    """The bytes of one file and the structures parsed from them."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.buf = f.read()
        base = self._find_superblock()
        buf = self.buf
        version = buf[base + 8]
        if version != 0:
            raise _unsupported(f"superblock version {version}", path)
        if buf[base + 13] != 8 or buf[base + 14] != 8:
            raise _unsupported("offsets or lengths of other than 8 bytes", path)
        pos = base + 24
        self.base = struct.unpack_from("<Q", buf, pos)[0]
        # root group symbol table entry, after the four addresses
        self.root = struct.unpack_from("<Q", buf, pos + 32 + 8)[0]
        self._gheaps: dict = {}

    def _find_superblock(self) -> int:
        pos = 0
        while pos + 8 <= len(self.buf):
            if self.buf[pos:pos + 8] == SIGNATURE:
                return pos
            pos = 512 if pos == 0 else 2 * pos
        raise UnsupportedH5(f"{self.path}: no HDF5 superblock")

    def addr(self, a: int) -> int:
        if a == UNDEF or self.base + a > len(self.buf):
            raise UnsupportedH5(f"{self.path}: address {a:#x} outside the file")
        return self.base + a

    def messages(self, oh: int) -> list[tuple[int, bytes]]:
        """(type, body) of each message of the object header at ``oh``."""
        buf, p = self.buf, self.addr(oh)
        if buf[p:p + 4] == b"OHDR":
            raise _unsupported("version-2 object headers (libver 'latest')", self.path)
        if buf[p] != 1:
            raise _unsupported(f"object header version {buf[p]}", self.path)
        nmsg = struct.unpack_from("<H", buf, p + 2)[0]
        size = struct.unpack_from("<I", buf, p + 8)[0]
        chunks = [(p + 16, size)]
        out = []
        while chunks:
            start, length = chunks.pop(0)
            q, end = start, start + length
            while q + 8 <= end:
                mtype, msize, flags = struct.unpack_from("<HHB", buf, q)
                body = buf[q + 8:q + 8 + msize]
                if flags & 0x02:
                    raise _unsupported("shared object header messages", self.path)
                if mtype == 0x10:   # continuation
                    caddr, clen = struct.unpack_from("<QQ", body)
                    chunks.append((self.addr(caddr), clen))
                elif mtype != 0:
                    out.append((mtype, body))
                q += 8 + msize
        if len(out) > nmsg:
            raise UnsupportedH5(f"{self.path}: object header at {oh:#x} holds more "
                                "messages than it declares")
        return out

    def group_entries(self, btree: int, heap: int) -> dict[str, int]:
        """Name -> object header address of a symbol-table group."""
        buf = self.buf
        hp = self.addr(heap)
        if buf[hp:hp + 4] != b"HEAP":
            raise UnsupportedH5(f"{self.path}: bad local heap at {heap:#x}")
        data = self.addr(struct.unpack_from("<Q", buf, hp + 24)[0])

        def name(off: int) -> str:
            end = buf.index(b"\0", data + off)
            return buf[data + off:end].decode("utf-8")

        out: dict[str, int] = {}

        def walk(node: int) -> None:
            p = self.addr(node)
            if buf[p:p + 4] != b"TREE" or buf[p + 4] != 0:
                raise UnsupportedH5(f"{self.path}: bad group B-tree node at {node:#x}")
            level, used = buf[p + 5], struct.unpack_from("<H", buf, p + 6)[0]
            q = p + 24 + 8   # past key 0
            for _ in range(used):
                child = struct.unpack_from("<Q", buf, q)[0]
                q += 16      # child, then the next key
                if level > 0:
                    walk(child)
                    continue
                s = self.addr(child)
                if buf[s:s + 4] != b"SNOD":
                    raise UnsupportedH5(f"{self.path}: bad symbol node at {child:#x}")
                for k in range(struct.unpack_from("<H", buf, s + 6)[0]):
                    off, oh = struct.unpack_from("<QQ", buf, s + 8 + 40 * k)
                    out[name(off)] = oh

        walk(btree)
        return out

    def global_heap_object(self, coll: int, index: int) -> bytes:
        if coll not in self._gheaps:
            buf, p = self.buf, self.addr(coll)
            if buf[p:p + 4] != b"GCOL":
                raise UnsupportedH5(f"{self.path}: bad global heap at {coll:#x}")
            size = struct.unpack_from("<Q", buf, p + 8)[0]
            objs, q, end = {}, p + 16, p + size
            while q + 16 <= end:
                idx, _, osize = struct.unpack_from("<HH4xQ", buf, q)
                if idx == 0:
                    break    # free space to the end
                objs[idx] = buf[q + 16:q + 16 + osize]
                q += 16 + (osize + 7) // 8 * 8
            self._gheaps[coll] = objs
        try:
            return self._gheaps[coll][index]
        except KeyError:
            raise UnsupportedH5(f"{self.path}: global heap object {index} missing") from None


# object header messages that change nothing this module reads
_IGNORED_MESSAGES = {0x0D: "comment", 0x0E: "modification time (old)",
                     0x12: "modification time"}
_MESSAGE_NAMES = {0x02: "link info", 0x06: "link", 0x07: "an external data file",
                  0x09: "a bogus message", 0x0A: "group info",
                  0x0F: "a shared message table", 0x13: "B-tree 'K' values",
                  0x14: "driver info", 0x15: "attribute info (dense attribute storage)",
                  0x16: "an object reference count", 0x17: "file space info"}


def _unknown_message(mtype: int, where: str, path: str) -> UnsupportedH5:
    return _unsupported(f"object header message {mtype:#06x} "
                        f"({_MESSAGE_NAMES.get(mtype, 'unknown type')}) in {where}", path)


def _parse_fill(mtype: int, body: bytes, path: str) -> Optional[bytes]:
    """The fill value's bytes of a fill value message (new 0x05 or old
    0x04), or None where none is set (the library's default, zeros)."""
    if mtype == 0x04:
        size, = struct.unpack_from("<I", body, 0)
        return body[4:4 + size] if size else None
    version = body[0]
    if version in (1, 2):
        if version == 2 and not body[3]:     # fill value not defined
            return None
        size, = struct.unpack_from("<I", body, 4)
        return body[8:8 + size] if size else None
    if version == 3:
        if not body[1] & 0x20:               # no fill value stored
            return None
        size, = struct.unpack_from("<I", body, 2)
        return body[6:6 + size] if size else None
    raise _unsupported(f"fill value message version {version}", path)


def _parse_dataspace(body: bytes, path: str) -> tuple[int, ...]:
    version, rank, flags = body[0], body[1], body[2]
    if version == 1:
        pos = 8
    elif version == 2:
        if body[3] == 2:
            raise _unsupported("null dataspaces", path)
        pos = 4
    else:
        raise _unsupported(f"dataspace version {version}", path)
    return tuple(struct.unpack_from(f"<{rank}Q", body, pos)) if rank else ()


def _parse_filters(body: bytes, path: str) -> list[tuple[int, tuple]]:
    version, n = body[0], body[1]
    if version not in (1, 2):
        raise _unsupported(f"filter pipeline version {version}", path)
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid, = struct.unpack_from("<H", body, pos)
        if version == 1 or fid >= 256:
            name_len, flags, nvals = struct.unpack_from("<HHH", body, pos + 2)
            pos += 8 + ((name_len + 7) // 8 * 8 if version == 1 else name_len)
        else:
            flags, nvals = struct.unpack_from("<HH", body, pos + 2)
            pos += 6
        vals = struct.unpack_from(f"<{nvals}I", body, pos)
        pos += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
        if fid != 1:
            names = {2: "the shuffle filter", 3: "the fletcher32 filter",
                     4: "the szip filter", 5: "the nbit filter", 6: "the scaleoffset filter"}
            raise _unsupported(names.get(fid, f"filter {fid}"), path)
        out.append((fid, vals))
    return out


def _parse_attribute(body: bytes, path: str):
    """(name, datatype, shape, raw data bytes) of an attribute message."""
    version = body[0]
    if version == 1:
        name_size, dt_size, ds_size = struct.unpack_from("<HHH", body, 2)
        pad = lambda n: (n + 7) // 8 * 8  # noqa: E731
        pos = 8
    elif version in (2, 3):
        if body[1]:
            raise _unsupported("shared attribute datatypes or dataspaces", path)
        name_size, dt_size, ds_size = struct.unpack_from("<HHH", body, 2)
        pad = lambda n: n  # noqa: E731
        pos = 8 + (1 if version == 3 else 0)
    else:
        raise _unsupported(f"attribute message version {version}", path)
    name = body[pos:pos + name_size].rstrip(b"\0").decode("utf-8")
    pos += pad(name_size)
    dt, _ = _parse_dtype(body, pos, path)
    pos += pad(dt_size)
    shape = _parse_dataspace(body[pos:pos + ds_size], path)
    pos += pad(ds_size)
    return name, dt, shape, body[pos:]


# ---- the object model --------------------------------------------------------

class AttributeManager:
    """``obj.attrs``: a dict-like view of an object's attributes."""

    def __init__(self, owner: "_Node", items: Optional[dict] = None):
        self._owner = owner
        self._items: dict = items if items is not None else {}

    def __getitem__(self, name: str):
        return self._items[name]

    def __setitem__(self, name: str, value) -> None:
        self._owner._file._check_writable()
        if isinstance(value, (bytes, np.bytes_)):
            value = bytes(value).decode("utf-8")
        if not isinstance(value, str):
            value = np.asarray(value)
            _encode_dtype(value.dtype)   # raises for a type the writer has no form for
            value = value[()] if value.ndim == 0 else value
        self._items[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)

    def keys(self):
        return self._items.keys()

    def items(self):
        return self._items.items()


class _Node:
    _file: "File"
    name: str


class Dataset(_Node):
    """A dataset: ``[()]``, ``[:]`` or any numpy index reads it; ``shape``,
    ``dtype`` and ``compression`` (None or "gzip") describe it."""

    def __init__(self, file: "File", name: str, value=None, loader=None,
                 shape=None, dtype=None, attrs: Optional[dict] = None,
                 compression: Optional[str] = None):
        self._file, self.name = file, name
        self.compression = compression
        self._value, self._loader = value, loader
        self.shape = shape if shape is not None else np.shape(value)
        self.dtype = dtype if dtype is not None else (
            np.dtype(object) if isinstance(value, str) else value.dtype)
        self.attrs = AttributeManager(self, attrs)

    def _read(self):
        if self._loader is not None:
            self._value, self._loader = self._loader(), None
        return self._value

    def __getitem__(self, key):
        value = self._read()
        if isinstance(value, str):
            if key == () or key is Ellipsis:
                return value.encode("utf-8")
            raise TypeError(f"{self.name}: a scalar string dataset is read with [()]")
        out = value[key]
        return out.copy() if isinstance(out, np.ndarray) else out


class Group(_Node):
    """A group: ``name in g``, ``g[name]`` (paths with '/' too), iteration
    over member names, ``create_dataset``, ``create_group``, ``attrs``."""

    def __init__(self, file: "File", name: str, attrs: Optional[dict] = None):
        self._file, self.name = file, name
        self._members: dict[str, _Node] = {}
        self.attrs = AttributeManager(self, attrs)

    def _walk(self, path: str, create: bool = False) -> tuple["Group", str]:
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise KeyError(path)
        g = self
        for p in parts[:-1]:
            nxt = g._members.get(p)
            if nxt is None and create:
                nxt = g.create_group(p)
            if not isinstance(nxt, Group):
                raise KeyError(path)
            g = nxt
        return g, parts[-1]

    def __getitem__(self, path: str) -> _Node:
        if path == "/":
            return self._file
        g, last = self._walk(path)
        return g._members[last]

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __delitem__(self, path: str) -> None:
        self._file._check_writable()
        g, last = self._walk(path)
        del g._members[last]

    def __iter__(self) -> Iterator[str]:
        return iter(self._members)

    def keys(self):
        return self._members.keys()

    def items(self):
        return self._members.items()

    def _child_name(self, last: str) -> str:
        return f"{self.name.rstrip('/')}/{last}"

    def create_group(self, path: str) -> "Group":
        self._file._check_writable()
        g, last = self._walk(path, create=True)
        if last in g._members:
            raise ValueError(f"{path}: the name exists")
        out = g._members[last] = Group(self._file, g._child_name(last))
        return out

    def create_dataset(self, path: str, shape=None, dtype=None, data=None,
                       compression: Optional[str] = None) -> Dataset:
        """A dataset holding ``data`` (numpy-convertible or ``str``), or zeros
        of ``shape`` / ``dtype``. ``compression`` may be None (contiguous) or
        "gzip" (one chunk, deflate level 4); h5py's other storage options
        are not taken (a TypeError names one)."""
        self._file._check_writable()
        if compression not in (None, "gzip"):
            raise ValueError(f"compression {compression!r}: h5file writes None or 'gzip'")
        if data is None:
            data = np.zeros(shape, dtype=dtype or np.float32)
        if isinstance(data, (bytes, np.bytes_)):
            data = bytes(data).decode("utf-8")
        if not isinstance(data, str):
            data = np.array(data, dtype=dtype)
            if shape is not None and tuple(shape) != data.shape:
                data = data.reshape(shape)
            _encode_dtype(data.dtype)
        g, last = self._walk(path, create=True)
        if last in g._members:
            raise ValueError(f"{path}: the name exists")
        out = g._members[last] = Dataset(self._file, g._child_name(last), value=data,
                                         compression=None if isinstance(data, str) else compression)
        return out


class File(Group):
    """``File(path, mode)``: mode ``"r"`` reads, ``"w"`` starts an empty
    file, ``"a"`` reads an existing file (or starts an empty one); both
    write it on ``close``, replacing what was there. Use as a context
    manager."""

    def __init__(self, path: Union[str, os.PathLike], mode: str = "r"):
        if mode not in ("r", "w", "a"):
            raise ValueError(f"mode {mode!r}: h5file opens files with 'r', 'w' or 'a'")
        self.filename = os.fspath(path)
        self.mode = mode
        self._closed = False
        super().__init__(self, "/")
        if mode == "r" or (mode == "a" and os.path.exists(self.filename)):
            self._load(eager=mode == "a")
        if mode == "w":
            # fail now, not on close, where the file cannot be written; the
            # file itself is replaced on close, through this temporary name
            with open(self.filename + ".tmp", "wb"):
                pass
            os.remove(self.filename + ".tmp")

    def _check_writable(self) -> None:
        if self._closed:
            raise ValueError(f"{self.filename}: the file is closed")
        if self.mode == "r":
            raise ValueError(f"{self.filename}: opened read-only")

    # -- reading
    def _load(self, eager: bool) -> None:
        rd = _Reader(self.filename)
        self._fill(rd, self, rd.root, eager)

    def _fill(self, rd: _Reader, group: Group, oh: int, eager: bool) -> None:
        stab = None
        for mtype, body in rd.messages(oh):
            if mtype == 0x11:
                stab = struct.unpack_from("<QQ", body)
            elif mtype == 0x0C:
                name, dt, shape, raw = _parse_attribute(body, rd.path)
                group.attrs._items[name] = self._decode(rd, dt, shape, raw)
            elif mtype in (0x02, 0x06, 0x0A):
                raise _unsupported("new-style (link-message) groups", rd.path)
            elif mtype not in _IGNORED_MESSAGES:
                raise _unknown_message(mtype, f"group {group.name}", rd.path)
        if stab is None:
            raise UnsupportedH5(f"{rd.path}: group {group.name} has no symbol table")
        for name, child in sorted(rd.group_entries(*stab).items()):
            msgs = rd.messages(child)
            if any(t == 0x11 for t, _ in msgs):
                sub = group._members[name] = Group(self, group._child_name(name))
                self._fill(rd, sub, child, eager)
            else:
                group._members[name] = self._dataset(rd, group._child_name(name), msgs, eager)

    def _dataset(self, rd: _Reader, name: str, msgs, eager: bool) -> Dataset:
        shape = dt = layout = fill = None
        filters: list = []
        attrs = {}
        for mtype, body in msgs:
            if mtype == 0x01:
                shape = _parse_dataspace(body, rd.path)
            elif mtype == 0x03:
                dt, _ = _parse_dtype(body, 0, rd.path)
            elif mtype == 0x08:
                layout = body
            elif mtype == 0x0B:
                filters = _parse_filters(body, rd.path)
            elif mtype == 0x0C:
                aname, adt, ashape, raw = _parse_attribute(body, rd.path)
                attrs[aname] = self._decode(rd, adt, ashape, raw)
            elif mtype in (0x04, 0x05):
                fill = _parse_fill(mtype, body, rd.path) if fill is None else fill
            elif mtype not in _IGNORED_MESSAGES:
                raise _unknown_message(mtype, f"dataset {name}", rd.path)
        if shape is None or dt is None or layout is None:
            raise UnsupportedH5(f"{rd.path}: {name} is neither a group nor a dataset")
        zero_fill = fill is None or not any(fill)

        def load():
            raw = self._raw(rd, name, layout, filters, shape, dt, zero_fill)
            value = self._decode(rd, dt, shape, raw, dataset=True)
            return value

        np_dt = dt if isinstance(dt, np.dtype) else np.dtype(object)
        gzip = any(fid == 1 for fid, _ in filters)
        ds = Dataset(self, name, loader=load, shape=shape, dtype=np_dt, attrs=attrs,
                     compression="gzip" if gzip else None)
        if eager:
            ds._read()
        return ds

    @staticmethod
    def _raw(rd: _Reader, name: str, layout: bytes, filters, shape, dt,
             zero_fill: bool) -> bytes:
        """The dataset's bytes in C order; storage never written reads as
        zeros, the fill value (``zero_fill``), or raises."""
        version, cls = layout[0], layout[1]
        if version != 3:
            raise _unsupported(f"data layout message version {version}", rd.path)
        n = int(np.prod(shape)) if shape else 1
        nbytes = n * dt.itemsize
        unwritten = _unsupported(f"{name}: storage never written under a nonzero fill "
                                 "value", rd.path)
        if cls == 0:     # compact
            size, = struct.unpack_from("<H", layout, 2)
            if size < nbytes:
                raise UnsupportedH5(f"{rd.path}: {name}: compact data of {size} bytes, "
                                    f"expected {nbytes}")
            return layout[4:4 + nbytes]
        if cls == 1:     # contiguous
            addr, size = struct.unpack_from("<QQ", layout, 2)
            if addr == UNDEF:
                if not zero_fill:
                    raise unwritten
                return bytes(nbytes)     # never written: the fill value, 0
            p = rd.addr(addr)
            if size < nbytes or p + nbytes > len(rd.buf):
                raise UnsupportedH5(f"{rd.path}: {name}: contiguous data of {size} bytes "
                                    f"at {addr:#x}, expected {nbytes} within the file")
            return rd.buf[p:p + nbytes]
        if cls != 2:
            raise _unsupported(f"data layout class {cls}", rd.path)
        ndim = layout[2]
        btree, = struct.unpack_from("<Q", layout, 3)
        cdims = struct.unpack_from(f"<{ndim}I", layout, 11)[:-1]
        if btree == UNDEF:
            if not zero_fill:
                raise unwritten
            return bytes(nbytes)
        full = np.zeros(tuple(shape) + (dt.itemsize,), np.uint8) if shape else None
        csize = int(np.prod(cdims)) * dt.itemsize
        buf = rd.buf
        seen: set = set()

        def walk(node: int) -> None:
            p = rd.addr(node)
            if buf[p:p + 4] != b"TREE" or buf[p + 4] != 1:
                raise UnsupportedH5(f"{rd.path}: bad chunk B-tree node at {node:#x}")
            level, used = buf[p + 5], struct.unpack_from("<H", buf, p + 6)[0]
            ksize = 8 + 8 * ndim
            q = p + 24
            for _ in range(used):
                stored, fmask = struct.unpack_from("<II", buf, q)
                offs = struct.unpack_from(f"<{ndim}Q", buf, q + 8)[:-1]
                child, = struct.unpack_from("<Q", buf, q + ksize)
                q += ksize + 8
                if level > 0:
                    walk(child)
                    continue
                seen.add(offs)
                c = rd.addr(child)
                data = buf[c:c + stored]
                for k in reversed(range(len(filters))):   # every filter is deflate
                    if not fmask & (1 << k):               # unless skipped for the chunk
                        data = zlib.decompress(data)
                if len(data) != csize:
                    raise UnsupportedH5(f"{rd.path}: {name}: chunk of {len(data)} bytes, "
                                        f"expected {csize}")
                chunk = np.frombuffer(data, np.uint8).reshape(tuple(cdims) + (dt.itemsize,))
                sl = tuple(slice(o, min(o + c_, s)) for o, c_, s in zip(offs, cdims, shape))
                full[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]

        if full is None:
            raise _unsupported("a chunked scalar dataset", rd.path)
        walk(btree)
        if not zero_fill and len(seen) < math.prod(-(-s // c) for s, c in zip(shape, cdims)):
            raise unwritten
        return full.tobytes()

    @staticmethod
    def _decode(rd: _Reader, dt, shape, raw: bytes, dataset: bool = False):
        n = int(np.prod(shape)) if shape else 1
        if isinstance(dt, np.dtype):
            arr = np.frombuffer(raw[:n * dt.itemsize], dt).reshape(shape).copy()
            return arr if shape else arr[()]
        vals = []
        for k in range(n):
            length, coll, index = struct.unpack_from("<IQI", raw, 16 * k)
            data = rd.global_heap_object(coll, index)[:length] if length else b""
            vals.append(data.decode("utf-8"))
        if not shape:
            return vals[0]
        if dataset:
            raise _unsupported("arrays of variable-length strings", rd.path)
        return np.array(vals, dtype=object).reshape(shape)

    # -- writing
    def close(self) -> None:
        if self._closed:
            return
        if self.mode in ("w", "a"):
            for node in _walk_nodes(self):
                if isinstance(node, Dataset):
                    node._read()
            data = _Writer(self).build()
            tmp = self.filename + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, self.filename)
        self._closed = True

    def __enter__(self) -> "File":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None and self.mode != "r":
            self._closed = True    # leave the file as it was before the error
            return
        self.close()


def _walk_nodes(group: Group) -> Iterator[_Node]:
    for node in group._members.values():
        yield node
        if isinstance(node, Group):
            yield from _walk_nodes(node)


# ---- writing ----------------------------------------------------------------

def _message(mtype: int, body: bytes) -> bytes:
    body += bytes(-len(body) % 8)
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _dataspace(shape: tuple) -> bytes:
    return struct.pack("<BBB5x", 1, len(shape), 0) + b"".join(
        struct.pack("<Q", d) for d in shape)


class _Writer:
    """Lays a File's tree out as bytes: superblock, one global heap
    collection for the strings, then every object children first."""

    def __init__(self, f: File):
        self.f = f
        self.out = bytearray(96)           # the superblock, filled last
        self.strings: list[bytes] = []

    def alloc(self, data: bytes) -> int:
        addr = len(self.out)
        self.out += data
        self.out += bytes(-len(self.out) % 8)
        return addr

    def _string_bytes(self) -> int:
        """Bytes the tree's strings take as global heap objects."""
        values = list(self.f.attrs._items.values())
        for node in _walk_nodes(self.f):
            values += list(node.attrs._items.values())
            if isinstance(node, Dataset):
                values.append(node._value)
        return sum(16 + -(-len(v.encode("utf-8")) // 8) * 8
                   for v in values if isinstance(v, str))

    def build(self) -> bytes:
        n = self._string_bytes()
        self.gcol = self.gsize = None
        if n:
            self.gsize = max(4096, 16 + n + 16)
            self.gcol = self.alloc(bytes(self.gsize))   # filled once the strings are known
        root_oh, btree, heap = self.group(self.f)
        if self.gcol is not None:
            objs = bytearray()
            for k, s in enumerate(self.strings, start=1):
                objs += struct.pack("<HH4xQ", k, 1, len(s)) + s + bytes(-len(s) % 8)
            free = self.gsize - 16 - len(objs)
            gcol = (b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", self.gsize) + objs
                    + struct.pack("<HH4xQ", 0, 0, free) + bytes(free - 16))
            self.out[self.gcol:self.gcol + self.gsize] = gcol
        eof = len(self.out)
        sb = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
              + struct.pack("<HHI", _LEAF_K, _INTERNAL_K, 0)
              + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
              + struct.pack("<QQII", 0, root_oh, 1, 0) + struct.pack("<QQ", btree, heap))
        self.out[:96] = sb
        return bytes(self.out)

    def value_bytes(self, v) -> tuple[bytes, object, tuple]:
        """(raw bytes, datatype, shape) of a dataset or attribute value."""
        if isinstance(v, str):
            self.strings.append(v.encode("utf-8"))
            return (struct.pack("<IQI", len(self.strings[-1]), self.gcol, len(self.strings)),
                    _VlenStr(), ())
        arr = np.asarray(v)
        arr = arr.astype(arr.dtype.newbyteorder("<"), order="C", copy=False)
        return arr.tobytes(), arr.dtype, arr.shape

    def attributes(self, attrs: AttributeManager) -> list[bytes]:
        msgs = []
        for name, v in attrs._items.items():
            raw, dt, shape = self.value_bytes(v)
            nm = name.encode("utf-8") + b"\0"
            dtb, dsb = _encode_dtype(dt), _dataspace(shape)
            pad = lambda b: b + bytes(-len(b) % 8)  # noqa: E731
            msgs.append(_message(0x0C, struct.pack("<BBHHH", 1, 0, len(nm), len(dtb), len(dsb))
                                 + pad(nm) + pad(dtb) + pad(dsb) + raw))
        return msgs

    def header(self, msgs: list[bytes]) -> int:
        body = b"".join(msgs)
        return self.alloc(struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body)

    def dataset(self, ds: Dataset) -> int:
        value = ds._value
        msgs_attrs = self.attributes(ds.attrs)
        raw, dt, shape = self.value_bytes(value)
        if ds.compression == "gzip" and shape and all(shape):
            layout, filters = self.deflated_chunk(raw, shape, dt.itemsize)
            extra = [_message(0x0B, filters)]
        else:
            addr = self.alloc(raw) if raw else UNDEF
            layout, extra = struct.pack("<BBQQ", 3, 1, addr, len(raw)), []
        msgs = ([_message(0x01, _dataspace(shape)), _message(0x03, _encode_dtype(dt)),
                 _message(0x08, layout)] + extra + msgs_attrs)
        return self.header(msgs)

    def deflated_chunk(self, raw: bytes, shape: tuple, itemsize: int) -> tuple[bytes, bytes]:
        """(layout message, filter pipeline message) of a dataset stored as
        one chunk of its whole shape through the deflate filter (level
        GZIP_LEVEL), indexed by a one-entry v1 B-tree of type 1 whose node
        has the full size HDF5 reads (2K children, K = 32, superblock 0's
        indexed-storage K)."""
        data = zlib.compress(raw, GZIP_LEVEL)
        chunk = self.alloc(data)
        ndim = len(shape) + 1
        keys = [struct.pack("<II", len(data), 0) + struct.pack(f"<{ndim}Q", *([0] * ndim)),
                struct.pack("<II", 0, 0) + struct.pack(f"<{ndim}Q", *shape, 0)]
        node = (b"TREE" + bytes([1, 0]) + struct.pack("<H", 1) + struct.pack("<QQ", UNDEF, UNDEF)
                + keys[0] + struct.pack("<Q", chunk) + keys[1])
        full = 24 + (2 * _ISTORE_K + 1) * len(keys[0]) + 2 * _ISTORE_K * 8
        btree = self.alloc(node + bytes(full - len(node)))
        layout = (struct.pack("<BBBQ", 3, 2, ndim, btree)
                  + struct.pack(f"<{ndim}I", *shape, itemsize))
        # filter pipeline v1: deflate (id 1), optional, one client value (the
        # level), padded to an even count
        filters = (struct.pack("<BB6x", 1, 1)
                   + struct.pack("<HHHH", 1, 0, 1, 1) + struct.pack("<II", GZIP_LEVEL, 0))
        return layout, filters

    def group(self, g: Group) -> tuple[int, int, int]:
        """(object header, B-tree, local heap) addresses of group ``g``."""
        entries = []
        for name in sorted(g._members, key=lambda s: s.encode("utf-8")):
            node = g._members[name]
            if isinstance(node, Group):
                oh, bt, hp = self.group(node)
                entries.append((name, oh, (bt, hp)))
            else:
                entries.append((name, self.dataset(node), None))
        # local heap: the empty name at offset 0, then each name, 8-aligned
        names = bytearray(8)
        offsets = []
        for name, _, _ in entries:
            offsets.append(len(names))
            nb = name.encode("utf-8") + b"\0"
            names += nb + bytes(-len(nb) % 8)
        heap_data = self.alloc(bytes(names))
        heap = self.alloc(b"HEAP" + bytes([0, 0, 0, 0])
                          + struct.pack("<QQQ", len(names), 1, heap_data))
        # symbol nodes of at most 2K entries, and one level-0 B-tree node
        per = 2 * _LEAF_K
        nodes, keys = [], [0]
        for s in range(0, len(entries), per):
            chunk = list(zip(entries[s:s + per], offsets[s:s + per]))
            body = bytearray(b"SNOD" + bytes([1, 0]) + struct.pack("<H", len(chunk)))
            for (name, oh, scratch), off in chunk:
                if scratch is None:
                    body += struct.pack("<QQII16x", off, oh, 0, 0)
                else:
                    body += struct.pack("<QQII", off, oh, 1, 0) + struct.pack("<QQ", *scratch)
            body += bytes(40 * (per - len(chunk)))
            nodes.append(self.alloc(bytes(body)))
            keys.append(chunk[-1][1] if chunk else 0)
        if len(nodes) > 2 * _INTERNAL_K:
            raise ValueError(f"{g.name}: h5file writes groups of at most "
                             f"{2 * _INTERNAL_K * per} members")
        tree = bytearray(b"TREE" + bytes([0, 0]) + struct.pack("<H", len(nodes))
                         + struct.pack("<QQ", UNDEF, UNDEF))
        for k, child in enumerate(nodes):
            tree += struct.pack("<QQ", keys[k], child)
        tree += struct.pack("<Q", keys[len(nodes)])
        tree += bytes(24 + 8 * (2 * _INTERNAL_K + 1) + 8 * 2 * _INTERNAL_K - len(tree))
        btree = self.alloc(bytes(tree))
        msgs = [_message(0x11, struct.pack("<QQ", btree, heap))] + self.attributes(g.attrs)
        return self.header(msgs), btree, heap

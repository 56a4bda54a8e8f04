"""Atomic, write-once HDF5 files for the coordinate outputs, with no HDF5 library.

h5py is absent where the port runs, so this module writes the file format
itself ("HDF5 File Format Specification Version 3.0"). It covers exactly what
the coordinate path writes (the JAX package's ``utils/h5.py`` ``put_all`` and
scalar-attribute paths), and h5py reads every file back with the same
datasets, dtypes, values, attribute names, values and read-back types:

  * datasets: ASCII names, at the root or in a group one level below it
    (``features/<name>``); numpy integer / float (any byte order) or
    fixed-length ``S{w}`` bytes (ASCII, NULLPAD); any rank; contiguous layout,
    written whole. An empty dataset has the undefined address and size 0, as
    h5py leaves it when nothing is written. A dataset may carry scalar
    attributes of the same kinds as the file's.
  * file attributes: ``str`` as variable-length UTF-8 (reads back ``str``),
    ``int`` as int64, ``float`` as float64, numpy scalars of kind i/u/f in
    their own dtype; ``dict`` as JSON and ``None`` as ``"None"`` through
    :func:`encode_attr`. Any other value raises ``TypeError``.

The file: a version-2 superblock; variable-length strings in one global heap
collection; the root group as a version-2 object header holding Link Info,
Group Info, one Link message per dataset or group, Attribute Info and one
version-3 Attribute message per attribute; one such header per group (no
attributes); one version-2 object header per dataset (Dataspace, Datatype,
Fill Value v3, Data Layout v3, then Attribute Info and its attributes when it
has any); then the raw data.
The superblock and every object header carry Jenkins lookup3 checksums.

``AtomicH5`` keeps the staging lifecycle of the JAX package's class: a
``.stage-{pid:x}-{token}-{name}`` sibling file, ``os.replace`` onto the
target on publish, discard on exception, and a failed write or close
discards the stage and never publishes it. The whole file is built in memory
and written with one ``os.write`` at publish.

The format is write-once, so :func:`add_datasets` adds datasets to a
published file by writing the old file's every dataset and attribute, with the
new datasets, into one new staged file that replaces it (the JAX package
appends in place through h5py, with ``__tmp_*`` datasets it renames). A crash
leaves the old file whole.

:func:`read_h5` and :func:`read_h5_tree` read back what this writer writes and
raise ``ValueError`` on any other layout.
"""

from __future__ import annotations

import json
import os
import secrets
import struct
import sys
from pathlib import Path
from typing import Any, Mapping, MutableMapping, NamedTuple, Optional

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_SUPERBLOCK_SIZE = 48
_GCOL_MIN = 4096
_M32 = 0xFFFFFFFF

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL, _LAYOUT = 0x01, 0x02, 0x03, 0x05, 0x08
_GROUP_INFO, _LINK, _ATTRIBUTE, _ATTR_INFO = 0x0A, 0x06, 0x0C, 0x15
# header message flags as the HDF5 library sets them: datatype, fill value and
# group info are constant; attribute info must not be shared
_MSG_FLAGS = {_DATATYPE: 0x01, _FILL: 0x01, _GROUP_INFO: 0x01, _ATTR_INFO: 0x04}

# (exponent location, exponent size, mantissa size, exponent bias) by width
_FLOAT_FIELDS = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}
_VLEN_STR = "vlen-utf8"


# --- checksum ---------------------------------------------------------------------
def lookup3(data: bytes) -> int:
    """Bob Jenkins' lookup3 ``hashlittle`` with initial value 0, the checksum
    of HDF5 metadata. The rotations are written out: this runs once per
    object header."""
    M = _M32
    n = len(data)
    a = b = c = (0xDEADBEEF + n) & M
    if n == 0:
        return c
    words = struct.unpack(f"<{(n + 11) // 12 * 3}I", bytes(data) + bytes(-n % 12))
    last = len(words) - 3
    for i in range(0, last, 3):
        a = (a + words[i]) & M
        b = (b + words[i + 1]) & M
        c = (c + words[i + 2]) & M
        a = ((a - c) & M) ^ (((c << 4) | (c >> 28)) & M); c = (c + b) & M  # noqa: E702
        b = ((b - a) & M) ^ (((a << 6) | (a >> 26)) & M); a = (a + c) & M  # noqa: E702
        c = ((c - b) & M) ^ (((b << 8) | (b >> 24)) & M); b = (b + a) & M  # noqa: E702
        a = ((a - c) & M) ^ (((c << 16) | (c >> 16)) & M); c = (c + b) & M  # noqa: E702
        b = ((b - a) & M) ^ (((a << 19) | (a >> 13)) & M); a = (a + c) & M  # noqa: E702
        c = ((c - b) & M) ^ (((b << 4) | (b >> 28)) & M); b = (b + a) & M  # noqa: E702
    a = (a + words[last]) & M
    b = (b + words[last + 1]) & M
    c = (c + words[last + 2]) & M
    c = ((c ^ b) - (((b << 14) | (b >> 18)) & M)) & M
    a = ((a ^ c) - (((c << 11) | (c >> 21)) & M)) & M
    b = ((b ^ a) - (((a << 25) | (a >> 7)) & M)) & M
    c = ((c ^ b) - (((b << 16) | (b >> 16)) & M)) & M
    a = ((a ^ c) - (((c << 4) | (c >> 28)) & M)) & M
    b = ((b ^ a) - (((a << 14) | (a >> 18)) & M)) & M
    c = ((c ^ b) - (((b << 24) | (b >> 8)) & M)) & M
    return c


# --- values -------------------------------------------------------------------------
def encode_attr(value: Any) -> Any:
    """HDF5-storable attribute encoding: dict → JSON, None → "None"."""
    if isinstance(value, dict):
        return json.dumps(value)
    return "None" if value is None else value


def _attr_value(value: Any) -> tuple[Any, bytes | str]:
    """(datatype, payload) of a scalar attribute: the vlen-string marker and
    the str, or a numpy dtype and its bytes. Read-back types match h5py's
    ``attrs[k] = v``: str → str, int → int64, float → float64, numpy scalars
    keep their dtype."""
    if isinstance(value, str):
        value.encode("utf-8")  # refuse what UTF-8 cannot hold, before publish
        if "\0" in value:
            raise ValueError("variable-length strings cannot hold NUL characters (as in h5py)")
        return _VLEN_STR, value
    if isinstance(value, (bool, np.bool_)):
        raise TypeError("bool attributes are not written by this HDF5 writer")
    if isinstance(value, int):
        arr = np.array(value, dtype=np.int64)  # OverflowError past int64, as h5py
    elif isinstance(value, float):
        arr = np.array(value, dtype=np.float64)
    elif isinstance(value, np.generic) and value.dtype.kind in "iuf":
        arr = np.array(value)
    else:
        raise TypeError(
            f"attribute values must be str, int, float, a numpy int/float scalar, dict "
            f"or None, got {type(value).__name__}"
        )
    _datatype(arr.dtype)
    return arr.dtype, arr.tobytes()


def write_attrs(target: MutableMapping[str, Any], attrs: Mapping[str, Any]) -> None:
    """Encode a mapping of attributes into ``target`` (name → (datatype,
    payload)), refusing unsupported names and values at once."""
    for key, value in attrs.items():
        if not isinstance(key, str) or not key or "\0" in key:
            raise ValueError(f"attribute names must be non-empty str without NUL, got {key!r}")
        target[key] = _attr_value(encode_attr(value))


def _check_name(name: str) -> None:
    if (not isinstance(name, str) or not name or "/" in name or "\0" in name or name == "."
            or not name.isascii()):
        raise ValueError(f"dataset and group names must be flat ASCII, got {name!r}")


# --- messages -----------------------------------------------------------------------
def _datatype(dt: np.dtype) -> bytes:
    """Datatype message (version 1) of a numpy dtype."""
    order = 1 if dt.byteorder == ">" or (dt.byteorder == "=" and sys.byteorder == "big") else 0
    size = dt.itemsize
    if dt.kind in "iu" and size in (1, 2, 4, 8):
        bits = order | (0x08 if dt.kind == "i" else 0)
        return struct.pack("<B3BIHH", 0x10, bits, 0, 0, size, 0, 8 * size)
    if dt.kind == "f" and size in _FLOAT_FIELDS:
        exp_loc, exp_size, mant_size, bias = _FLOAT_FIELDS[size]
        return struct.pack(
            "<B3BIHHBBBBI", 0x11, order | 0x20, 8 * size - 1, 0, size, 0, 8 * size,
            exp_loc, exp_size, 0, mant_size, bias,
        )
    if dt.kind == "S" and size > 0:
        return struct.pack("<B3BI", 0x13, 0x01, 0, 0, size)  # NULLPAD, ASCII
    raise TypeError(f"dtype {dt} is not written by this HDF5 writer")


# variable-length UTF-8 string (NULLTERM) over unsigned 8-bit integers, as the
# HDF5 library encodes h5py's string_dtype()
_VLEN_STR_TYPE = struct.pack("<B3BI", 0x19, 0x01, 0x01, 0x00, 16) + struct.pack(
    "<B3BIHH", 0x10, 0, 0, 0, 1, 0, 8
)
_SCALAR_SPACE = bytes((2, 0, 0, 0))


def _dataspace(shape: tuple[int, ...]) -> bytes:
    if not shape:
        return _SCALAR_SPACE
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    return bytes((2, len(shape), 1, 1)) + dims + dims  # maximum dims = dims


def _link(name: bytes, addr: int) -> bytes:
    if len(name) < 256:
        return bytes((1, 0x00, len(name))) + name + struct.pack("<Q", addr)
    return bytes((1, 0x01)) + struct.pack("<H", len(name)) + name + struct.pack("<Q", addr)


def _attribute(name: str, datatype: Any, payload: bytes | str, heap: "_GlobalHeap") -> bytes:
    raw = name.encode("utf-8") + b"\0"
    if datatype is _VLEN_STR:
        data = payload.encode("utf-8")
        tmsg = _VLEN_STR_TYPE
        value = struct.pack("<IQI", len(data), heap.addr, heap.add(data))
    else:
        tmsg, value = _datatype(datatype), payload
    head = struct.pack("<BBHHHB", 3, 0, len(raw), len(tmsg), len(_SCALAR_SPACE),
                       0 if name.isascii() else 1)
    return head + raw + tmsg + _SCALAR_SPACE + value


def _header_size(messages: list[tuple[int, bytes]]) -> int:
    n = sum(4 + len(data) for _, data in messages)
    return 6 + (1 if n < 1 << 8 else 2 if n < 1 << 16 else 4) + n + 4


def _object_header(messages: list[tuple[int, bytes]]) -> bytes:
    """A version-2 object header: one chunk, no times, its size field as
    narrow as the chunk allows, lookup3 checksum."""
    body = b"".join(
        struct.pack("<BHB", mtype, len(data), _MSG_FLAGS.get(mtype, 0)) + data
        for mtype, data in messages
    )
    n = len(body)
    if n < 1 << 8:
        head = b"OHDR" + bytes((2, 0)) + struct.pack("<B", n)
    elif n < 1 << 16:
        head = b"OHDR" + bytes((2, 1)) + struct.pack("<H", n)
    else:
        head = b"OHDR" + bytes((2, 2)) + struct.pack("<I", n)
    out = head + body
    return out + struct.pack("<I", lookup3(out))


class _GlobalHeap:
    """One global heap collection holding the variable-length strings."""

    def __init__(self, addr: int) -> None:
        self.addr = addr
        self.objects: list[bytes] = []

    def add(self, data: bytes) -> int:
        self.objects.append(data)
        return len(self.objects)  # object index, from 1

    @property
    def size(self) -> int:
        if not self.objects:
            return 0
        used = 16 + sum(16 + len(o) + (-len(o) % 8) for o in self.objects)
        return max(_GCOL_MIN, used + 16)  # room for the free-space object's header

    def encode(self) -> bytes:
        size = self.size
        if not size:
            return b""
        parts = [b"GCOL", bytes((1, 0, 0, 0)), struct.pack("<Q", size)]
        for i, data in enumerate(self.objects, start=1):
            parts.append(struct.pack("<HHIQ", i, 0, 0, len(data)) + data + bytes(-len(data) % 8))
        used = sum(len(p) for p in parts)
        parts.append(struct.pack("<HHIQ", 0, 0, 0, size - used))  # free space, header included
        return b"".join(parts) + bytes(size - used - 16)


def _encode(
    datasets: Mapping[str, np.ndarray],
    attrs: Mapping[str, tuple[Any, bytes | str]],
    dataset_attrs: Mapping[str, Mapping[str, tuple[Any, bytes | str]]] | None = None,
) -> bytearray:
    """The bytes of a whole file holding ``datasets`` (by path: ``name`` or
    ``group/name``), the root ``attrs`` and each dataset's attributes.

    Layout: superblock, global heap, root group, group headers, dataset
    headers, raw data. The heap comes first so that its address is known
    before the attribute messages that point into it are built; every other
    message is of fixed width, so each header is sized before the addresses it
    holds are known and built once."""
    heap = _GlobalHeap(_SUPERBLOCK_SIZE)

    def attribute_msgs(encoded):
        return [(_ATTRIBUTE, _attribute(k, t, p, heap)) for k, (t, p) in encoded.items()]

    attr_msgs = attribute_msgs(attrs)
    ds_attr_msgs = {path: attribute_msgs(a) for path, a in (dataset_attrs or {}).items() if a}
    heap_bytes = heap.encode()
    info = b"\0\0" + struct.pack("<QQ", _UNDEF, _UNDEF)  # compact storage, no index

    # root entries in order of first appearance: a dataset, or a group's members
    root: dict[str, list[str] | None] = {}
    for path in datasets:
        head, _, tail = path.partition("/")
        if tail:
            root.setdefault(head, []).append(path)
        else:
            root[head] = None
    groups = [name for name, members in root.items() if members is not None]

    def group_msgs(links, extra):
        return (
            [(_LINK_INFO, info), (_GROUP_INFO, b"\0\0")]
            + [(_LINK, _link(n.encode("ascii"), a)) for n, a in links]
            + [(_ATTR_INFO, info)]
            + extra
        )

    def ds_msgs(path, addr):
        arr = datasets[path]
        msgs = [
            (_DATASPACE, _dataspace(arr.shape)),
            (_DATATYPE, _datatype(arr.dtype)),
            (_FILL, b"\x03\x0a"),  # fill v3: late allocation, write if set
            (_LAYOUT, b"\x03\x01" + struct.pack("<QQ", addr, arr.nbytes)),
        ]
        if path in ds_attr_msgs:
            msgs += [(_ATTR_INFO, info)] + ds_attr_msgs[path]
        return msgs

    def links_of(names, addrs):
        return [(n.rpartition("/")[2], addrs[n]) for n in names]

    zeros: dict = {p: 0 for p in list(datasets) + groups}
    root_addr = _SUPERBLOCK_SIZE + len(heap_bytes)
    at = root_addr + _header_size(group_msgs(links_of(root, zeros), attr_msgs))
    addrs: dict[str, int] = {}
    for g in groups:
        addrs[g] = at
        at += _header_size(group_msgs(links_of(root[g], zeros), []))
    for path in datasets:
        addrs[path] = at
        at += _header_size(ds_msgs(path, 0))
    data_addrs = {}
    for path, arr in datasets.items():
        data_addrs[path] = at if arr.nbytes else _UNDEF
        at += arr.nbytes

    sb = _SIGNATURE + bytes((2, 8, 8, 0)) + struct.pack("<QQQQ", 0, _UNDEF, at, root_addr)
    out = bytearray(sb + struct.pack("<I", lookup3(sb)))
    out += heap_bytes
    out += _object_header(group_msgs(links_of(root, addrs), attr_msgs))
    for g in groups:
        out += _object_header(group_msgs(links_of(root[g], addrs), []))
    for path in datasets:
        out += _object_header(ds_msgs(path, data_addrs[path]))
    for arr in datasets.values():
        out += arr.tobytes()
    assert len(out) == at
    return out


# --- staging lifecycle --------------------------------------------------------------
class AtomicH5:
    """Staged HDF5 file: invisible until published, gone if discarded."""

    def __init__(self, target: str | os.PathLike) -> None:
        self.target = Path(target).absolute()
        stage_name = f".stage-{os.getpid():x}-{secrets.token_hex(6)}-{self.target.name}"
        self._stage_path: Optional[Path] = self.target.with_name(stage_name)
        self._fd: Optional[int] = os.open(
            self._stage_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644
        )
        self._datasets: dict[str, np.ndarray] = {}
        self._attrs: dict[str, tuple[Any, bytes | str]] = {}
        self._dataset_attrs: dict[str, dict[str, tuple[Any, bytes | str]]] = {}

    def put_all(
        self,
        name: str,
        array: np.ndarray,
        attrs: Mapping[str, Any] | None = None,
        *,
        group: str | None = None,
    ) -> None:
        """Add ``name`` (in ``group`` when given, e.g. ``features``) at its
        final size, with its attributes; it is written whole at publish."""
        _check_name(name)
        if group is not None:
            _check_name(group)
        path = name if group is None else f"{group}/{name}"
        top = path.partition("/")[0]
        if path in self._datasets or (
            top in self._datasets if group is not None
            else any(p.startswith(f"{name}/") for p in self._datasets)
        ):
            raise ValueError(f"dataset {path!r} already exists")
        arr = np.ascontiguousarray(array)
        _datatype(arr.dtype)
        encoded: dict[str, tuple[Any, bytes | str]] = {}
        write_attrs(encoded, attrs or {})
        self._datasets[path] = arr
        if encoded:
            self._dataset_attrs[path] = encoded

    def set_attrs(self, attrs: Mapping[str, Any]) -> None:
        write_attrs(self._attrs, attrs)

    # --- lifecycle -----------------------------------------------------------
    @property
    def live(self) -> bool:
        return self._stage_path is not None

    def _write_and_close(self) -> None:
        fd, self._fd = self._fd, None
        try:
            view = memoryview(_encode(self._datasets, self._attrs, self._dataset_attrs))
            while view:
                view = view[os.write(fd, view):]
        finally:
            os.close(fd)

    def publish(self) -> None:
        """Write and close the staged file and rename it onto the target.

        A failed write or close DISCARDS the stage instead of publishing:
        renaming a truncated H5 onto the target would break the
        files-appear-only-complete contract and make skip-existing treat the
        slide as done forever."""
        if self._stage_path is None:
            return
        try:
            if self._fd is not None:
                self._write_and_close()
        except BaseException:
            stage, self._stage_path = self._stage_path, None
            try:
                stage.unlink(missing_ok=True)
            except OSError:
                pass
            raise
        os.replace(self._stage_path, self.target)
        self._stage_path = None

    def discard(self) -> None:
        """Close and delete the staged file; the target is never touched."""
        if self._stage_path is None:
            return
        try:
            if self._fd is not None:
                fd, self._fd = self._fd, None
                os.close(fd)
        finally:
            try:
                self._stage_path.unlink(missing_ok=True)
            except OSError:
                pass
            self._stage_path = None

    def __enter__(self) -> "AtomicH5":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.publish()
        else:
            self.discard()


# --- reading ------------------------------------------------------------------------
class _Reader:
    def __init__(self, buf: bytes) -> None:
        self.buf = buf

    def fail(self, msg: str):
        raise ValueError(f"not a file of this HDF5 writer: {msg}")

    def object_header(self, addr: int) -> list[tuple[int, bytes]]:
        b = self.buf
        if b[addr : addr + 4] != b"OHDR" or b[addr + 4] != 2 or b[addr + 5] & ~0x03:
            self.fail(f"object header at {addr}")
        width = 1 << (b[addr + 5] & 0x03)
        p = addr + 6
        size = int.from_bytes(b[p : p + width], "little")
        p += width
        end = p + size
        if end + 4 > len(b) or struct.unpack_from("<I", b, end)[0] != lookup3(b[addr:end]):
            self.fail(f"object header checksum at {addr}")
        messages = []
        while p < end:
            mtype, msize = b[p], struct.unpack_from("<H", b, p + 1)[0]
            messages.append((mtype, b[p + 4 : p + 4 + msize]))
            p += 4 + msize
        if p != end:
            self.fail(f"object header messages at {addr}")
        return messages

    def datatype(self, m: bytes) -> tuple[Any, int]:
        """(numpy dtype or the vlen-string marker, encoded length)."""
        cls, bits, size = m[0], m[1], struct.unpack_from("<I", m, 4)[0]
        order = ">" if bits & 1 else "<"
        if cls == 0x10 and m[1:4] in (b"\x00\0\0", b"\x08\0\0", b"\x01\0\0", b"\x09\0\0") \
                and struct.unpack_from("<HH", m, 8) == (0, 8 * size):
            return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}"), 12
        if cls == 0x11 and size in _FLOAT_FIELDS:
            exp_loc, exp_size, mant_size, bias = _FLOAT_FIELDS[size]
            want = struct.pack("<3BIHHBBBBI", bits & 1 | 0x20, 8 * size - 1, 0, size, 0, 8 * size,
                               exp_loc, exp_size, 0, mant_size, bias)
            if m[1:20] == want:
                return np.dtype(f"{order}f{size}"), 20
        if cls == 0x13 and m[1:4] == b"\x01\0\0" and size > 0:
            return np.dtype(f"S{size}"), 8
        if m[: len(_VLEN_STR_TYPE)] == _VLEN_STR_TYPE:
            return _VLEN_STR, len(_VLEN_STR_TYPE)
        self.fail(f"datatype {m[:8].hex()}")

    def dataspace(self, m: bytes) -> tuple[tuple[int, ...], int]:
        if m[:4] == _SCALAR_SPACE:
            return (), 4
        rank = m[1]
        if m[0] != 2 or m[2] != 1 or m[3] != 1 or rank == 0:
            self.fail(f"dataspace {m[:4].hex()}")
        dims = struct.unpack_from(f"<{2 * rank}Q", m, 4)
        if dims[:rank] != dims[rank:]:
            self.fail("resizable dataspace")
        return tuple(dims[:rank]), 4 + 16 * rank

    def heap_object(self, addr: int, index: int, length: int) -> bytes:
        b = self.buf
        if b[addr : addr + 8] != b"GCOL\x01\0\0\0":
            self.fail(f"global heap at {addr}")
        size = struct.unpack_from("<Q", b, addr + 8)[0]
        p, end = addr + 16, addr + size
        while p + 16 <= end:
            idx, _, _, osize = struct.unpack_from("<HHIQ", b, p)
            if idx == 0:
                break
            if idx == index:
                if osize != length:
                    self.fail("heap object length")
                return b[p + 16 : p + 16 + osize]
            p += 16 + osize + (-osize % 8)
        self.fail(f"heap object {index}")

    def attribute(self, m: bytes) -> tuple[str, Any]:
        version, flags, nsize, tsize, ssize, cset = struct.unpack_from("<BBHHHB", m)
        if version != 3 or flags or cset > 1:
            self.fail("attribute message")
        p = 9
        name = m[p : p + nsize - 1].decode("utf-8" if cset else "ascii")
        p += nsize
        dtype, _ = self.datatype(m[p : p + tsize])
        p += tsize
        shape, _ = self.dataspace(m[p : p + ssize])
        p += ssize
        if shape != ():
            self.fail(f"attribute {name!r} is not a scalar")
        if dtype is _VLEN_STR:
            length, addr, index = struct.unpack_from("<IQI", m, p)
            return name, self.heap_object(addr, index, length).decode("utf-8")
        return name, np.frombuffer(m, dtype, 1, p)[0]

    def dataset(self, msgs: list[tuple[int, bytes]], addr: int, data: bool) -> tuple[np.ndarray, dict]:
        if [t for t, _ in msgs[:4]] != [_DATASPACE, _DATATYPE, _FILL, _LAYOUT] or msgs[2][1] != b"\x03\x0a":
            self.fail(f"dataset header at {addr}")
        attrs = self.attributes(msgs[4:], f"dataset header at {addr}")
        shape, _ = self.dataspace(msgs[0][1])
        dtype, _ = self.datatype(msgs[1][1])
        if dtype is _VLEN_STR:
            self.fail("variable-length dataset")
        lay = msgs[3][1]
        if lay[:2] != b"\x03\x01" or len(lay) != 18:
            self.fail("data layout")
        data_addr, nbytes = struct.unpack_from("<QQ", lay, 2)
        count = int(np.prod(shape, dtype=np.int64))
        if nbytes != count * dtype.itemsize:
            self.fail("data size")
        if nbytes and data_addr + nbytes > len(self.buf):
            self.fail("data beyond the end of the file")
        if not data:  # shape and dtype only, no memory behind it
            return np.broadcast_to(np.zeros((), dtype), shape), attrs
        if nbytes == 0:
            return np.empty(shape, dtype), attrs
        return np.frombuffer(self.buf, dtype, count, data_addr).reshape(shape).copy(), attrs

    def attributes(self, msgs: list[tuple[int, bytes]], where: str) -> dict[str, Any]:
        """The attributes of an Attribute Info message and the Attribute
        messages after it (or of no message at all)."""
        if not msgs:
            return {}
        if msgs[0] != (_ATTR_INFO, b"\0\0" + struct.pack("<QQ", _UNDEF, _UNDEF)):
            self.fail(where)
        attrs = {}
        for mtype, m in msgs[1:]:
            if mtype != _ATTRIBUTE:
                self.fail(where)
            key, value = self.attribute(m)
            attrs[key] = value
        return attrs

    def group(self, msgs: list[tuple[int, bytes]], addr: int, prefix: str, tree: "H5Tree",
              data: bool) -> dict[str, Any]:
        """Read a group's members into ``tree``; return its attributes."""
        if [t for t, _ in msgs[:2]] != [_LINK_INFO, _GROUP_INFO] \
                or msgs[0][1] != b"\0\0" + struct.pack("<QQ", _UNDEF, _UNDEF):
            self.fail(f"group at {addr}")
        i = 2
        while i < len(msgs) and msgs[i][0] == _LINK:
            m = msgs[i][1]
            if m[0] != 1 or m[1] not in (0, 1):
                self.fail("link message")
            w = 1 << m[1]
            n = int.from_bytes(m[2 : 2 + w], "little")
            name = m[2 + w : 2 + w + n].decode("ascii")
            target = struct.unpack_from("<Q", m, 2 + w + n)[0]
            child = self.object_header(target)
            if child and child[0][0] == _LINK_INFO:
                if prefix:
                    self.fail(f"group {prefix}{name} below a group")
                if self.group(child, target, f"{name}/", tree, data):
                    self.fail(f"attributes on group {name}")
            else:
                arr, attrs = self.dataset(child, target, data)
                tree.datasets[prefix + name] = arr
                if attrs:
                    tree.dataset_attrs[prefix + name] = attrs
            i += 1
        return self.attributes(msgs[i:], f"group at {addr}")


class H5Tree(NamedTuple):
    """What :func:`read_h5_tree` reads: datasets by path (``coords``,
    ``features/<name>``), the file's attributes, and each dataset's attributes
    by path (datasets without any are left out)."""

    datasets: dict[str, np.ndarray]
    attrs: dict[str, Any]
    dataset_attrs: dict[str, dict[str, Any]]


def read_h5_tree(path: str | os.PathLike, *, data: bool = True) -> H5Tree:
    """Everything in a file this module wrote.

    Values read back as h5py reads them: datasets as numpy arrays, str
    attributes as ``str``, numeric attributes as numpy scalars of their
    stored dtype. With ``data=False`` each dataset is a read-only array of
    its shape and dtype with no values behind it (for presence checks).
    Raises ``ValueError`` on any other layout."""
    buf = Path(path).read_bytes()
    r = _Reader(buf)
    if len(buf) < _SUPERBLOCK_SIZE or buf[:12] != _SIGNATURE + bytes((2, 8, 8, 0)):
        r.fail("superblock")
    base, ext, eof, root = struct.unpack_from("<QQQQ", buf, 12)
    if struct.unpack_from("<I", buf, 44)[0] != lookup3(buf[:44]):
        r.fail("superblock checksum")
    if base != 0 or ext != _UNDEF or eof != len(buf):
        r.fail("superblock addresses")
    tree = H5Tree({}, {}, {})
    tree.attrs.update(r.group(r.object_header(root), root, "", tree, data))
    return tree


def read_h5(path: str | os.PathLike) -> tuple[dict[str, np.ndarray], dict[str, Any]]:
    """(datasets by path, file attributes) of a file this module wrote; see
    :func:`read_h5_tree`."""
    tree = read_h5_tree(path)
    return tree.datasets, tree.attrs


def add_datasets(
    target: str | os.PathLike,
    datasets: Mapping[str, np.ndarray],
    *,
    group: str | None = None,
    attrs: Mapping[str, Mapping[str, Any]] | None = None,
) -> None:
    """Add ``datasets`` (in ``group`` when given), each with ``attrs[name]``,
    to the published file at ``target``.

    The old file's every dataset and attribute and the new datasets go into one
    staged file that replaces the target at once; a name already present, or
    any other failure, discards the stage and leaves the target as it was.
    Costs the old file's size in host memory and one rewrite of it."""
    old = read_h5_tree(target)
    with AtomicH5(target) as store:
        for path, arr in old.datasets.items():
            head, _, name = path.rpartition("/")
            store.put_all(name, arr, old.dataset_attrs.get(path), group=head or None)
        store.set_attrs(old.attrs)
        for name, arr in datasets.items():
            store.put_all(name, arr, (attrs or {}).get(name), group=group)

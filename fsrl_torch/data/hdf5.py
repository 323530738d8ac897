"""A small HDF5 writer and reader for the offline datasets, in numpy alone.

:class:`fsrl_torch.data.traj_buf.TrajectoryBuffer` saves its dataset as
one HDF5 file of named arrays in the root group. This module writes such a
file without h5py (the machines that train on the card may lack it) in the
format h5py and the HDF5 library read: superblock version 0, version 1
object headers, the root group's names in a local heap, a version 1 B-tree
and one symbol table node, and each array as a contiguous dataset (no
chunks, no compression). Arrays of booleans are stored as h5py stores them,
an 8-bit enum of ``FALSE`` and ``TRUE``, so h5py reads them back as
``bool``.

:func:`read_datasets` reads that subset of the format (the root group's
contiguous datasets of fixed-point, floating-point and boolean-enum
types) and raises on anything else.
"""

from __future__ import annotations

import struct

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_HEAP_FREE_NULL = 1          # the local heap's "no free block"
_INTERNAL_K = 16             # the group B-tree's K: up to 32 children
_BTREE_NODE = 24 + (2 * _INTERNAL_K + 1) * 8 + 2 * _INTERNAL_K * 8
_ENTRY = 40                  # a symbol table entry

# message types of the object headers
_DATASPACE, _DATATYPE, _FILL, _LAYOUT, _SYMBOL_TABLE = 1, 3, 5, 8, 17


def _pad8(n: int) -> int:
    return (n + 7) // 8 * 8


def _fixed_point(size: int, signed: bool) -> bytes:
    return (struct.pack("<B3sI", 0x10, bytes([0x08 if signed else 0, 0, 0]),
                        size) + struct.pack("<HH", 0, 8 * size))


def _datatype(dtype: np.dtype) -> bytes:
    """The datatype message of a little-endian numpy dtype."""
    if dtype == np.bool_:
        names = b"".join(n + b"\0" * (8 - len(n)) for n in (b"FALSE",
                                                             b"TRUE"))
        return (struct.pack("<B3sI", 0x18, (2).to_bytes(3, "little"), 1)
                + _fixed_point(1, True) + names + bytes([0, 1]))
    if dtype.kind in "iu":
        return _fixed_point(dtype.itemsize, dtype.kind == "i")
    if dtype == np.float32:
        sign, exp_loc, exp_size, mant_size, bias = 31, 23, 8, 23, 127
    elif dtype == np.float64:
        sign, exp_loc, exp_size, mant_size, bias = 63, 52, 11, 52, 1023
    else:
        raise TypeError(f"no HDF5 type for {dtype}")
    return (struct.pack("<B3sI", 0x11, bytes([0x20, sign, 0]), dtype.itemsize)
            + struct.pack("<HHBBBBI", 0, 8 * dtype.itemsize, exp_loc,
                          exp_size, 0, mant_size, bias))


def _object_header(messages: list[tuple[int, int, bytes]]) -> bytes:
    """A version 1 object header of ``(type, flags, data)`` messages."""
    body = b"".join(struct.pack("<HHB3x", t, _pad8(len(d)), f)
                    + d.ljust(_pad8(len(d)), b"\0") for t, f, d in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _dataset_header(arr: np.ndarray, address: int) -> bytes:
    dims = struct.pack(f"<{arr.ndim}Q", *arr.shape)
    return _object_header([
        (_DATASPACE, 0, struct.pack("<BBB5x", 1, arr.ndim, 1) + dims + dims),
        (_DATATYPE, 1, _datatype(arr.dtype)),
        # fill value: allocated late, written if set, none set
        (_FILL, 1, bytes([2, 2, 2, 1, 0, 0, 0, 0])),
        (_LAYOUT, 0, struct.pack("<BBQQ", 3, 1, address, arr.nbytes)),
    ])


def write_datasets(path: str, arrays: dict[str, np.ndarray]) -> None:
    """Write ``arrays`` as datasets of the root group of a new HDF5 file
    at ``path`` (replacing it)."""
    names = sorted(arrays)      # a symbol table node lists names in order
    if not 0 < len(names) <= 2 * _INTERNAL_K:
        raise ValueError(f"1 to {2 * _INTERNAL_K} datasets, not "
                         f"{len(names)}")
    arrs = {}
    for k in names:
        a = np.asarray(arrays[k])
        arrs[k] = np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("<"))
    leaf_k = max(4, (len(names) + 1) // 2)   # the node holds 2K entries
    heap_data = bytearray(8)                 # offset 0: the empty name
    name_at = {}
    for k in names:
        name_at[k] = len(heap_data)
        raw = k.encode() + b"\0"
        heap_data += raw.ljust(_pad8(len(raw)), b"\0")

    root = 96
    root_size = len(_object_header([(_SYMBOL_TABLE, 0, bytes(16))]))
    btree = root + root_size
    heap = btree + _BTREE_NODE
    heap_seg = heap + 32
    snod = heap_seg + len(heap_data)
    at = snod + 8 + 2 * leaf_k * _ENTRY
    headers = {}
    for k in names:
        headers[k] = at
        at += len(_dataset_header(arrs[k], 0))
    data_at = {}
    for k in names:
        data_at[k] = at
        at = _pad8(at + arrs[k].nbytes)
    eof = at

    out = bytearray(eof)
    out[0:96] = (_SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                 + struct.pack("<HHI", leaf_k, _INTERNAL_K, 0)
                 + struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
                 + struct.pack("<QQI4xQQ", 0, root, 1, btree, heap))
    out[root:btree] = _object_header(
        [(_SYMBOL_TABLE, 0, struct.pack("<QQ", btree, heap))])
    node = (b"TREE" + struct.pack("<BBH", 0, 0, 1)
            + struct.pack("<QQ", _UNDEF, _UNDEF)
            + struct.pack("<QQQ", 0, snod, name_at[names[-1]]))
    out[btree:btree + len(node)] = node
    out[heap:heap_seg] = (b"HEAP" + bytes(4) + struct.pack(
        "<QQQ", len(heap_data), _HEAP_FREE_NULL, heap_seg))
    out[heap_seg:snod] = heap_data
    entries = b"".join(struct.pack("<QQI4x16x", name_at[k], headers[k], 0)
                       for k in names)
    out[snod:snod + 8 + len(entries)] = (
        b"SNOD" + struct.pack("<BBH", 1, 0, len(names)) + entries)
    for k in names:
        h = _dataset_header(arrs[k], data_at[k])
        out[headers[k]:headers[k] + len(h)] = h
        out[data_at[k]:data_at[k] + arrs[k].nbytes] = arrs[k].tobytes()
    with open(path, "wb") as f:
        f.write(out)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------
def _messages(buf: bytes, addr: int) -> dict[int, bytes]:
    version, _, n, _, size = struct.unpack_from("<BBHII", buf, addr)
    if version != 1:
        raise ValueError(f"object header version {version} is not read")
    out, p, end = {}, addr + 16, addr + 16 + size
    for _ in range(n):
        if p >= end:
            raise ValueError("object header continuations are not read")
        mtype, msize = struct.unpack_from("<HH", buf, p)
        out[mtype] = buf[p + 8: p + 8 + msize]
        p += 8 + msize
    return out


def _dtype(msg: bytes) -> np.dtype:
    cls, bits, size = msg[0] & 0x0F, msg[1:4], struct.unpack_from(
        "<I", msg, 4)[0]
    if cls in (0, 1) and bits[0] & 1:
        raise ValueError("big-endian data is not read")
    if cls == 0:
        return np.dtype(f"<{'i' if bits[0] & 0x08 else 'u'}{size}")
    if cls == 1 and size in (4, 8):
        return np.dtype(f"<f{size}")
    if cls == 8:
        n = int.from_bytes(bits[:2], "little")
        names = msg[20: 20 + 16]
        if n == 2 and size == 1 and names == (b"FALSE\0\0\0TRUE\0\0\0\0"):
            return np.dtype(np.bool_)
    raise ValueError(f"datatype class {cls} of size {size} is not read")


def _symbols(buf: bytes, node: int) -> list[tuple[int, int]]:
    """(name offset, object header) of every entry under a B-tree node."""
    if buf[node:node + 4] != b"TREE":
        raise ValueError("not a B-tree node")
    _, level, used = struct.unpack_from("<BBH", buf, node + 4)
    out = []
    for i in range(used):
        child = struct.unpack_from("<Q", buf, node + 24 + 8 + 16 * i)[0]
        if level:
            out += _symbols(buf, child)
            continue
        if buf[child:child + 4] != b"SNOD":
            raise ValueError("not a symbol table node")
        count = struct.unpack_from("<H", buf, child + 6)[0]
        out += [struct.unpack_from("<QQ", buf, child + 8 + _ENTRY * j)
                for j in range(count)]
    return out


def read_datasets(path: str) -> dict[str, np.ndarray]:
    """The root group's datasets of a file :func:`write_datasets` wrote
    (or one of the same subset of the format)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIGNATURE or buf[8] != 0 or buf[13:15] != b"\x08\x08":
        raise ValueError(f"{path}: not an HDF5 file of superblock version 0 "
                         "with 8-byte offsets")
    root = struct.unpack_from("<Q", buf, 64)[0]
    btree, heap = struct.unpack("<QQ", _messages(buf, root)[_SYMBOL_TABLE])
    heap_seg = struct.unpack_from("<Q", buf, heap + 24)[0]
    out = {}
    for name_off, header in _symbols(buf, btree):
        start = heap_seg + name_off
        name = buf[start: buf.index(b"\0", start)].decode()
        msgs = _messages(buf, header)
        space = msgs[_DATASPACE]
        if space[0] != 1:
            raise ValueError(f"{name}: dataspace version {space[0]}")
        shape = struct.unpack_from(f"<{space[1]}Q", space, 8)
        layout = msgs[_LAYOUT]
        if layout[:2] != b"\x03\x01":
            raise ValueError(f"{name}: only contiguous datasets are read")
        addr, size = struct.unpack_from("<QQ", layout, 2)
        dtype = _dtype(msgs[_DATATYPE])
        raw = np.frombuffer(buf, dtype=np.uint8 if dtype == np.bool_
                            else dtype, count=size // dtype.itemsize,
                            offset=addr)
        out[name] = (raw != 0 if dtype == np.bool_ else raw.copy()
                     ).reshape(shape)
    return out

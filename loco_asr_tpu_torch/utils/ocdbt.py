"""A read-only OCDBT key-value store: the on-disk format of TensorStore's
``ocdbt`` kvstore driver, which orbax writes its step directories in.

Read without tensorstore: the manifest (``manifest.ocdbt``, magic
``0c db 3a 2a``), its inline version list, and the B-tree nodes (magic
``0c db 20 de``) of the newest version.  Each of these files is

    magic (u32 big-endian) | length (u64 little-endian, the whole file) |
    version (varint, 0) | compression (varint: 0 none, 1 zstd) |
    body (zstd-compressed when 1) | CRC-32C of all before it (u32 LE)

and every checksum is verified.  Values are inline in the leaf nodes or
byte ranges of the data files under ``d/``; a data file's path is the
node's base path (``ocdbt.process_0/`` in an orbax step's root database,
which so leads into the per-process database) joined to its relative path.
Older versions sit in version-tree nodes (magic ``0c db 12 34``), which a
reader of the newest version does not open.

    store = OcdbtStore(step_dir)
    store.keys()                  # sorted str keys
    store.read("params.w/.zarray")   # bytes

Decompression and checksums run in the native core (``native/``); there is
no numpy lane.  The format is TensorStore's "OCDBT" kvstore page; the
tests hold this reader to tensorstore's own driver.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

from .. import native

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE


class OcdbtError(ValueError):
    """A file of the database is missing its magic, truncated or corrupt."""


class MissingFile(OcdbtError):
    """A file the database refers to is not there."""


@dataclass(frozen=True)
class _Ref:
    """Bytes [offset, offset + length) of the file at ``path`` under the
    database root; ``base`` is that path's base part, which the paths in a
    node stored there are relative to."""
    path: str
    base: str
    offset: int
    length: int


class _Body:
    """A cursor over a decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, why: str):
        raise OcdbtError(f"{self.what}: {why} (byte {self.pos} of {len(self.data)})")

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            if self.pos >= len(self.data) or shift > 63:
                self.fail("truncated varint")
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            shift += 7
            if byte < 0x80:
                return value

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail("truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8s(self, n: int) -> List[int]:
        return list(self.take(n))

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def end(self):
        if self.pos != len(self.data):
            self.fail("bytes left over")


def decode_file(raw: bytes, magic: int, what: str) -> bytes:
    """The body of one manifest or node encoding, its checksum verified."""
    if len(raw) < 18 or struct.unpack(">I", raw[:4])[0] != magic:
        raise OcdbtError(f"{what}: not an OCDBT file of magic {magic:08x}")
    (length,) = struct.unpack("<Q", raw[4:12])
    if length != len(raw):
        raise OcdbtError(f"{what}: header says {length} bytes, found {len(raw)}")
    (want,) = struct.unpack("<I", raw[-4:])
    if native.crc32c(raw[:-4]) != want:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    head = _Body(raw[:-4], what)
    head.pos = 12
    if head.varint() != 0:
        head.fail("unknown format version")
    compression = head.varint()
    body = raw[head.pos:-4]
    if compression == 1:
        try:
            return native.zstd_decompress(body)
        except native.ZstdError as e:
            raise OcdbtError(f"{what}: {e}") from e
    if compression != 0:
        head.fail(f"unknown compression {compression}")
    return body


def _data_files(body: _Body, base: str) -> List[Tuple[str, str]]:
    """A data-file table: prefix-coded paths, each a base path and a relative
    one, under ``base``; (path, its base) relative to the database root."""
    n = body.varint()
    shared = [0] + body.varints(n - 1) if n else []
    suffix = body.varints(n)
    base_len = body.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            body.fail("data-file path prefix longer than the previous path")
        full = prev[:shared[i]] + body.take(suffix[i])
        if base_len[i] > len(full):
            body.fail("data-file base path longer than the path")
        paths.append((base + full.decode(), base + full[:base_len[i]].decode()))
        prev = full
    return paths


def _keys(body: _Body, n: int, with_subtree_prefix: bool) -> Tuple[List[bytes], List[int]]:
    shared = [0] + body.varints(n - 1) if n else []
    suffix = body.varints(n)
    subtree = body.varints(n) if with_subtree_prefix else []
    keys, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            body.fail("key prefix longer than the previous key")
        prev = prev[:shared[i]] + body.take(suffix[i])
        keys.append(prev)
    return keys, subtree


def _locations(body: _Body, files: List[Tuple[str, str]], n: int) -> List[_Ref]:
    ids, offsets, lengths = body.varints(n), body.varints(n), body.varints(n)
    if any(i >= len(files) for i in ids):
        body.fail("data-file index out of range")
    return [_Ref(*files[i], o, ln) for i, o, ln in zip(ids, offsets, lengths)]


class OcdbtStore:
    """The newest version of the OCDBT database at ``root`` (a directory
    holding ``manifest.ocdbt``)."""

    def __init__(self, root: str):
        self.root = root
        self.generation, self._root_ref, self._height = self._read_manifest()
        self._index: Optional[Dict[str, Union[bytes, _Ref]]] = None

    # -- files -------------------------------------------------------------
    def _read(self, ref: _Ref) -> bytes:
        path = os.path.join(self.root, ref.path)
        try:
            with open(path, "rb") as f:
                f.seek(ref.offset)
                out = f.read(ref.length)
        except FileNotFoundError as e:
            raise MissingFile(f"no {path}") from e
        if len(out) != ref.length:
            raise OcdbtError(f"{path}: {ref.length} bytes at {ref.offset} wanted, "
                             f"{len(out)} found")
        return out

    def _read_manifest(self):
        path = os.path.join(self.root, "manifest.ocdbt")
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError as e:
            raise MissingFile(f"no {path}") from e
        body = _Body(decode_file(raw, MANIFEST_MAGIC, path), path)
        body.take(16)                       # uuid
        kind = body.varint()
        body.varint()                       # max_inline_value_bytes
        body.varint()                       # max_decoded_node_bytes
        body.u8s(1)                         # version_tree_arity_log2
        if body.varint() == 1:              # compression: zstd, then its level
            body.take(4)
        if kind != 0:                       # 1: versions in manifest.<n> files
            body.fail(f"manifest kind {kind} is not supported (orbax writes 0, single)")
        files = _data_files(body, "")
        n = body.varint()
        generations = body.varints(n)
        heights = body.u8s(n)
        roots = _locations(body, files, n)
        body.varints(3 * n)                 # num_keys, num_tree_bytes, num_indirect_value_bytes
        body.u64s(n)                        # commit_time
        m = body.varint()                   # version-tree nodes of older versions
        body.varints(m)                     # generation_number
        _locations(body, files, m)
        body.varints(m)                     # num_generations
        body.u64s(m)                        # commit_time
        body.u8s(m)                         # height
        body.end()
        if not n:
            return 0, None, 0
        newest = max(range(n), key=generations.__getitem__)
        ref = roots[newest]
        return generations[newest], (ref if ref.length else None), heights[newest]

    # -- tree --------------------------------------------------------------
    def _walk(self, ref: _Ref, height: int, prefix: bytes,
              out: Dict[str, Union[bytes, _Ref]]) -> None:
        what = f"{os.path.join(self.root, ref.path)}@{ref.offset}"
        body = _Body(decode_file(self._read(ref), BTREE_MAGIC, what), what)
        node_height = body.u8s(1)[0]
        if node_height != height:
            body.fail(f"node height {node_height}, its parent says {height}")
        files = _data_files(body, ref.base)
        n = body.varint()
        if height:
            keys, subtree = _keys(body, n, True)
            children = _locations(body, files, n)
            body.varints(3 * n)             # the children's statistics
            body.end()
            for key, common, child in zip(keys, subtree, children):
                self._walk(child, height - 1, prefix + key[:common], out)
            return
        keys, _ = _keys(body, n, False)
        lengths = body.varints(n)
        kinds = body.varints(n)
        if any(k > 1 for k in kinds):
            body.fail("unknown value kind")
        indirect = [i for i in range(n) if kinds[i] == 1]
        ids, offsets = body.varints(len(indirect)), body.varints(len(indirect))
        for i, fid, off in zip(indirect, ids, offsets):
            if fid >= len(files):
                body.fail("data-file index out of range")
            out[(prefix + keys[i]).decode()] = _Ref(*files[fid], off, lengths[i])
        for i in range(n):
            if kinds[i] == 0:
                out[(prefix + keys[i]).decode()] = body.take(lengths[i])
        body.end()

    def _entries(self) -> Dict[str, Union[bytes, _Ref]]:
        if self._index is None:
            index: Dict[str, Union[bytes, _Ref]] = {}
            if self._root_ref is not None:
                self._walk(self._root_ref, self._height, b"", index)
            self._index = index
        return self._index

    def keys(self) -> List[str]:
        return sorted(self._entries())

    def __contains__(self, key: str) -> bool:
        return key in self._entries()

    def read(self, key: str) -> bytes:
        value = self._entries().get(key)
        if value is None:
            raise KeyError(f"{self.root}: no key {key!r}")
        return value if isinstance(value, bytes) else self._read(value)

"""Read the JAX package's Orbax checkpoints without JAX, Orbax or
tensorstore.

`molclr_tpu.train.checkpoints.save_checkpoint` writes a step directory
`step_<n>/` through Orbax's StandardCheckpointer:
  _METADATA           JSON: `tree_metadata` keyed by the leaves' tuple
                      paths, each with its `key_metadata` and a
                      `value_metadata.value_type` ("np.ndarray",
                      "jax.Array" or "scalar"); `use_ocdbt` true and
                      `use_zarr3` false.
  manifest.ocdbt, d/  an OCDBT key-value store (tensorstore's "OCDBT
                      on-disk format"), merged from the per-process stores
                      under ocdbt.process_<i>/ that it refers to.
  inside the store    one zarr v2 array per leaf, named by the leaf's path
                      joined with '.': `<name>/.zarray` (JSON: shape,
                      chunks, dtype, order, fill_value, compressor) and its
                      chunks `<name>/<i>.<j>` (zstd frames).
Every OCDBT file (manifest, version-tree node, B-tree node) is a header
(magic number big-endian, its own length, format version, compression),
a body (zstd here) and a CRC-32C of all that went before; the body is
columnar: each field is written for all entries before the next field.
Nodes may sit at any offset of a data file, next to out-of-line values,
and a data file's path is relative to the base path of the file whose
table names it.

`read_step_dir(path)` returns the checkpoint's tree as nested dicts of
numpy arrays (a "scalar" leaf as a Python number), every leaf bit for bit
as it was saved. Anything this reader does not know raises OrbaxFormatError
naming the file and the field: a zarr3 or non-OCDBT checkpoint, a
compressor other than zstd, a manifest, node or format version it does not
know, a bad checksum, a truncated file.
"""

from __future__ import annotations

import ast
import json
import os
import posixpath
from dataclasses import dataclass

import numpy as np

from molclr_tpu_torch.native import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
VERSION_NODE_MAGIC = 0x0CDB1234
BTREE_NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
# the offset and length of the root of an empty tree
NO_ROOT = 2**64 - 1


class OrbaxFormatError(ValueError):
    """A checkpoint this reader cannot account for."""


class _Cursor:
    """Reads the varints, fixed-width integers and bytes of one decoded
    body, naming the file and the field on any overrun."""

    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def fail(self, field: str, why: str):
        raise OrbaxFormatError(f"{self.where}: field {field!r}: {why}")

    def varint(self, field: str) -> int:
        v, shift = 0, 0
        while True:
            if self.pos >= len(self.data):
                self.fail(field, "truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail(field, "varint longer than 64 bits")

    def varints(self, n: int, field: str) -> list[int]:
        return [self.varint(field) for _ in range(n)]

    def raw(self, n: int, field: str) -> bytes:
        if self.pos + n > len(self.data):
            self.fail(field, f"needs {n} bytes, {len(self.data) - self.pos} "
                             f"left")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def fixed(self, n: int, field: str, signed: bool = False) -> int:
        return int.from_bytes(self.raw(n, field), "little", signed=signed)

    def end(self):
        if self.pos != len(self.data):
            self.fail("end", f"{len(self.data) - self.pos} bytes left over")


@dataclass(frozen=True)
class _Ref:
    """Bytes [offset, offset + length) of a data file; base is the base
    path that the tables of a node read from there are relative to."""
    path: str
    base: str
    offset: int
    length: int


def _file_table(c: _Cursor, base: str) -> list[tuple[str, str]]:
    """A data file table: (path, base path) of each file, both relative to
    the store's root, the table's own paths being relative to `base`. A
    path that is absolute or leaves the root is refused: a checkpoint is
    input, and the reader opens no file outside its store."""
    n = c.varint("num_files")
    prefix = [0] + c.varints(max(0, n - 1), "path_prefix_length")
    suffix = c.varints(n, "path_suffix_length")
    base_len = c.varints(n, "base_path_length")
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            c.fail("path_prefix_length", "longer than the previous path")
        path = prev[: prefix[i]] + c.raw(suffix[i], "path_suffix")
        if base_len[i] > len(path):
            c.fail("base_path_length", "longer than the path")
        prev = path
        try:
            p = path.decode()
        except UnicodeDecodeError:
            c.fail("path_suffix", f"path {bytes(path)!r} is not UTF-8")
        norm = posixpath.normpath(base + p)
        if posixpath.isabs(norm) or norm == ".." or norm.startswith("../"):
            c.fail("path_suffix", f"data file path {base + p!r} leaves the "
                                  f"store's root")
        out.append((base + p, base + p[: base_len[i]]))
    return out


def _keys(c: _Cursor, n: int) -> tuple[list[int], list[int]]:
    prefix = [0] + c.varints(max(0, n - 1), "key_prefix_length")
    suffix = c.varints(n, "key_suffix_length")
    return prefix, suffix


def _key_bytes(c: _Cursor, prefix, suffix) -> list[bytes]:
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            c.fail("key_prefix_length", "longer than the previous key")
        prev = prev[:p] + c.raw(s, "key_suffix")
        keys.append(prev)
    return keys


class OcdbtStore:
    """The newest version of the OCDBT store rooted at `root`: its keys and
    values (read_all), through the manifest, the version tree and the
    B-tree."""

    def __init__(self, root: str):
        self.root = root
        self._files: dict[str, bytes] = {}
        self._read_manifest()

    # ---- files ----
    def _file(self, rel: str) -> bytes:
        if rel not in self._files:
            path = os.path.join(self.root, rel)
            try:
                with open(path, "rb") as f:
                    self._files[rel] = f.read()
            except OSError as e:
                raise OrbaxFormatError(f"{path}: cannot be read ({e})") \
                    from e
        return self._files[rel]

    def _slice(self, ref: _Ref) -> bytes:
        data = self._file(ref.path)
        if ref.offset + ref.length > len(data):
            raise OrbaxFormatError(
                f"{os.path.join(self.root, ref.path)}: bytes [{ref.offset}, "
                f"{ref.offset + ref.length}) run past its end "
                f"({len(data)} bytes): the file is truncated")
        return data[ref.offset: ref.offset + ref.length]

    def _envelope(self, buf: bytes, magic: int, where: str) -> bytes:
        """The decoded body of one manifest / node, its header and
        checksum checked."""
        c = _Cursor(buf, where)
        got = int.from_bytes(c.raw(4, "magic"), "big")
        if got != magic:
            c.fail("magic", f"{got:#010x} where {magic:#010x} was expected")
        length = c.fixed(8, "length")
        if length != len(buf):
            c.fail("length", f"says {length} bytes, the file holds "
                             f"{len(buf)}: truncated or corrupted")
        if len(buf) < 18:
            c.fail("length", "too short for a header and a checksum")
        crc = int.from_bytes(buf[-4:], "little")
        if zstd.crc32c(buf[:-4]) != crc:
            c.fail("crc32c", "checksum mismatch: the file is corrupted")
        version = c.varint("version")
        if version != FORMAT_VERSION:
            c.fail("version", f"format version {version} is not known")
        comp = c.varint("compression_format")
        body = buf[c.pos: -4]
        if comp == 0:
            return body
        if comp != 1:
            c.fail("compression_format", f"{comp} is not known "
                                         f"(0 none, 1 zstd)")
        try:
            return zstd.decompress(body)
        except zstd.ZstdError as e:
            raise OrbaxFormatError(f"{where}: zstd body: {e}") from e

    # ---- manifest and version tree ----
    def _read_manifest(self):
        where = os.path.join(self.root, "manifest.ocdbt")
        c = _Cursor(self._envelope(self._file("manifest.ocdbt"),
                                   MANIFEST_MAGIC, where), where)
        c.raw(16, "uuid")
        kind = c.varint("manifest_kind")
        if kind != 0:
            c.fail("manifest_kind", f"{kind} (numbered manifests) is not "
                                    f"supported; only 0 (single)")
        c.varint("max_inline_value_bytes")
        c.varint("max_decoded_node_bytes")
        self.arity_log2 = c.fixed(1, "version_tree_arity_log2")
        method = c.varint("compression_method")
        if method == 1:
            c.fixed(4, "zstd_level", signed=True)
        elif method != 0:
            c.fail("compression_method", f"{method} is not known")
        files = _file_table(c, "")
        self.versions = self._version_leaf(c, files)
        n = c.varint("num_version_nodes")
        gen = c.varints(n, "generation_number")
        fid = c.varints(n, "data_file_id")
        off = c.varints(n, "offset")
        ln = c.varints(n, "length")
        c.varints(n, "num_generations")
        for _ in range(n):
            c.fixed(8, "commit_time")
        heights = [c.fixed(1, "height") for _ in range(n)]
        c.end()
        self.version_nodes = [(g, self._ref(files, f, o, l, c), h)
                              for g, f, o, l, h in zip(gen, fid, off, ln,
                                                       heights)]

    def _ref(self, files, fid, offset, length, c: _Cursor) -> _Ref:
        if fid >= len(files):
            c.fail("data_file_id", f"{fid} outside a table of {len(files)}")
        path, base = files[fid]
        return _Ref(path, base, offset, length)

    def _version_leaf(self, c: _Cursor, files) -> list[dict]:
        n = c.varint("num_versions")
        gen = c.varints(n, "generation_number")
        height = [c.fixed(1, "root_height") for _ in range(n)]
        fid = c.varints(n, "data_file_id")
        off = c.varints(n, "offset")
        ln = c.varints(n, "length")
        c.varints(n, "num_keys")
        c.varints(n, "num_tree_bytes")
        c.varints(n, "num_indirect_value_bytes")
        for _ in range(n):
            c.fixed(8, "commit_time")
        # an empty tree (generation 1 of every store) has no root: its
        # offset and length are the all-ones sentinel
        return [{"generation": g, "height": h,
                 "root": (None if l in (0, NO_ROOT)
                          else self._ref(files, f, o, l, c))}
                for g, h, f, o, l in zip(gen, height, fid, off, ln)]

    def all_versions(self) -> list[dict]:
        """Every version the store keeps, oldest first: those of the
        version-tree nodes the manifest refers to, then its inline ones."""
        out = []
        for _, ref, height in self.version_nodes:
            out.extend(self._version_node(ref, height))
        return out + self.versions

    def _version_node(self, ref: _Ref, height: int) -> list[dict]:
        where = (f"{os.path.join(self.root, ref.path)} "
                 f"[{ref.offset}:{ref.offset + ref.length}]")
        c = _Cursor(self._envelope(self._slice(ref), VERSION_NODE_MAGIC,
                                   where), where)
        arity = c.fixed(1, "version_tree_arity_log2")
        if arity != self.arity_log2:
            c.fail("version_tree_arity_log2",
                   f"{arity} where the manifest says {self.arity_log2}")
        h = c.fixed(1, "height")
        if h != height:
            c.fail("height", f"{h} where its parent says {height}")
        files = _file_table(c, ref.base)
        if h == 0:
            out = self._version_leaf(c, files)
            c.end()
            return out
        n = c.varint("num_entries")
        c.varints(n, "generation_number")
        fid = c.varints(n, "data_file_id")
        off = c.varints(n, "offset")
        ln = c.varints(n, "length")
        c.varints(n, "num_generations")
        for _ in range(n):
            c.fixed(8, "commit_time")
        c.end()
        out = []
        for f, o, l in zip(fid, off, ln):
            out.extend(self._version_node(self._ref(files, f, o, l, c),
                                          h - 1))
        return out

    # ---- B-tree ----
    def read_all(self, version: dict | None = None) -> dict[bytes, bytes]:
        """Every key and its value in `version` (default: the newest)."""
        if version is None:
            if not self.versions:
                raise OrbaxFormatError(
                    f"{os.path.join(self.root, 'manifest.ocdbt')}: field "
                    f"'num_versions': the manifest holds no version")
            version = max(self.versions, key=lambda v: v["generation"])
        out: dict[bytes, bytes] = {}
        if version["root"] is not None:
            self._node(version["root"], version["height"], b"", out)
        return out

    def _node(self, ref: _Ref, height: int, prefix: bytes,
              out: dict[bytes, bytes]) -> None:
        where = (f"{os.path.join(self.root, ref.path)} "
                 f"[{ref.offset}:{ref.offset + ref.length}]")
        c = _Cursor(self._envelope(self._slice(ref), BTREE_NODE_MAGIC, where),
                    where)
        h = c.fixed(1, "height")
        if h != height:
            c.fail("height", f"{h} where its parent says {height}")
        files = _file_table(c, ref.base)
        n = c.varint("num_entries")
        kp, ks = _keys(c, n)
        if h > 0:
            common = c.varints(n, "subtree_common_prefix_length")
            keys = _key_bytes(c, kp, ks)
            fid = c.varints(n, "data_file_id")
            off = c.varints(n, "offset")
            ln = c.varints(n, "length")
            c.varints(n, "num_keys")
            c.varints(n, "num_tree_bytes")
            c.varints(n, "num_indirect_value_bytes")
            c.end()
            for k, cp, f, o, l in zip(keys, common, fid, off, ln):
                if cp > len(k):
                    c.fail("subtree_common_prefix_length",
                           "longer than the key")
                self._node(self._ref(files, f, o, l, c), h - 1,
                           prefix + k[:cp], out)
            return
        keys = _key_bytes(c, kp, ks)
        lengths = c.varints(n, "value_length")
        kinds = c.varints(n, "value_kind")
        indirect = [i for i, k in enumerate(kinds) if k == 1]
        if any(k not in (0, 1) for k in kinds):
            c.fail("value_kind", "a kind other than 0 (inline) or 1 "
                                 "(out of line)")
        fid = c.varints(len(indirect), "data_file_id")
        off = c.varints(len(indirect), "offset")
        where_out = dict(zip(indirect, zip(fid, off)))
        for i, (k, ln) in enumerate(zip(keys, lengths)):
            if i in where_out:
                f, o = where_out[i]
                out[prefix + k] = self._slice(self._ref(files, f, o, ln, c))
            else:
                out[prefix + k] = c.raw(ln, "inline_value")
        c.end()


# ---- zarr v2 arrays ----

_DTYPES = {"<f2", "<f4", "<f8", "<i1", "<i2", "<i4", "<i8", "<u1", "<u2",
           "<u4", "<u8", "|i1", "|u1", "|b1", ">f4", ">f8", ">i4", ">i8"}


def _zarr_array(name: str, kv: dict[bytes, bytes], where: str) -> np.ndarray:
    """Assemble zarr v2 array `name` of the store from its chunks: fill
    value where a chunk is absent, the edge chunks cut to the shape."""
    meta_key = f"{name}/.zarray".encode()
    if meta_key not in kv:
        raise OrbaxFormatError(f"{where}: key {meta_key.decode()!r} is "
                               f"missing from the store")
    fld = f"{where}: {meta_key.decode()}"
    meta = json.loads(kv[meta_key])
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{fld}: field 'zarr_format' is "
                               f"{meta.get('zarr_format')!r}, not 2")
    dt = meta.get("dtype")
    if dt not in _DTYPES:
        raise OrbaxFormatError(f"{fld}: field 'dtype' {dt!r} is not known")
    dtype = np.dtype(dt)
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"{fld}: field 'compressor' {comp!r}: only "
                               f"zstd is read")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{fld}: field 'filters' "
                               f"{meta['filters']!r} is not supported")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise OrbaxFormatError(f"{fld}: field 'order' {order!r}")
    sep = meta.get("dimension_separator", ".")
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    if len(chunks) != len(shape):
        raise OrbaxFormatError(f"{fld}: field 'chunks' {chunks} does not "
                               f"match 'shape' {shape}")
    fill = meta.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, dtype=dtype)
    grid = [-(-s // c) if c else 1 for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}".encode()
        if key not in kv:
            continue
        raw = kv[key]
        if comp is not None:
            try:
                raw = zstd.decompress(raw, chunk_bytes)
            except zstd.ZstdError as e:
                raise OrbaxFormatError(
                    f"{where}: chunk {key.decode()!r}: {e}") from e
        if len(raw) != chunk_bytes:
            raise OrbaxFormatError(
                f"{where}: chunk {key.decode()!r} holds {len(raw)} bytes, "
                f"its chunk shape {chunks} needs {chunk_bytes}")
        block = np.frombuffer(raw, dtype=dtype).reshape(chunks, order=order)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


def read_step_dir(path: str) -> dict:
    """The tree of the Orbax step directory `path` (a StandardCheckpointer
    save of the JAX package), as nested dicts of numpy arrays; "scalar"
    leaves as Python numbers, sequences (key_type 1) as lists."""
    meta_path = os.path.join(path, "_METADATA")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except OSError as e:
        raise OrbaxFormatError(f"{meta_path}: cannot be read ({e}); not an "
                               f"Orbax step directory") from e
    except json.JSONDecodeError as e:
        raise OrbaxFormatError(f"{meta_path}: not JSON ({e})") from e
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(f"{meta_path}: field 'use_zarr3' is true: "
                               f"zarr3 checkpoints are not read")
    if not meta.get("use_ocdbt", False):
        raise OrbaxFormatError(f"{meta_path}: field 'use_ocdbt' is not "
                               f"true: only OCDBT checkpoints are read")
    tree_meta = meta.get("tree_metadata")
    if not isinstance(tree_meta, dict):
        raise OrbaxFormatError(f"{meta_path}: field 'tree_metadata' missing")
    kv = OcdbtStore(path).read_all()
    root: dict = {}
    seq_parents: set[int] = set()
    nodes: list[dict] = [root]
    for tkey, entry in tree_meta.items():
        keys = entry.get("key_metadata")
        value = entry.get("value_metadata", {})
        if not keys:
            keys = [{"key": k, "key_type": 2}
                    for k in ast.literal_eval(tkey)]
        vtype = value.get("value_type")
        names = [str(k["key"]) for k in keys]
        if value.get("skip_deserialize"):
            leaf = None
        elif vtype in ("np.ndarray", "jax.Array", "scalar"):
            leaf = _zarr_array(".".join(names), kv, path)
            if vtype == "scalar":
                leaf = leaf.item()
        else:
            raise OrbaxFormatError(f"{meta_path}: leaf {tkey}: field "
                                   f"'value_type' {vtype!r} is not known")
        node = root
        for k, name in zip(keys, names):
            if k.get("key_type") == 1:
                seq_parents.add(id(node))
            if name is names[-1] and k is keys[-1]:
                node[name] = leaf
            else:
                node = node.setdefault(name, {})
                nodes.append(node)
    return _lists(root, seq_parents)


def _lists(node, seq_parents: set[int]):
    """The dicts whose keys are sequence indices (key_type 1: a tuple or a
    list of the saved tree) as lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v, seq_parents) for k, v in node.items()}
    if id(node) in seq_parents:
        return [out[str(i)] for i in range(len(out))]
    return out

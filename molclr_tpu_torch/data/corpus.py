"""On-disk featurized corpus: memory-mapped flat arrays.

Port of molclr_tpu/data/corpus.py; the format (version 1) is byte for byte
the JAX package's, so that a corpus built by either package reads in the
other. A SMILES corpus is featurized once, into a directory of flat
binary arrays that later runs memory-map:

    corpus.mtpu/
      meta.json        {version, n_mols, n_nodes, n_edges, add_hs}
      aoff.i64         [n+1]  node-offset prefix sums
      eoff.i64         [n+1]  directed-edge-offset prefix sums
      atom_type.i32    [n_nodes]   (concatenated per-molecule arrays)
      chirality.i32    [n_nodes]
      edge_src.i32     [n_edges]   (molecule-local indices)
      edge_dst.i32     [n_edges]
      bond_type.i32    [n_edges]
      bond_dir.i32     [n_edges]
      max_degree.i32   [n]         per-molecule max in-degree

DiskCorpus[i] is a MolGraph whose arrays are views of the maps, so packing
a batch touches only that batch's pages. The build streams chunks through
the native batch featurizer (or the Python one, prefer_native=False) and
holds one chunk at a time.
"""

from __future__ import annotations

import json
import os

import numpy as np

from molclr_tpu_torch import native
from molclr_tpu_torch.data.featurize import MolGraph, featurize_smiles

_VERSION = 1
_NODE_FILES = ("atom_type", "chirality")
_EDGE_FILES = native.EDGE_FIELDS


def _chunk_flat(smiles: list[str], add_hs: bool, prefer_native: bool):
    """One chunk as (per-node dict, per-edge dict, atom_counts,
    edge_counts), molecule-local edge indices, failed parses dropped."""
    if prefer_native:
        return native.featurize_corpus_flat(smiles, add_hs=add_hs)
    return native.flatten_graphs(
        [g for g in (featurize_smiles(s, add_hs) for s in smiles)
         if g is not None])


def _max_degrees(edge_dst, aoff, eoff):
    """Per-molecule max in-degree, vectorized over the chunk."""
    n = len(aoff) - 1
    if n == 0:
        return np.empty(0, np.int32)
    if eoff[-1] == 0:
        return np.zeros(n, np.int32)
    glob = edge_dst + np.repeat(aoff[:-1], np.diff(eoff))
    deg = np.bincount(glob, minlength=int(aoff[-1])).astype(np.int32)
    out = np.maximum.reduceat(deg, aoff[:-1])
    out[np.diff(aoff) == 0] = 0
    return out.astype(np.int32)


def build_corpus(smiles_iter, out_dir: str, *, add_hs: bool = False,
                 chunk_size: int = 100_000, prefer_native: bool = True,
                 log=None) -> dict:
    """Stream-featurize a SMILES iterable into `out_dir` (created), one
    chunk in memory at a time. Returns the meta dict."""
    os.makedirs(out_dir, exist_ok=True)
    files = {}
    for f in _NODE_FILES + _EDGE_FILES + ("aoff", "eoff", "max_degree"):
        ext = "i64" if f in ("aoff", "eoff") else "i32"
        files[f] = open(os.path.join(out_dir, f"{f}.{ext}"), "wb")
    node_base = edge_base = n_mols = 0
    files["aoff"].write(np.zeros(1, np.int64).tobytes())
    files["eoff"].write(np.zeros(1, np.int64).tobytes())

    def flush_chunk(chunk):
        nonlocal node_base, edge_base, n_mols
        nodes, edges, acnt, ecnt = _chunk_flat(chunk, add_hs, prefer_native)
        if len(acnt) == 0:
            return
        for f in _NODE_FILES:
            files[f].write(np.ascontiguousarray(nodes[f], np.int32).tobytes())
        for f in _EDGE_FILES:
            files[f].write(np.ascontiguousarray(edges[f], np.int32).tobytes())
        aoff = np.concatenate([[0], np.cumsum(acnt)])
        eoff = np.concatenate([[0], np.cumsum(ecnt)])
        files["max_degree"].write(
            _max_degrees(edges["edge_dst"], aoff, eoff).tobytes())
        files["aoff"].write((aoff[1:] + node_base).astype(np.int64).tobytes())
        files["eoff"].write((eoff[1:] + edge_base).astype(np.int64).tobytes())
        node_base += int(aoff[-1])
        edge_base += int(eoff[-1])
        n_mols += len(acnt)
        if log:
            log(f"corpus build: {n_mols} molecules, {node_base} atoms, "
                f"{edge_base} directed edges")

    try:
        chunk: list[str] = []
        for s in smiles_iter:
            chunk.append(s)
            if len(chunk) >= chunk_size:
                flush_chunk(chunk)
                chunk = []
        if chunk:
            flush_chunk(chunk)
    finally:
        for f in files.values():
            f.close()
    meta = {"version": _VERSION, "n_mols": n_mols, "n_nodes": node_base,
            "n_edges": edge_base, "add_hs": bool(add_hs)}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return meta


def is_disk_corpus(path: str) -> bool:
    return os.path.isdir(path) and \
        os.path.exists(os.path.join(path, "meta.json"))


class DiskCorpus:
    """A memory-mapped featurized corpus; items are MolGraph views of the
    maps. The vectorized `atom_counts` / `edge_counts` / `max_degrees`
    size PadSpecs and split the corpus without a Python object per
    molecule (spec_for_graphs takes them)."""

    def __init__(self, path: str):
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta.get("version") != _VERSION:
            raise ValueError(
                f"corpus version {self.meta.get('version')} != {_VERSION}")
        self.path = path

        def mm(name, dtype):
            ext = "i64" if dtype == np.int64 else "i32"
            return np.memmap(os.path.join(path, f"{name}.{ext}"),
                             dtype=dtype, mode="r")

        self.aoff = mm("aoff", np.int64)
        self.eoff = mm("eoff", np.int64)
        self.max_degrees = mm("max_degree", np.int32)
        self.node = {f: mm(f, np.int32) for f in _NODE_FILES}
        self.edge = {f: mm(f, np.int32) for f in _EDGE_FILES}
        self.atom_counts = np.asarray(np.diff(self.aoff))
        self.edge_counts = np.asarray(np.diff(self.eoff))

    def __len__(self) -> int:
        return int(self.meta["n_mols"])

    def __getitem__(self, i: int) -> MolGraph:
        a0, a1 = int(self.aoff[i]), int(self.aoff[i + 1])
        e0, e1 = int(self.eoff[i]), int(self.eoff[i + 1])
        return MolGraph(
            self.node["atom_type"][a0:a1], self.node["chirality"][a0:a1],
            *[self.edge[f][e0:e1] for f in _EDGE_FILES])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class CorpusSubset:
    """An index view over a DiskCorpus that keeps its vectorized counts
    (BatchIterator touches only the current batch's molecules)."""

    def __init__(self, corpus: DiskCorpus, ids):
        self.corpus = corpus
        self.ids = np.asarray(ids, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, i: int) -> MolGraph:
        return self.corpus[int(self.ids[i])]

    def __iter__(self):
        for i in self.ids:
            yield self.corpus[int(i)]

    @property
    def atom_counts(self):
        return self.corpus.atom_counts[self.ids]

    @property
    def edge_counts(self):
        return self.corpus.edge_counts[self.ids]

    @property
    def max_degrees(self):
        return np.asarray(self.corpus.max_degrees)[self.ids]

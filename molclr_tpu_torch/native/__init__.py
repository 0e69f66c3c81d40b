"""ctypes bindings for the native C++ featurizer and packer (featurizer.cpp).

Port of molclr_tpu/native/__init__.py. The library is compiled with g++ at
first use into build/native/ at the root of the checkout, named by a hash
of the source and the flags, never next to the source. It is built under a
temporary name and renamed into place, so that processes building at once
(test workers) all end with the same complete file. A failed build raises
with the compiler's output: nothing falls back to the Python featurizer or
packer unless the caller asks for them (`prefer_native=False`,
`--no-native`).

`calls` counts the C calls by entry point, so that a caller can check
which path ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
import warnings
from pathlib import Path

import numpy as np

from molclr_tpu_torch.data.featurize import MolGraph
from molclr_tpu_torch.data.graphs import GraphBatch, PackOverflow, PadSpec, \
    check_totals

SRC = Path(__file__).resolve().parent / "featurizer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ["-O2", "-shared", "-fPIC"]

MAX_ATOMS = 1024
MAX_BONDS = 2048
MAX_PACK_NODES = 1 << 20   # the packer's per-node slot counter
# the packers' mask fields: uint8 in C, bool in a GraphBatch (whose field
# order is the C argument order of the packers' outputs)
MASKS = ("node_mask", "edge_mask", "nbr_mask", "bond_mask", "graph_mask")
EDGE_FIELDS = ("edge_src", "edge_dst", "bond_type", "bond_dir")

calls = {"featurize": 0, "featurize_batch": 0, "pack_batch": 0,
         "pack_batch_indexed": 0}

_lock = threading.Lock()
_lib = None


def lib_path() -> Path:
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS]).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libfeaturizer_{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile the library if it is missing; the seconds it took (0.0 when
    it was there). Raises RuntimeError with the compiler's output."""
    lib = lib_path()
    if lib.exists():
        return 0.0
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building the native featurizer with {CXX} "
                           f"failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the native featurizer failed ({CXX} exit "
            f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return time.perf_counter() - t0


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()
        lib = ctypes.CDLL(str(lib_path()))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.mtpu_featurize.restype = ctypes.c_int
        lib.mtpu_featurize.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       *[p] * 8, i32, i32]
        lib.mtpu_featurize_batch.restype = ctypes.c_int
        lib.mtpu_featurize_batch.argtypes = [
            ctypes.c_char_p, i64, ctypes.c_int, *[p] * 9, i64, i64, i32]
        outs = [p] * 20 + [i32]         # the 20 fields, cap_graphs
        caps = [i32] * 4                # cap_nodes, cap_edges, slots, tile
        lib.mtpu_pack_batch.restype = ctypes.c_int
        lib.mtpu_pack_batch.argtypes = [*[p] * 8, i32, *caps, *outs]
        lib.mtpu_pack_batch_indexed.restype = ctypes.c_int
        lib.mtpu_pack_batch_indexed.argtypes = [*[p] * 9, i32, *caps, *outs]
        _lib = lib
        return lib


def _ptr(a: np.ndarray) -> int:
    if not a.flags.c_contiguous:
        raise ValueError("native buffers must be C-contiguous")
    return a.ctypes.data


def featurize_smiles_native(smiles: str, add_hs: bool = False):
    """One molecule -> MolGraph, or None where it does not parse."""
    lib = _load()
    at = np.empty(MAX_ATOMS, np.int32)
    ch = np.empty(MAX_ATOMS, np.int32)
    edge = [np.empty(2 * MAX_BONDS, np.int32) for _ in range(4)]
    na, nb = ctypes.c_int32(0), ctypes.c_int32(0)
    calls["featurize"] += 1
    rc = lib.mtpu_featurize(
        smiles.encode(), int(add_hs), _ptr(at), _ptr(ch),
        *[_ptr(a) for a in edge], ctypes.addressof(na),
        ctypes.addressof(nb), MAX_ATOMS, MAX_BONDS)
    if rc != 0:
        return None
    n, m = na.value, nb.value
    return MolGraph(at[:n].copy(), ch[:n].copy(),
                    *[a[: 2 * m].copy() for a in edge])


def _featurize_buffer(smiles_list: list[str], add_hs: bool):
    """One batch call: (atom_type, chirality, [edge_src, edge_dst,
    bond_type, bond_dir], aoff, eoff, ok), or None where the buffers'
    capacity ran short (the per-molecule API then takes over)."""
    lib = _load()
    buf = ("\n".join(smiles_list) + "\n").encode()
    n_mols = len(smiles_list)
    # one SMILES character holds at least one heavy atom; hydrogens at most
    # ~3x the atoms; plus the MAX_ATOMS / MAX_BONDS headroom the C side
    # needs before each molecule
    per_mol = 8 if add_hs else 4
    acap = max(1 << 16, per_mol * len(buf) + MAX_ATOMS)
    ecap = max(1 << 17, 2 * per_mol * len(buf) + 2 * MAX_BONDS)
    at = np.empty(acap, np.int32)
    ch = np.empty(acap, np.int32)
    edge = [np.empty(ecap, np.int32) for _ in range(4)]
    aoff = np.empty(n_mols + 1, np.int64)
    eoff = np.empty(n_mols + 1, np.int64)
    ok = np.empty(n_mols, np.int32)
    calls["featurize_batch"] += 1
    lib.mtpu_featurize_batch(
        buf, len(buf), int(add_hs), _ptr(at), _ptr(ch),
        *[_ptr(a) for a in edge], _ptr(aoff), _ptr(eoff), _ptr(ok),
        acap, ecap, n_mols)
    if (acap - aoff[n_mols] < MAX_ATOMS
            or ecap - eoff[n_mols] < 2 * MAX_BONDS):
        return None
    return at, ch, edge, aoff, eoff, ok.astype(bool)


def featurize_corpus_native(smiles_list: list[str], add_hs: bool = False):
    """A corpus through the batch API: (graphs, kept indices), as
    loader.featurize_many returns them before its degree filter."""
    out = _featurize_buffer(smiles_list, add_hs)
    if out is None:
        graphs, kept = [], []
        for i, s in enumerate(smiles_list):
            g = featurize_smiles_native(s, add_hs=add_hs)
            if g is not None:
                graphs.append(g)
                kept.append(i)
        return graphs, kept
    at, ch, edge, aoff, eoff, ok = out
    graphs, kept = [], []
    for i in np.flatnonzero(ok).tolist():
        a0, a1, e0, e1 = aoff[i], aoff[i + 1], eoff[i], eoff[i + 1]
        graphs.append(MolGraph(at[a0:a1].copy(), ch[a0:a1].copy(),
                               *[a[e0:e1].copy() for a in edge]))
        kept.append(i)
    return graphs, kept


def featurize_corpus_flat(smiles_list: list[str], add_hs: bool = False):
    """A corpus as FLAT arrays (the on-disk layout, data/corpus.py): (nodes
    {atom_type, chirality}, edges {edge_src, edge_dst, bond_type,
    bond_dir}, atom_counts, edge_counts), molecule-local edge indices,
    the molecules that do not parse dropped."""
    out = _featurize_buffer(smiles_list, add_hs)
    if out is None:
        graphs, _ = featurize_corpus_native(smiles_list, add_hs)
        return flatten_graphs(graphs)
    at, ch, edge, aoff, eoff, ok = out
    acnt, ecnt = np.diff(aoff), np.diff(eoff)
    node_keep = np.repeat(ok, acnt)
    edge_keep = np.repeat(ok, ecnt)
    nodes = {"atom_type": at[: aoff[-1]][node_keep],
             "chirality": ch[: aoff[-1]][node_keep]}
    edges = {f: a[: eoff[-1]][edge_keep] for f, a in zip(EDGE_FIELDS, edge)}
    return nodes, edges, acnt[ok], ecnt[ok]


def flatten_graphs(graphs):
    """MolGraphs as featurize_corpus_flat's flat arrays."""
    def cat(f):
        return (np.concatenate([getattr(g, f) for g in graphs]).astype(
            np.int32) if graphs else np.empty(0, np.int32))

    return ({f: cat(f) for f in ("atom_type", "chirality")},
            {f: cat(f) for f in EDGE_FIELDS},
            np.array([g.n_atoms for g in graphs], np.int64),
            np.array([g.edge_src.shape[0] for g in graphs], np.int64))


def _out_shapes(spec: PadSpec) -> dict:
    n, e, g, k, b = (spec.n_nodes, spec.n_edges, spec.n_graphs,
                     spec.ell_slots, spec.n_bonds)
    sizes = {"atom_type": (n,), "chirality": (n,), "node_graph": (n,),
             "node_mask": (n,), "src": (e,), "dst": (e,), "bond_type": (e,),
             "bond_dir": (e,), "edge_bond": (e,), "edge_mask": (e,),
             "nbr": (n, k), "nbr_bond_type": (n, k), "nbr_bond_dir": (n, k),
             "nbr_bond": (n, k), "nbr_mask": (n, k), "bond_graph": (b,),
             "bond_mask": (b,), "graph_mask": (g,), "graph_n_nodes": (g,),
             "graph_n_bonds": (g,)}
    return {f: (s, np.uint8 if f in MASKS else np.int32)
            for f, s in sizes.items()}


def _empty_out(spec: PadSpec, lead: tuple = ()) -> dict:
    return {f: np.empty(lead + shape, dtype)
            for f, (shape, dtype) in _out_shapes(spec).items()}


def _check_spec(spec: PadSpec) -> None:
    if spec.n_nodes > MAX_PACK_NODES:
        raise ValueError(f"spec {spec} exceeds the native packer's "
                         f"{MAX_PACK_NODES} node slots; pack it with "
                         f"prefer_native=False")


def _raise_overflow(rc: int, spec: PadSpec):
    """After check_totals the packer fails only on a degree (rc -1) or on
    molecule rc - 1, for which the tile alignment leaves no node slots;
    neither message names edges, so BatchIterator drops by atoms."""
    if rc == -1:
        raise PackOverflow(
            f"node degree exceeds max_degree {spec.max_degree}")
    raise PackOverflow(f"molecule {rc - 1} overflows the {spec.n_nodes} "
                       f"node slots (tile {spec.tile})")


def _as_batch(out: dict) -> GraphBatch:
    return GraphBatch(**{f: (v.view(bool) if f in MASKS else v)
                         for f, v in out.items()})


def pack_batch_native(graphs, spec: PadSpec) -> GraphBatch:
    """data.graphs.pack_batch in one C call, bit for bit; PackOverflow with
    the same semantics (a total above its capacity, with the Python
    packer's message; the first molecule that does not fit; a degree above
    spec.max_degree)."""
    _check_spec(spec)
    lib = _load()
    flat_nodes, flat_edges, acnt, ecnt = flatten_graphs(graphs)
    check_totals(len(graphs), int(acnt.sum()), int(ecnt.sum()), spec)
    aoff = np.zeros(len(graphs) + 1, np.int64)
    eoff = np.zeros(len(graphs) + 1, np.int64)
    np.cumsum(acnt, out=aoff[1:])
    np.cumsum(ecnt, out=eoff[1:])
    o = _empty_out(spec)
    calls["pack_batch"] += 1
    rc = lib.mtpu_pack_batch(
        _ptr(flat_nodes["atom_type"]), _ptr(flat_nodes["chirality"]),
        _ptr(aoff), *[_ptr(flat_edges[f]) for f in EDGE_FIELDS], _ptr(eoff),
        len(graphs), spec.n_nodes, spec.n_edges, spec.ell_slots, spec.tile,
        *[_ptr(v) for v in o.values()], spec.n_graphs)
    if rc != 0:
        _raise_overflow(rc, spec)
    return _as_batch(o)


class IndexedPacker:
    """mtpu_pack_batch_indexed over a DiskCorpus's memory-mapped buffers
    (the corpus object keeps them alive), built once and called per batch
    or unit: no Python object per molecule."""

    def __init__(self, corpus, spec: PadSpec):
        _check_spec(spec)
        self.lib = _load()
        self.spec = spec
        self.src = [_ptr(corpus.node["atom_type"]),
                    _ptr(corpus.node["chirality"]), _ptr(corpus.aoff),
                    *[_ptr(corpus.edge[f]) for f in EDGE_FIELDS],
                    _ptr(corpus.eoff)]

    def pack(self, ids: np.ndarray, out: dict) -> int:
        """Pack corpus molecules `ids` into `out`'s arrays; a molecule that
        overflows the spec is dropped (the exact offender the packer
        reports) and the rest repacked. Returns how many were dropped."""
        s = self.spec
        ids = np.ascontiguousarray(ids, np.int32)
        dropped = 0
        while True:
            calls["pack_batch_indexed"] += 1
            rc = self.lib.mtpu_pack_batch_indexed(
                *self.src, _ptr(ids), len(ids), s.n_nodes, s.n_edges,
                s.ell_slots, s.tile, *[_ptr(v) for v in out.values()],
                s.n_graphs)
            if rc == 0:
                return dropped
            if rc == -1:
                _raise_overflow(rc, s)
            ids = np.ascontiguousarray(np.delete(ids, rc - 1), np.int32)
            dropped += 1

    def batch(self, ids: np.ndarray) -> GraphBatch:
        """Corpus molecules `ids` as one GraphBatch; a molecule that
        overflows it is dropped and the batch repacked, with a warning
        (the streaming path of train/pretrain.py)."""
        out = _empty_out(self.spec)
        dropped = self.pack(ids, out)
        if dropped:
            warnings.warn(f"PackOverflow: dropped {dropped} molecule(s) from "
                          f"a streaming batch (spec {self.spec})",
                          stacklevel=2)
        return _as_batch(out)


def pack_unit_stack_indexed(corpus, id_groups, spec: PadSpec,
                            narrow: dict | None = None, chunk: int = 2048,
                            progress=None) -> dict:
    """Ragged per-unit molecule-id groups packed into a [U, ...] stack
    straight from the memory-mapped corpus, one C call per unit (the
    corpus-scale tile-unit packer; regroup.pack_unit_stack makes a Python
    MolGraph per molecule). narrow: a {field: dtype} map; units are packed
    at full width into a [chunk, ...] scratch and cast into the narrow
    output chunk by chunk, so that the host holds the narrow stack and one
    chunk. Returns {field: array [U, ...]}: masks uint8 under `narrow`,
    bool otherwise."""
    packer = IndexedPacker(corpus, spec)
    u = len(id_groups)
    out = {f: np.empty((u,) + s, narrow[f] if narrow else d)
           for f, (s, d) in _out_shapes(spec).items()}
    c = max(1, min(chunk, u))
    scratch = _empty_out(spec, (c,))
    n_dropped = 0
    for lo in range(0, u, c):
        hi = min(lo + c, u)
        for i in range(lo, hi):
            n_dropped += packer.pack(
                id_groups[i], {f: v[i - lo] for f, v in scratch.items()})
        for f in out:
            out[f][lo:hi] = scratch[f][: hi - lo]
        if progress is not None:
            progress(hi, u)
    if n_dropped:
        warnings.warn(f"PackOverflow: dropped {n_dropped} molecule(s) while "
                      f"packing the unit stack (spec {spec})", stacklevel=2)
    if not narrow:
        for f in MASKS:
            out[f] = out[f].view(bool)
    return out

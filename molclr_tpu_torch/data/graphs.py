"""Flat-packed, statically-shaped batched molecular graphs.

Port of molclr_tpu/data/graphs.py (PadSpec, PackOverflow, pack_batch, the
packing bit-identical, by default through the native packer; concat_shards
and concat_views on torch tensors).
Every batch of B molecules is packed into ONE
padded graph with fixed shapes, carrying two adjacency views:

  COO  (`src/dst/bond_type/bond_dir/edge_mask` over [n_edges]); bond k of
       molecule g occupies directed rows 2k/2k+1 (+ offset).
  ELL  (`nbr*` over [n_nodes, K]) per-node padded neighbor lists. Slot 0 is
       the self-loop (bond type 4, dir 0). `nbr_bond` holds the undirected
       bond id; self-loop/padding slots point at the sentinel id n_bonds.

Padding contract:
  - padded nodes: atom_type 0, node_mask False, node_graph 0;
  - padded edges: src/dst 0, edge_mask False;
  - padded graphs: graph_mask False, graph_n_nodes 0.

GraphBatch holds numpy arrays on the host; `.to(device)` gives the same
dataclass holding torch tensors (integers as int64, masks as bool).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from molclr_tpu_torch.data.featurize import SELF_LOOP_BOND_TYPE, MolGraph


@dataclass(frozen=True)
class PadSpec:
    """Static bucket shape. K = max_degree + 1 ELL slots (slot 0 = self).

    tile > 0 requests TILE-ALIGNED packing: no molecule crosses a
    `tile`-node boundary (n_nodes must then be a multiple of tile), so the
    adjacency is block-diagonal with [tile, tile] blocks."""

    n_graphs: int
    n_nodes: int
    n_edges: int       # directed edge capacity (2x bond capacity)
    max_degree: int = 6
    tile: int = 0
    # upper bound on undirected bonds in any single molecule (0 = unknown)
    max_graph_bonds: int = 0

    def __post_init__(self):
        if self.tile:
            if self.n_nodes % self.tile:
                raise ValueError(
                    f"n_nodes {self.n_nodes} not a multiple of tile "
                    f"{self.tile}")

    @property
    def n_bonds(self) -> int:
        return self.n_edges // 2

    @property
    def ell_slots(self) -> int:
        return self.max_degree + 1


@dataclass
class GraphBatch:
    """One packed batch: numpy arrays on the host, or torch tensors after
    `.to(device)`."""

    # node view [n_nodes]
    atom_type: np.ndarray      # int32
    chirality: np.ndarray      # int32
    node_graph: np.ndarray     # int32, graph id per node
    node_mask: np.ndarray      # bool

    # COO edge view [n_edges]
    src: np.ndarray            # int32
    dst: np.ndarray            # int32
    bond_type: np.ndarray      # int32
    bond_dir: np.ndarray       # int32
    edge_bond: np.ndarray      # int32, undirected bond id (sentinel n_bonds)
    edge_mask: np.ndarray      # bool

    # ELL view [n_nodes, K]
    nbr: np.ndarray            # int32, neighbor node index (self at slot 0)
    nbr_bond_type: np.ndarray  # int32
    nbr_bond_dir: np.ndarray   # int32
    nbr_bond: np.ndarray       # int32, undirected bond id
    nbr_mask: np.ndarray       # bool

    # undirected bond view [n_bonds]
    bond_graph: np.ndarray     # int32, graph id per bond
    bond_mask: np.ndarray      # bool

    # graph view [n_graphs]
    graph_mask: np.ndarray     # bool
    graph_n_nodes: np.ndarray  # int32 (real atoms per graph)
    graph_n_bonds: np.ndarray  # int32 (real undirected bonds per graph)

    @property
    def num_nodes(self) -> int:
        return self.atom_type.shape[-1]

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[-1]

    def to(self, device) -> "GraphBatch":
        """Torch tensors on `device`: integer fields as int64 (they index),
        masks as bool."""
        out = {}
        for f in fields(self):
            v = np.asarray(getattr(self, f.name))
            t = torch.from_numpy(v.astype(np.int64) if v.dtype != bool else v)
            out[f.name] = t.to(device)
        return GraphBatch(**out)


class PackOverflow(ValueError):
    pass


def widen(x: torch.Tensor) -> torch.Tensor:
    """A field stored narrow (int8 / int16 indices, uint8 masks) or at
    full width as GraphBatch.to gives it: int64 indices, bool masks."""
    if x.dtype in (torch.bool, torch.uint8):
        return x.bool()
    return x.long()


def concat_shards(batches: list) -> GraphBatch:
    """S same-shape GraphBatches of torch tensors as ONE packed batch, with
    node, graph and bond ids renumbered globally: segment i's ids shift by
    i times the per-segment count, and the per-segment sentinel bond id
    (n_bonds) maps to the concatenated sentinel S * n_bonds, never onto a
    real bond of another segment. Tile-aligned segments stay tile-aligned."""
    a = batches[0]
    n, g, s = a.num_nodes, a.num_graphs, len(batches)
    bmax = a.bond_mask.shape[-1]

    def shift_bond(x, i):
        return torch.where(x == bmax, s * bmax, x + i * bmax)

    def cat(field, shift=0):
        xs = [getattr(b, field) for b in batches]
        return torch.cat([x + i * shift for i, x in enumerate(xs)]
                         if shift else xs)

    out = {f.name: cat(f.name) for f in fields(GraphBatch)}
    for field, shift in (("node_graph", g), ("src", n), ("dst", n),
                         ("nbr", n), ("bond_graph", g)):
        out[field] = cat(field, shift)
    for field in ("edge_bond", "nbr_bond"):
        out[field] = torch.cat([shift_bond(getattr(b, field), i)
                                for i, b in enumerate(batches)])
    return GraphBatch(**out)


def concat_views(a: GraphBatch, b: GraphBatch) -> GraphBatch:
    """The two contrastive views as one packed batch (concat_views=True):
    both run through the encoder in ONE forward, so BatchNorm statistics
    span both views. (The reference runs the views one after the other,
    molclr.py:57-60, which concat_views=False reproduces.)"""
    return concat_shards([a, b])


def check_totals(n_graphs: int, total_nodes: int, total_edges: int,
                 spec: PadSpec) -> None:
    """PackOverflow where a batch's totals exceed the spec's capacities,
    checked before either packer runs (graphs, then nodes, then edges)."""
    if n_graphs > spec.n_graphs:
        raise PackOverflow(f"{n_graphs} graphs > capacity {spec.n_graphs}")
    if total_nodes > spec.n_nodes:
        raise PackOverflow(f"{total_nodes} nodes > capacity {spec.n_nodes}")
    if total_edges > spec.n_edges:
        raise PackOverflow(f"{total_edges} edges > capacity {spec.n_edges}")


def pack_batch(graphs: list[MolGraph], spec: PadSpec,
               prefer_native: bool = True) -> GraphBatch:
    """Pack molecules into one padded GraphBatch.

    Raises PackOverflow if the molecules exceed the bucket's node/edge/graph
    capacity, a node exceeds max_degree, or (tile > 0) a molecule exceeds
    the tile. The native packer (native/, bit for bit the same, with the
    same PackOverflow messages: BatchIterator reads from them which bound
    was exceeded) packs unless the caller asks for this Python
    implementation (prefer_native=False); a failed build of the native
    library, or a spec beyond its node slots, raises."""
    if spec.max_graph_bonds:
        worst = max((g.edge_src.shape[0] // 2 for g in graphs), default=0)
        if worst > spec.max_graph_bonds:
            raise PackOverflow(
                f"a molecule has {worst} bonds > spec.max_graph_bonds "
                f"{spec.max_graph_bonds} (the windowed bond-ranking bound)")
    if prefer_native and graphs:
        from molclr_tpu_torch import native

        return native.pack_batch_native(graphs, spec)
    check_totals(len(graphs), sum(g.n_atoms for g in graphs),
                 sum(g.edge_src.shape[0] for g in graphs), spec)

    N, E, G, K = spec.n_nodes, spec.n_edges, spec.n_graphs, spec.ell_slots
    B = spec.n_bonds

    atom_type = np.zeros(N, np.int32)
    chirality = np.zeros(N, np.int32)
    node_graph = np.zeros(N, np.int32)
    node_mask = np.zeros(N, bool)

    src = np.zeros(E, np.int32)
    dst = np.zeros(E, np.int32)
    bond_type = np.zeros(E, np.int32)
    bond_dir = np.zeros(E, np.int32)
    edge_bond = np.full(E, B, np.int32)
    edge_mask = np.zeros(E, bool)

    nbr = np.zeros((N, K), np.int32)
    nbr_bt = np.zeros((N, K), np.int32)
    nbr_bd = np.zeros((N, K), np.int32)
    nbr_bond = np.full((N, K), B, np.int32)
    nbr_mask = np.zeros((N, K), bool)

    bond_graph = np.zeros(B, np.int32)
    bond_mask = np.zeros(B, bool)

    graph_mask = np.zeros(G, bool)
    graph_n_nodes = np.zeros(G, np.int32)
    graph_n_bonds = np.zeros(G, np.int32)

    node_off = 0
    edge_off = 0
    bond_off = 0
    for gi, g in enumerate(graphs):
        n, e = g.n_atoms, g.edge_src.shape[0]
        if spec.tile:
            if n > spec.tile:
                raise PackOverflow(
                    f"molecule with {n} atoms exceeds tile {spec.tile}")
            used = node_off % spec.tile
            if used and used + n > spec.tile:
                node_off += spec.tile - used    # skip to next tile boundary
            if node_off + n > N:
                raise PackOverflow(
                    f"tile-aligned packing overflows {N} node slots at "
                    f"graph {gi}")
        sl_n = slice(node_off, node_off + n)
        atom_type[sl_n] = g.atom_type
        chirality[sl_n] = g.chirality
        node_graph[sl_n] = gi
        node_mask[sl_n] = True

        sl_e = slice(edge_off, edge_off + e)
        src[sl_e] = g.edge_src + node_off
        dst[sl_e] = g.edge_dst + node_off
        bond_type[sl_e] = g.bond_type
        bond_dir[sl_e] = g.bond_dir
        edge_bond[sl_e] = bond_off + np.arange(e, dtype=np.int32) // 2
        edge_mask[sl_e] = True

        # ELL: slot 0 self-loop, then in-edges in featurization order.
        nbr[sl_n, 0] = np.arange(node_off, node_off + n, dtype=np.int32)
        nbr_bt[sl_n, 0] = SELF_LOOP_BOND_TYPE
        nbr_bd[sl_n, 0] = 0
        nbr_mask[sl_n, 0] = True
        if e:
            # stable-sort edges by destination; within each destination
            # run, the slot is the offset from the run start (+1 for the
            # self-loop in slot 0)
            order = np.argsort(g.edge_dst, kind="stable")
            dst_sorted = g.edge_dst[order]
            run_start = np.r_[0, np.flatnonzero(np.diff(dst_sorted)) + 1]
            starts = np.repeat(run_start, np.diff(np.r_[run_start, e]))
            slots = np.arange(e, dtype=np.int32) - starts + 1
            if slots.max() >= K:
                raise PackOverflow(
                    f"node degree {int(slots.max())} exceeds max_degree "
                    f"{spec.max_degree} in graph {gi}")
            rows = node_off + dst_sorted
            nbr[rows, slots] = node_off + g.edge_src[order]
            nbr_bt[rows, slots] = g.bond_type[order]
            nbr_bd[rows, slots] = g.bond_dir[order]
            nbr_bond[rows, slots] = bond_off + order // 2
            nbr_mask[rows, slots] = True

        bond_graph[bond_off : bond_off + e // 2] = gi
        bond_mask[bond_off : bond_off + e // 2] = True

        graph_mask[gi] = True
        graph_n_nodes[gi] = n
        graph_n_bonds[gi] = e // 2
        node_off += n
        edge_off += e
        bond_off += e // 2

    return GraphBatch(
        atom_type=atom_type, chirality=chirality, node_graph=node_graph,
        node_mask=node_mask,
        src=src, dst=dst, bond_type=bond_type, bond_dir=bond_dir,
        edge_bond=edge_bond, edge_mask=edge_mask,
        nbr=nbr, nbr_bond_type=nbr_bt, nbr_bond_dir=nbr_bd,
        nbr_bond=nbr_bond, nbr_mask=nbr_mask,
        bond_graph=bond_graph, bond_mask=bond_mask,
        graph_mask=graph_mask, graph_n_nodes=graph_n_nodes,
        graph_n_bonds=graph_n_bonds,
    )

"""Host data of the Graphormer network (models/graphormer.py): a graph-token
row per molecule, each molecule's shortest-path distances and the bonds
along one shortest path, and their tile-dense layout in a packed batch.

Graph token. `with_graph_token` puts one row before a molecule's atoms
(atom type GRAPH_TOKEN_TYPE, chirality 0, no bond), so the tile-aligned
packer keeps it in the molecule's tile as the molecule's first row, as
Graphormer puts the graph token at node 0.

Paths. `pair_tables` runs Graphormer's Floyd-Warshall (algos.pyx of
github.com/microsoft/Graphormer) on every molecule: distances 1 per bond,
510 between atoms that no path joins (salts), intermediates k in
ascending order, an intermediate recorded on strict improvement only. Of
the pairs that tie, the path is the one its recursion rebuilds from the
final intermediates: path(i, j) = path(i, k) + path(k, j) for the
intermediate k of (i, j), the bond itself where (i, j) has none. Molecules
of one padded size run together (padding atoms join nothing, so they
never improve a pair), on the caller's device.

Tables, for the atoms i, j of one molecule:
  spatial [n, n] int16   the spatial table's row of the pair: distance + 1
                         (the row Graphormer's collator takes), 511 where
                         the distance is 510; the row 0 is no pair's
  path [n, n, H] uint8   hop h = 1..H of the path as the bond's id 1 +
                         bond_type * NUM_BOND_DIRS + bond_dir; 0 past the
                         path's end (and on the diagonal)

`tile_pairs` lays a packed batch's molecules' tables into its tiles, [T,
S, S] and [T, S, S, H], the block of each molecule's atoms at its rows;
every other pair (graph-token pairs, pairs across molecules, padding)
reads 0. `eval_spec` sizes the evaluation batches, which keep their
order, exactly.

`GraphormerInputs` is the network's host data for the FineTuner
(train/finetune.py `NETWORKS`): the molecules with their graph tokens,
each split's pair tables, the tile tables beside each packed batch and
the pair counters of a train stack.
"""

from __future__ import annotations

import numpy as np
import torch

from molclr_tpu_torch.data.featurize import NUM_ATOM_TYPES, NUM_BOND_DIRS, \
    MolGraph
from molclr_tpu_torch.data.graphs import PadSpec

GRAPH_TOKEN_TYPE = NUM_ATOM_TYPES       # one past the atom table
UNREACHABLE = 510                       # Graphormer's distance of no path
# pairs a Floyd-Warshall chunk holds at once
CHUNK_PAIRS = 1 << 22


def with_graph_token(g: MolGraph) -> MolGraph:
    """The molecule with its graph-token row first and its atoms after."""
    return MolGraph(
        atom_type=np.concatenate([[GRAPH_TOKEN_TYPE], g.atom_type]).astype(
            np.int32),
        chirality=np.concatenate([[0], g.chirality]).astype(np.int32),
        edge_src=(g.edge_src + 1).astype(np.int32),
        edge_dst=(g.edge_dst + 1).astype(np.int32),
        bond_type=g.bond_type, bond_dir=g.bond_dir)


def bond_ids(g: MolGraph) -> np.ndarray:
    """The path table's id of each directed bond."""
    return (1 + g.bond_type * NUM_BOND_DIRS + g.bond_dir).astype(np.uint8)


def _floyd_warshall(graphs: list[MolGraph], size: int, device):
    """Distances [M, s, s] (int32, UNREACHABLE where no path) and the last
    improving intermediate (-1 for none) of molecules padded to `size`
    atoms, and each pair's bond id (0 where no bond joins it)."""
    m = len(graphs)
    dist = torch.full((m, size, size), UNREACHABLE, dtype=torch.int32)
    bond = torch.zeros((m, size, size), dtype=torch.uint8)
    for i, g in enumerate(graphs):
        src = torch.from_numpy(g.edge_src.astype(np.int64))
        dst = torch.from_numpy(g.edge_dst.astype(np.int64))
        dist[i, src, dst] = 1
        bond[i, src, dst] = torch.from_numpy(bond_ids(g))
    eye = torch.arange(size)
    dist[:, eye, eye] = 0
    dist, bond = dist.to(device), bond.to(device)
    inter = torch.full_like(dist, -1)
    for k in range(max(g.n_atoms for g in graphs)):
        cand = dist[:, :, k: k + 1] + dist[:, k: k + 1, :]
        better = cand < dist
        dist = torch.where(better, cand, dist)
        inter = torch.where(better, k, inter)
    return dist, inter, bond


def _paths(dist, inter, bond, hops: int) -> torch.Tensor:
    """The first `hops` bond ids of each pair's path [M, s, s, hops]: the
    bond itself at distance 1; at distance d > 1 the hops of (i, k) then
    those of (k, j), which lie at smaller distances and are built first."""
    out = torch.zeros(dist.shape + (hops,), dtype=torch.uint8,
                      device=dist.device)
    out[..., 0] = torch.where(dist == 1, bond, 0)
    k = inter.clamp(min=0).long()
    k_h = k[..., None].expand(out.shape)
    left_len = torch.gather(dist, 2, k).long()[..., None]     # dist(i, k)
    h = torch.arange(hops, device=dist.device)
    shift = (h - left_len).clamp(min=0)
    longest = int(dist[dist < UNREACHABLE].max())
    for d in range(2, longest + 1):
        at = (dist == d)[..., None]
        if not bool(at.any()):
            continue
        left = torch.gather(out, 2, k_h)          # out[m, i, k(i,j), h]
        right = torch.gather(torch.gather(out, 1, k_h), 3, shift)
        out = torch.where(at, torch.where(h < left_len, left, right), out)
    return out


def pair_tables(graphs: list[MolGraph], hops: int, device="cpu"
                ) -> list[tuple[np.ndarray, np.ndarray]]:
    """(spatial [n, n] int16, path [n, n, hops] uint8) of each molecule
    (module docstring), computed on `device` in chunks of molecules of
    one padded size."""
    sizes = np.array([g.n_atoms for g in graphs], dtype=np.int64)
    padded = -(-np.maximum(sizes, 1) // 8) * 8
    out: list = [None] * len(graphs)
    for size in np.unique(padded):
        ids = np.flatnonzero(padded == size)
        per = max(1, CHUNK_PAIRS // (int(size) ** 2 * max(hops, 1)))
        for lo in range(0, len(ids), per):
            chunk = ids[lo: lo + per]
            dist, inter, bond = _floyd_warshall(
                [graphs[i] for i in chunk], int(size), device)
            path = _paths(dist, inter, bond, hops).cpu().numpy()
            spatial = torch.where(dist >= UNREACHABLE, UNREACHABLE + 1,
                                  dist + 1).to(torch.int16).cpu().numpy()
            for j, i in enumerate(chunk):
                n = int(sizes[i])
                out[i] = (spatial[j, :n, :n], path[j, :n, :n])
    return out


def tile_pairs(batch, tables: list, tile: int, hops: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """(spatial [T, S, S] int16, path [T, S, S, hops] uint8) of a packed
    batch (numpy GraphBatch, tile S) whose slot g holds the molecule of
    tables[g]: each molecule's atoms' block at their rows, 0 elsewhere."""
    t = batch.num_nodes // tile
    spatial = np.zeros((t, tile, tile), np.int16)
    path = np.zeros((t, tile, tile, hops), np.uint8)
    # each molecule's graph-token row, in slot order
    rows = np.flatnonzero(np.asarray(batch.node_mask, bool)
                          & (np.asarray(batch.atom_type) == GRAPH_TOKEN_TYPE))
    if len(rows) != len(tables):
        raise ValueError(f"{len(rows)} molecules packed, {len(tables)} "
                         f"tables")
    for r, (sp, pa) in zip(rows.tolist(), tables):
        k, a = divmod(r, tile)
        a, n = a + 1, sp.shape[0]         # the atoms follow their token
        spatial[k, a: a + n, a: a + n] = sp
        path[k, a: a + n, a: a + n] = pa
    return spatial, path


def eval_spec(splits: list[list[MolGraph]], batch_size: int, tile: int,
              max_degree: int) -> PadSpec:
    """The PadSpec that packs every batch of each split in order (the
    evaluation batches' fixed compositions) with no slack: the most tiles
    that the packer's tile-aligned placement of one batch fills, and the
    most directed bonds of one batch."""
    tiles, edges, deg, bonds = 1, 8, 1, 0
    for graphs in splits:
        for lo in range(0, len(graphs), batch_size):
            off = e = 0
            for g in graphs[lo: lo + batch_size]:
                used = off % tile
                if used and used + g.n_atoms > tile:
                    off += tile - used
                off += g.n_atoms
                e += g.edge_src.shape[0]
                deg = max(deg, g.max_degree)
                bonds = max(bonds, g.n_bonds)
            tiles = max(tiles, -(-off // tile))
            edges = max(edges, e)
    return PadSpec(batch_size, tiles * tile, -(-edges // 2) * 2,
                   min(max_degree, deg), tile, max_graph_bonds=bonds)


class GraphormerInputs:
    """The FineTuner's host data of a GraphormerNet (`model`: its
    ModelConfig; the pair tables are computed on `device`)."""

    def __init__(self, model, device):
        self.tile, self.hops, self.device = model.tile, model.max_hops, \
            device
        self.tables: dict[str, list] = {}

    def prepare(self, graphs: list[MolGraph], splits: dict
                ) -> list[MolGraph]:
        """The molecules as packed, each with its graph token; keeps each
        split's (name: molecule ids) pair tables."""
        tables = pair_tables(graphs, self.hops, self.device)
        self.tables = {name: [tables[i] for i in ids]
                       for name, ids in splits.items()}
        return [with_graph_token(g) for g in graphs]

    def eval_spec(self, graphs: list[MolGraph], splits: dict,
                  batch_size: int, max_degree: int) -> PadSpec:
        """The valid and test batches' exact spec (the attention's work
        grows with the tiles)."""
        return eval_spec([[graphs[i] for i in splits[name]]
                          for name in ("valid", "test")], batch_size,
                         self.tile, max_degree)

    def arrays(self, split: str, batch, idx) -> dict[str, np.ndarray]:
        """The network's inputs beside a packed batch of `split` whose
        slots hold its molecules idx, in the network's order."""
        tables = self.tables[split]
        spatial, path = tile_pairs(batch, [tables[i] for i in idx],
                                   self.tile, self.hops)
        return {"spatial": spatial, "path": path}

    @staticmethod
    def counters(batches: dict, arrays: dict) -> dict[str, int]:
        """Of a train stack ([S, ...] host tensors): the pairs its
        molecules need, sum of (atoms + 1)^2, and those the tile attention
        computes, T tile^2 a row."""
        atoms = batches["graph_n_nodes"].numpy().astype(np.int64)
        return {"pairs_real": int((atoms ** 2).sum()),
                "pairs_computed": int(np.prod(arrays["spatial"].shape,
                                              dtype=np.int64))}

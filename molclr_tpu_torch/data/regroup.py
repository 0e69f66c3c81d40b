"""Fresh per-epoch batch compositions on the device-resident path.

Port of molclr_tpu/data/regroup.py (`plan_units`, `unit_spec_for`,
`pack_unit_stack`, `concat_units`, `epoch_unit_orders`,
`unit_stack_bytes`) and of the narrow wire dtypes of
molclr_tpu/train/pretrain.py (`_wire_dtypes`, `_widen_fn`).

The reference re-draws batch MEMBERSHIP every epoch (its DataLoader
reshuffles molecules, dataset/dataset.py:179-183). The corpus is packed
once into fixed-shape TILE-UNITS: each unit is a mini GraphBatch of exactly
`tile` node slots, G_t graph slots and E_t edge slots, holding whole
molecules. The [U, ...] unit stack is uploaded once; every step takes T
unit rows (`index_select`) and renumbers them into one standard GraphBatch
on the device: node += i * tile, graph += i * G_t, bond += i * B_t with the
sentinel bond B_t mapped to T * B_t, the arithmetic of
`graphs.concat_shards`. Molecules inside one unit stay together across
epochs; everything across units is redrawn.

The stack lives on the device as a dict of tensors: int32 and bool at
full width, or int8 / int16 / uint8 where the unit spec fits them
(`wire_dtypes`), which is exact because every per-unit value is bounded by
the unit spec. `concat_units` widens each field after the take, to int64
and bool as `GraphBatch.to` has them, and adds the offsets after the
widening.

For an on-disk corpus (data/corpus.py), `plan_corpus_units` plans the
units from the corpus's vectorized counts and `pack_unit_stack_corpus`
packs them with the native packer straight from the memory maps, narrow
where asked, without a Python object per molecule.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from molclr_tpu_torch.data.graphs import GraphBatch, PadSpec, pack_batch, \
    widen


def plan_units(graphs, tile: int) -> list[list]:
    """Greedy first-fit grouping of molecules into `tile`-node units,
    keeping the given order (shuffle upstream for mixed units)."""
    groups, cur, nodes = [], [], 0
    for g in graphs:
        if g.n_atoms > tile:
            raise ValueError(
                f"molecule with {g.n_atoms} atoms exceeds tile {tile}")
        if nodes + g.n_atoms > tile:
            groups.append(cur)
            cur, nodes = [], 0
        cur.append(g)
        nodes += g.n_atoms
    if cur:
        groups.append(cur)
    return groups


def unit_spec_for(groups, tile: int, max_degree: int = 6) -> PadSpec:
    """The one PadSpec that covers every planned unit: G_t and E_t are the
    worst case over the groups."""
    g_t = max(len(gr) for gr in groups)
    e_t = max(sum(g.edge_src.shape[0] for g in gr) for gr in groups)
    e_t = -(-e_t // 2) * 2
    max_bonds = max(g.edge_src.shape[0] // 2
                    for gr in groups for g in gr)
    return PadSpec(n_graphs=g_t, n_nodes=tile, n_edges=max(e_t, 2),
                   max_degree=max_degree, tile=tile,
                   max_graph_bonds=max_bonds)


def stack_batches(batches) -> GraphBatch:
    """Same-shape host GraphBatches stacked on a leading axis."""
    return GraphBatch(**{f.name: np.stack([np.asarray(getattr(b, f.name))
                                           for b in batches])
                         for f in fields(GraphBatch)})


def pack_unit_stack(graphs, tile: int, max_degree: int = 6, seed: int = 0,
                    prefer_native: bool = True):
    """Pack a corpus into the [U, ...] tile-unit stack (host, once).
    Returns (stack: a GraphBatch of numpy arrays with leading axis U,
    unit spec, units). The molecules are shuffled once (seeded) before
    grouping, so that units mix the corpus."""
    order = np.random.RandomState(seed).permutation(len(graphs))
    groups = plan_units([graphs[i] for i in order], tile)
    uspec = unit_spec_for(groups, tile, max_degree)
    units = [pack_batch(gr, uspec, prefer_native) for gr in groups]
    return stack_batches(units), uspec, units


def wire_dtypes(spec: PadSpec) -> dict | None:
    """Narrow storage dtypes per field: node and bond indices as int16,
    categorical codes as int8, masks as uint8; None when the spec exceeds
    int16's range."""
    if max(spec.n_nodes, spec.n_edges, spec.n_bonds + 1) >= (1 << 15):
        return None
    i8, i16, u8 = np.int8, np.int16, np.uint8
    return {
        "atom_type": i8, "chirality": i8, "node_graph": i16,
        "node_mask": u8, "src": i16, "dst": i16, "bond_type": i8,
        "bond_dir": i8, "edge_bond": i16, "edge_mask": u8, "nbr": i16,
        "nbr_bond_type": i8, "nbr_bond_dir": i8, "nbr_bond": i16,
        "nbr_mask": u8, "bond_graph": i16, "bond_mask": u8,
        "graph_mask": u8, "graph_n_nodes": i16, "graph_n_bonds": i16,
    }


def unit_stack_bytes(uspec: PadSpec, n_units: int,
                     narrow: dict | None = None) -> int:
    """Bytes of a [U, ...] unit stack in the narrow dtypes, or at full
    width (int32 indices, bool masks)."""
    n, e, g, k = uspec.n_nodes, uspec.n_edges, uspec.n_graphs, \
        uspec.ell_slots
    bn = uspec.n_bonds
    sizes = {
        "atom_type": n, "chirality": n, "node_graph": n, "node_mask": n,
        "src": e, "dst": e, "bond_type": e, "bond_dir": e,
        "edge_bond": e, "edge_mask": e,
        "nbr": n * k, "nbr_bond_type": n * k, "nbr_bond_dir": n * k,
        "nbr_bond": n * k, "nbr_mask": n * k,
        "bond_graph": bn, "bond_mask": bn,
        "graph_mask": g, "graph_n_nodes": g, "graph_n_bonds": g,
    }
    total = 0
    for f, cnt in sizes.items():
        if narrow:
            itemsize = np.dtype(narrow[f]).itemsize
        else:
            itemsize = 1 if f.endswith("mask") else 4
        total += cnt * itemsize
    return total * n_units


def upload_stack(stack, device,
                 narrow: dict | None = None) -> dict[str, torch.Tensor]:
    """A host stack (a GraphBatch, or a dict of its fields) as the device
    stack: each field in its narrow dtype, or at full width (int32,
    bool)."""
    out = {}
    for f in fields(GraphBatch):
        v = np.asarray(stack[f.name] if isinstance(stack, dict)
                       else getattr(stack, f.name))
        if narrow is not None:
            v = v.astype(narrow[f.name])
        elif v.dtype != bool:
            v = v.astype(np.int32)
        out[f.name] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def concat_units(stack: dict[str, torch.Tensor],
                 idx: torch.Tensor) -> GraphBatch:
    """T unit rows of a device stack as one GraphBatch: a take of the rows
    in `idx` ([T] int64 on the stack's device), each field widened after
    the take, and the per-slot offsets. Equal to
    `graphs.concat_shards([units[i].to(device) for i in idx])`, field for
    field."""
    t = idx.shape[0]
    n = stack["atom_type"].shape[1]        # tile
    g = stack["graph_mask"].shape[1]       # G_t
    bmax = stack["bond_graph"].shape[1]    # B_t
    off = torch.arange(t, device=idx.device)
    shifts = {"node_graph": g, "src": n, "dst": n, "nbr": n,
              "bond_graph": g, "edge_bond": bmax, "nbr_bond": bmax}
    out = {}
    for f in fields(GraphBatch):
        y = widen(torch.index_select(stack[f.name], 0, idx))
        if f.name in shifts:
            o = off.reshape((t,) + (1,) * (y.dim() - 1)) * shifts[f.name]
            if f.name.endswith("_bond"):
                # the per-unit sentinel B_t maps to the concatenated one
                # T * B_t, never onto a real bond of another unit
                y = torch.where(y == bmax, t * bmax, y + o)
            else:
                y = y + o
        out[f.name] = y.reshape((t * y.shape[1],) + y.shape[2:])
    return GraphBatch(**out)


def epoch_unit_orders(n_units: int, units_per_batch: int, seed: int,
                      epoch: int) -> np.ndarray:
    """The units of each step of an epoch, [S, T]: a fresh permutation of
    all units, the remainder (< T units) dropped. Seeded by (seed, epoch),
    as the JAX package seeds it, so that a resumed run draws the same
    stream."""
    rng = np.random.RandomState((seed * 1_000_003 + epoch) % (2**31 - 1))
    perm = rng.permutation(n_units).astype(np.int32)
    s = n_units // units_per_batch
    return perm[: s * units_per_batch].reshape(s, units_per_batch)


def plan_corpus_units(subset, tile: int, max_degree: int = 6,
                      seed: int = 0):
    """plan_units over a CorpusSubset from its vectorized counts: first-fit
    over a seeded shuffle of the subset, as pack_unit_stack shuffles a
    list. Returns (id_groups: one int32 array of corpus molecule ids per
    unit, the unit PadSpec)."""
    if len(subset) == 0:
        raise ValueError("cannot plan tile-units for an empty subset")
    order = np.random.RandomState(seed).permutation(len(subset))
    ids = np.asarray(subset.ids)[order].astype(np.int32)
    atoms = np.asarray(subset.atom_counts)[order]
    edges = np.asarray(subset.edge_counts)[order]
    if int(atoms.max()) > tile:
        raise ValueError(
            f"molecule with {int(atoms.max())} atoms exceeds tile {tile}")
    bounds = [0]
    acc = 0
    for i, c in enumerate(atoms.tolist()):
        if acc + c > tile:
            bounds.append(i)
            acc = 0
        acc += c
    bounds.append(len(atoms))
    bounds = np.asarray(bounds, np.int64)
    sizes = np.diff(bounds)
    group_edges = np.add.reduceat(edges, bounds[:-1])
    e_t = -(-int(group_edges.max()) // 2) * 2
    uspec = PadSpec(n_graphs=int(sizes.max()), n_nodes=tile,
                    n_edges=max(e_t, 2), max_degree=max_degree, tile=tile,
                    max_graph_bonds=int(edges.max()) // 2)
    return [ids[bounds[i]:bounds[i + 1]]
            for i in range(len(bounds) - 1)], uspec


def pack_unit_stack_corpus(subset, tile: int, max_degree: int = 6,
                           seed: int = 0, narrow: dict | None = None,
                           progress=None):
    """pack_unit_stack for a CorpusSubset: the plan of plan_corpus_units,
    packed by the native packer from the memory maps. Returns (stack: a
    dict of [U, ...] arrays, in the `narrow` dtypes where given, unit
    spec, U). The Pretrainer runs these two steps itself, to check its
    device budget between them."""
    from molclr_tpu_torch import native

    id_groups, uspec = plan_corpus_units(subset, tile, max_degree, seed)
    stack = native.pack_unit_stack_indexed(
        subset.corpus, id_groups, uspec, narrow=narrow, progress=progress)
    return stack, uspec, len(id_groups)

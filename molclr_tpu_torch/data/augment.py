"""Stochastic graph augmentation on the device: node augmentation.

Port of molclr_tpu/data/augment.py (the `node` kind and the helpers it
runs). Molecules are featurized once; augmentation is tensor math on the
padded batch, on the batch's device:

  node  per graph mask max(1, floor(0.25 N)) atoms to [118, 0] and delete
        floor(0.25 M) bonds (both directions at once)
        (ref dataset/dataset.py:111-147)

Sampling without replacement ranks uniform keys within each graph's
contiguous segment, sort-free where the layout allows it: tile-aligned node
buffers use a per-tile compare-and-count (_segment_ranks_tile) and bond
buffers a windowed compare-and-count (_segment_ranks_window, bound by
spec.max_graph_bonds); other batches take one lexicographic sort.

`node_augment` is a pure function of the batch and its random inputs (node
keys in [0, 2^20) and two hash salts), so that given JAX's draws it gives
JAX's views bit for bit; `draw_node_keys` draws those inputs from a
torch.Generator on the CPU, so that a run on the card and one on the CPU
see the same views. The subgraph and mix kinds are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from molclr_tpu_torch.data.featurize import MASK_ATOM_TYPE

_INT32_MAX = 0x7FFFFFFF
_U32 = 0xFFFFFFFF
# the fields every augmentation kind changes; the rest is the base batch
AUG_DELTA_FIELDS = ("atom_type", "chirality", "edge_mask", "nbr_mask")


def _segment_ranks(key, seg, valid, seg_counts):
    """Rank of each valid element among its segment's valid elements,
    ordered by `key` (position breaks ties). Elements of segment g are
    contiguous in the flat buffer; padding may sit anywhere (sorted last
    via ~valid)."""
    n = key.shape[0]
    # lexsort((key, seg, ~valid)) as three stable sorts, last key first
    order = torch.argsort(key, stable=True)
    order = order[torch.argsort(seg[order], stable=True)]
    order = order[torch.argsort((~valid)[order].to(torch.int8),
                                stable=True)]
    start = torch.cumsum(seg_counts, 0) - seg_counts
    pos = torch.arange(n, device=key.device) - start[seg[order]]
    rank = torch.zeros(n, dtype=torch.long, device=key.device)
    rank[order] = pos
    return rank


def _segment_ranks_tile(key, seg, valid, tile: int):
    """Sort-free segment ranking for TILE-ALIGNED node buffers: every
    segment lives inside one tile, so rank_i = #{j in the same segment :
    (key_j, j) < (key_i, i)} is a per-tile [tile, tile] compare-and-count.
    Equal to _segment_ranks."""
    n = key.shape[0]
    t = n // tile
    k2 = torch.where(valid, key, _INT32_MAX).reshape(t, tile)
    seg2 = torch.where(valid, seg, -1).reshape(t, tile)
    idx = torch.arange(tile, device=key.device)
    same = seg2[:, :, None] == seg2[:, None, :]
    kj, ki = k2[:, None, :], k2[:, :, None]
    less = (kj < ki) | ((kj == ki) & (idx[None, None, :] < idx[None, :, None]))
    return (same & less).sum(dim=2).reshape(n)


def _segment_ranks_window(key, seg, valid, window: int):
    """Sort-free segment ranking for CONTIGUOUS-segment buffers (bonds) whose
    segments are at most `window` long: a segment's elements lie in its own
    block of `window` or the two adjacent ones, so the rank is a
    [B, W, 3W] compare-and-count over a band. Equal to _segment_ranks on
    valid rows."""
    n = key.shape[0]
    w = max(int(window), 1)
    pad = (-n) % w
    dev = key.device
    if pad:
        key = torch.cat([key, key.new_full((pad,), _INT32_MAX)])
        seg = torch.cat([seg, seg.new_full((pad,), -1)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    b = (n + pad) // w
    kb, sb, vb = key.reshape(b, w), seg.reshape(b, w), valid.reshape(b, w)
    ib = torch.arange(n + pad, device=dev).reshape(b, w)

    def band(x, fill):
        edge = x.new_full((1, w), fill)
        return torch.cat([torch.cat([edge, x[:-1]]), x,
                          torch.cat([x[1:], edge])], dim=1)      # [B, 3W]

    kw, sw = band(kb, _INT32_MAX), band(sb, -1)
    vw, iw = band(vb, False), band(ib, -1)
    same = sw[:, None, :] == sb[:, :, None]                      # [B, W, 3W]
    less = (kw[:, None, :] < kb[:, :, None]) | (
        (kw[:, None, :] == kb[:, :, None]) & (iw[:, None, :] < ib[:, :, None]))
    cnt = (same & vw[:, None, :] & less).sum(dim=2)
    return cnt.reshape(-1)[:n]


def _bond_ranks(batch, key, bond_window: int):
    if bond_window:
        return _segment_ranks_window(key, batch.bond_graph, batch.bond_mask,
                                     bond_window)
    return _segment_ranks(key, batch.bond_graph, batch.bond_mask,
                          batch.graph_n_bonds)


def _node_ranks(batch, key, tile: int):
    if tile:
        return _segment_ranks_tile(key, batch.node_graph, batch.node_mask,
                                   tile)
    return _segment_ranks(key, batch.node_graph, batch.node_mask,
                          batch.graph_n_nodes)


def _mulmod32(x, c: int):
    """x * c mod 2^32 for int64 x in [0, 2^32): the product of two 32-bit
    halves would overflow int64, so multiply by c's 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def _mix_keys(salts, ids):
    """Uniform keys in [0, 1<<20) as an elementwise hash of the ids
    (murmur3-finalizer avalanche, salted per draw), in uint32 arithmetic
    carried in int64. Bit-equal to the JAX package's _mix_keys."""
    x = (ids.long() & _U32) ^ (salts[0].long() & _U32)
    x = _mulmod32(x ^ (x >> 16), 0x7FEB352D)
    x = _mulmod32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16) ^ (salts[1].long() & _U32)
    return x >> 12


def _bond_threshold(batch, key_b, rank_b, k_b):
    """Per-graph lexicographic drop threshold (hc, bc): bond b of graph g is
    dropped iff (key(b), b) <= (hc[g], bc[g]); graphs with k_b == 0 get
    (-1, -1). The threshold is the (k_b - 1)-ranked bond's (key, id),
    selected per graph by a one-hot product in f64 (exact for keys < 2^20
    and ids < 2^24, and out of TF32's reach)."""
    g = batch.num_graphs
    dev = key_b.device
    sel = batch.bond_mask & (rank_b == k_b[batch.bond_graph] - 1)
    oh = (batch.bond_graph[:, None] == torch.arange(g, device=dev)).double()
    vals = torch.stack([sel * key_b, sel * torch.arange(
        key_b.shape[0], device=dev)], dim=1).double()              # [B, 2]
    thr = (oh.t() @ vals).long()                                  # [G, 2]
    have = k_b > 0
    return (torch.where(have, thr[:, 0], -1),
            torch.where(have, thr[:, 1], -1))


def _nbr_mask_lex_drop(batch, salts, hc, bc):
    """The ELL mask after a lex-threshold bond drop: each slot's bond key is
    recomputed from nbr_bond and compared with its node's graph
    threshold."""
    keys = _mix_keys(salts, batch.nbr_bond)                       # [N, K]
    is_bond = batch.nbr_bond < batch.bond_mask.shape[0]           # sentinel
    hcn = hc[batch.node_graph][:, None]
    bcn = bc[batch.node_graph][:, None]
    drop = is_bond & ((keys < hcn) | ((keys == hcn) & (batch.nbr_bond <= bcn)))
    return batch.nbr_mask & ~drop


def _mask_atoms(batch, flag):
    return (torch.where(flag, MASK_ATOM_TYPE, batch.atom_type),
            torch.where(flag, 0, batch.chirality))


def _apply_bond_drop(batch, drop_bond):
    """Kill both directed rows and both ELL slots of dropped bonds."""
    keep = torch.cat([~drop_bond, drop_bond.new_ones(1)])   # sentinel id
    return (batch.edge_mask & keep[batch.edge_bond],
            batch.nbr_mask & keep[batch.nbr_bond])


def node_augment(batch, key_n, salts, node_frac: float = 0.25,
                 bond_frac: float = 0.25, tile: int = 0,
                 bond_window: int = 0):
    """Atom masking + bond deletion (ref dataset/dataset.py:111-147).

    key_n [N] int in [0, 2^20) ranks the atoms; salts [2] int in
    [0, 2^31 - 1) salt the bond hash. Given the JAX package's
    `_rand_keys(rng_n, N)` and `_hash_salts(rng_b)` this returns its
    node_augment(batch, rng) bit for bit."""
    dev = batch.atom_type.device
    key_n, salts = key_n.to(dev), salts.to(dev)
    rank_n = _node_ranks(batch, key_n.long(), tile)
    k_n = torch.where(
        batch.graph_mask,
        torch.clamp(torch.floor(node_frac * batch.graph_n_nodes.float())
                    .long(), min=1), 0)
    mask_flag = batch.node_mask & (rank_n < k_n[batch.node_graph])
    atom_type, chirality = _mask_atoms(batch, mask_flag)

    n_bonds = batch.bond_mask.shape[0]
    key_b = _mix_keys(salts, torch.arange(n_bonds, device=key_n.device))
    rank_b = _bond_ranks(batch, key_b, bond_window)
    k_b = torch.floor(bond_frac * batch.graph_n_bonds.float()).long()
    drop_bond = batch.bond_mask & (rank_b < k_b[batch.bond_graph])
    edge_mask, _ = _apply_bond_drop(batch, drop_bond)
    hc, bc = _bond_threshold(batch, key_b, rank_b, k_b)
    nbr_mask = _nbr_mask_lex_drop(batch, salts, hc, bc)
    return dataclasses.replace(batch, atom_type=atom_type,
                               chirality=chirality, edge_mask=edge_mask,
                               nbr_mask=nbr_mask)


def draw_node_keys(num_nodes: int, generator: torch.Generator):
    """The random inputs of one node_augment call, drawn on the CPU: keys
    [N] in [0, 2^20) and salts [2] in [0, 2^31 - 1)."""
    key_n = torch.randint(0, 1 << 20, (num_nodes,), generator=generator)
    salts = torch.randint(0, _INT32_MAX, (2,), generator=generator)
    return key_n, salts


def paired_augment(batch, generator: torch.Generator, kind: str = "node",
                   tile: int = 0, bond_window: int = 0):
    """The two contrastive views of one base batch (ref returns (data_i,
    data_j) per molecule, dataset/dataset.py:147). 'none' returns the batch
    twice; the random inputs of 'node' come from `generator` (CPU)."""
    if kind == "none":
        return batch, batch
    if kind == "node":
        return tuple(node_augment(batch, *draw_node_keys(batch.num_nodes,
                                                         generator),
                                  tile=tile, bond_window=bond_window)
                     for _ in range(2))
    if kind in ("subgraph", "mix"):
        raise NotImplementedError(f"{kind!r} augmentation is not ported yet")
    raise ValueError(f"unknown augmentation kind {kind!r}")


def apply_view_delta(batch, delta):
    """A full view from the base batch and a delta tuple."""
    return dataclasses.replace(batch, **dict(zip(AUG_DELTA_FIELDS, delta)))

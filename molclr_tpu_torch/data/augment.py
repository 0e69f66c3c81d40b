"""Stochastic graph augmentation on the device: the node, subgraph and mix
kinds.

Port of molclr_tpu/data/augment.py. Molecules are featurized once;
augmentation is tensor math on the padded batch, on the batch's device:

  node      per graph mask max(1, floor(0.25 N)) atoms to [118, 0] and
            delete floor(0.25 M) bonds (both directions at once)
            (ref dataset/dataset.py:111-147)
  subgraph  wave-BFS from a random start atom until floor(0.25 N) atoms are
            removed (masked) and their bonds dropped
            (ref dataset_subgraph.py:70-88,96-177)
  mix       subgraph removal at a U(0, 0.2) fraction, then top-up atom
            masking to floor(0.25 N) in all and bond deletion down to
            ceil(0.75 M) surviving bonds (ref dataset_mix.py:175-215);
            featurize with hydrogens for it (dataset_mix.py:88)

Sampling without replacement ranks uniform keys within each graph's
contiguous segment, sort-free where the layout allows it: tile-aligned node
buffers use a per-tile compare-and-count (_segment_ranks_tile) and bond
buffers a windowed compare-and-count (_segment_ranks_window, bound by
spec.max_graph_bonds); other batches take one lexicographic sort. On
tile-aligned batches the BFS runs as block-diagonal {0,1} products (exact
in f32), S waves per product with the power stack [A^1 .. A^S]
(`bfs_stride`, BFS_STRIDE unless a caller sets it; every stride gives the
wave times of one wave at a time). Where the TPU code
avoids gathers on tiled batches (the one-hot compares of
_flag_at_ids_tile / _flag_at_nbr_tile, and the ELL view's drops worked out
in slot space), the port gathers: the card gathers cheaply, and the ELL
view taken through the bond table is the same (the JAX package's tests
hold its two views equal).

Each kind is a pure function of the batch and its random inputs (int keys
in [0, 2^20), hash salts, mix's per-graph fraction), so that given JAX's
draws it gives JAX's views bit for bit; the `draw_*` functions draw those
inputs from a torch.Generator on the CPU, so that a run on the card and
one on the CPU see the same views. A trainer may draw a window of steps'
keys ahead, as one flat int64 row per step (`flatten_keys`; mix's f32
fractions by their bits), upload the window once and unflatten each row
on the device (`unflatten_keys`); `precompute_deltas_for` computes a
window's views up front as the four AUG_DELTA_FIELDS (port of the JAX
package's `view_delta`, `apply_view_delta`, `precompute_deltas_for`,
`precompute_paired_deltas`), bit-identical to drawing them inline.
"""

from __future__ import annotations

import dataclasses

import torch

from molclr_tpu_torch.data.featurize import MASK_ATOM_TYPE
from molclr_tpu_torch.ops.tile_dense import build_tile_adjacency

_INT32_MAX = 0x7FFFFFFF
_U32 = 0xFFFFFFFF
# BFS time of an unreached node
_INF_TIME = 0x3FFFFF
# BFS waves per product on tiled batches
BFS_STRIDE = 8
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


def _i32(x):
    """x wrapped to int32 as JAX's int32 arithmetic wraps it."""
    return ((x + (1 << 31)) & _U32) - (1 << 31)


def _adj_power_stack(adj, stride: int):
    """[A^1 .. A^stride] stacked along rows: [T, stride * tile, tile], by
    log-doubling (one stacked product [A^1..A^m] @ A^p gives A^(p+1) ..
    A^(p+m)); each power clamped to {0, 1} (reachability within m waves:
    the self-loops make A^m reach 'within m')."""
    powers = [adj]
    t = adj.shape[-1]
    while len(powers) < stride:
        p = len(powers)
        m = min(p, stride - p)
        stack = torch.cat(powers[:m], dim=1) if m > 1 else powers[0]
        new = (torch.bmm(stack, powers[-1]) > 0).to(adj.dtype)
        powers += [new[:, i * t: (i + 1) * t, :] for i in range(m)]
    return torch.cat(powers, dim=1)


def _bfs_times(batch, start_flag, max_waves: int, tile: int = 0,
               stride: int = BFS_STRIDE):
    """Wave at which each node is first reached from its graph's start atom
    over the ELL adjacency, _INF_TIME if not within max_waves. start_flag
    [N] or [N, V] (V start sets share one sweep on tiled batches). tile > 0
    runs the frontier expansion as block-diagonal products of {0,1}
    operands (exact in f32), `stride` waves per product with the power
    stack, the exact wave times recovered from the monotone hit counts (any
    stride gives the same times)."""
    if not tile:
        t = torch.where(start_flag, 0, _INF_TIME)
        for _ in range(max_waves):
            nbr_t = torch.where(batch.nbr_mask, t[batch.nbr], _INF_TIME)
            best = torch.clamp(nbr_t.min(dim=1).values + 1, max=_INF_TIME)
            t = torch.minimum(t, torch.where(batch.node_mask, best,
                                             _INF_TIME))
        return t
    adj = build_tile_adjacency(batch.nbr, batch.nbr_mask, tile,
                               dtype=torch.float32)
    n = batch.num_nodes
    squeeze = start_flag.dim() == 1
    sf = start_flag[:, None] if squeeze else start_flag
    v = sf.shape[1]
    node_mask = batch.node_mask[:, None]
    t = torch.where(sf, 0, _INF_TIME)
    f = sf & node_mask
    stride = max(1, min(int(stride), max_waves))
    pstack = _adj_power_stack(adj, stride)
    for k in range(-(-max_waves // stride)):
        hits = torch.bmm(pstack, f.float().reshape(-1, tile, v))
        hit = (hits > 0).reshape(-1, stride, tile, v)
        cnt = hit.sum(dim=1).reshape(n, v)               # monotone in m
        t_cand = k * stride + (stride - cnt) + 1
        t = torch.where((cnt > 0) & (t == _INF_TIME), t_cand, t)
        f = node_mask & hit[:, stride - 1].reshape(n, v)
    # the last product may overshoot max_waves: clamp to the horizon
    t = torch.where(t > max_waves, _INF_TIME, t)
    return t[:, 0] if squeeze else t


def _wave_key(t, cap: int, key_t):
    """The removal order key min(t, cap + 1) * 2^20 + tie-break key, in
    JAX's int32 arithmetic (reached nodes by wave, random inside a wave)."""
    return _i32(torch.clamp(t, max=cap + 1) * (1 << 20) + key_t.long())


def _subgraph_removal(batch, key_s, key_t, k_sub, max_waves: int,
                      start_rank_slot: int, tile: int = 0,
                      bfs_stride: int = BFS_STRIDE):
    """Removed-node flags of wave-BFS removal of k_sub[g] atoms per graph,
    from the node ranked `start_rank_slot` by the start keys key_s; the
    wave clip is capped at 2046 so that the key stays in int32."""
    start_rank = _node_ranks(batch, key_s.long(), tile)
    start_flag = batch.node_mask & (start_rank == start_rank_slot)
    t = _bfs_times(batch, start_flag, max_waves, tile, bfs_stride)
    rank = _node_ranks(batch, _wave_key(t, min(max_waves, 2045), key_t),
                       tile)
    return (batch.node_mask & (t < _INF_TIME)
            & (rank < k_sub[batch.node_graph]))


def _subgraph_removal_pair(batch, key_s, keys_t, k_subs, max_waves: int,
                           tile: int = 0, bfs_stride: int = BFS_STRIDE):
    """Removed-node flags of both paired views at once: start atoms ranked
    0 and 1 by the shared start keys (distinct, ref dataset_subgraph.py:
    109), one two-column BFS sweep on tiled batches. Equal to two
    _subgraph_removal calls with slots 0 / 1 (the wave clip is not capped
    here, as in the JAX package)."""
    start_rank = _node_ranks(batch, key_s.long(), tile)
    starts = torch.stack([batch.node_mask & (start_rank == 0),
                          batch.node_mask & (start_rank == 1)], dim=1)
    if tile:
        t_pair = _bfs_times(batch, starts, max_waves, tile, bfs_stride)
    else:
        t_pair = torch.stack([_bfs_times(batch, starts[:, v], max_waves)
                              for v in range(2)], dim=1)
    out = []
    for v in range(2):
        t = t_pair[:, v]
        rank = _node_ranks(batch, _wave_key(t, max_waves, keys_t[v]), tile)
        out.append(batch.node_mask & (t < _INF_TIME)
                   & (rank < k_subs[v][batch.node_graph]))
    return out[0], out[1]


def _bond_endpoints(batch):
    """Undirected bond endpoints from the even directed rows."""
    return batch.src[0::2], batch.dst[0::2]


def _finish_subgraph(batch, removed):
    """Mask the removed atoms and drop the bonds touching them, in both
    views (ref dataset_subgraph.py:137-172)."""
    atom_type, chirality = _mask_atoms(batch, removed)
    bsrc, bdst = _bond_endpoints(batch)
    drop_bond = batch.bond_mask & (removed[bsrc] | removed[bdst])
    edge_mask, nbr_mask = _apply_bond_drop(batch, drop_bond)
    return dataclasses.replace(batch, atom_type=atom_type,
                               chirality=chirality, edge_mask=edge_mask,
                               nbr_mask=nbr_mask)


def _finish_mix(batch, removed, key_n, salts, node_frac: float,
                bond_keep: float, tile: int, bond_window: int):
    """Top-up masking and bond deletion after subgraph removal (ref
    dataset_mix.py:175-215): survivors masked up to floor(node_frac N) in
    all (removed nodes rank first, key -1), then bonds deleted down to
    ceil(bond_keep M) survivors (bonds touching a removed atom rank last,
    key _INF_TIME)."""
    g = batch.num_graphs
    dev = removed.device
    key_n, salts = key_n.to(dev), salts.to(dev)
    n_removed = torch.zeros(g, dtype=torch.long, device=dev).index_add_(
        0, batch.node_graph, removed.long())
    k_total = torch.floor(node_frac * batch.graph_n_nodes.float()).long()
    k_extra = torch.clamp(k_total - n_removed, min=0)
    survivors = batch.node_mask & ~removed
    rank = _node_ranks(batch, torch.where(removed, -1, key_n.long()), tile)
    topup = survivors & (rank < (n_removed + k_extra)[batch.node_graph])
    atom_type, chirality = _mask_atoms(batch, removed | topup)

    bsrc, bdst = _bond_endpoints(batch)
    drop_sub = batch.bond_mask & (removed[bsrc] | removed[bdst])
    keep_cap = torch.ceil(bond_keep * batch.graph_n_bonds.float()).long()
    n_bonds = batch.bond_mask.shape[0]
    hash_b = _mix_keys(salts, torch.arange(n_bonds, device=dev))
    bkey = torch.where(drop_sub, _INF_TIME, hash_b)
    brank = _bond_ranks(batch, bkey, bond_window)
    # surviving bonds rank first; keep only the first keep_cap of them
    drop_extra = (batch.bond_mask & ~drop_sub
                  & (brank >= keep_cap[batch.bond_graph]))
    edge_mask, nbr_mask = _apply_bond_drop(batch, drop_sub | drop_extra)
    return dataclasses.replace(batch, atom_type=atom_type,
                               chirality=chirality, edge_mask=edge_mask,
                               nbr_mask=nbr_mask)


def _k_sub(frac, batch):
    """floor(frac * N) per graph in f32, as JAX computes it (frac a float
    or a per-graph f32 tensor)."""
    return torch.floor(frac * batch.graph_n_nodes.float()).long()


def subgraph_augment(batch, key_s, key_t, frac: float = 0.25,
                     max_waves: int = 32, start_rank_slot: int = 0,
                     tile: int = 0, bfs_stride: int = BFS_STRIDE):
    """BFS subgraph removal (ref dataset_subgraph.py:70-88,96-177). key_s
    [N] ranks the start atoms, key_t [N] breaks ties inside a wave (both
    in [0, 2^20)). Given the JAX package's `_rand_keys(rng_s, N)` and
    `_rand_keys(rng_t, N)` (rng_s, rng_t = split(rng), or start_rng for
    rng_s) this returns its subgraph_augment bit for bit."""
    dev = batch.atom_type.device
    removed = _subgraph_removal(batch, key_s.to(dev), key_t.to(dev),
                                _k_sub(frac, batch), max_waves,
                                start_rank_slot, tile, bfs_stride)
    return _finish_subgraph(batch, removed)


def paired_subgraph_augment(batch, key_s, keys_t, frac: float = 0.25,
                            max_waves: int = 32, tile: int = 0,
                            bfs_stride: int = BFS_STRIDE):
    """Both subgraph views in one sweep: shared start keys key_s, per-view
    tie-break keys keys_t = (key_t_i, key_t_j). Equal to two
    subgraph_augment calls with start_rank_slot 0 / 1."""
    dev = batch.atom_type.device
    k_sub = _k_sub(frac, batch)
    rem_i, rem_j = _subgraph_removal_pair(
        batch, key_s.to(dev), [k.to(dev) for k in keys_t], (k_sub, k_sub),
        max_waves, tile, bfs_stride)
    return _finish_subgraph(batch, rem_i), _finish_subgraph(batch, rem_j)


def mix_augment(batch, f, key_s, key_t, key_n, salts, node_frac: float = 0.25,
                bond_keep: float = 0.75, max_waves: int = 32,
                start_rank_slot: int = 0, tile: int = 0, bond_window: int = 0,
                bfs_stride: int = BFS_STRIDE):
    """Subgraph removal at the per-graph fraction f [G] (f32 in [0, 0.2))
    plus top-up masking and bond deletion (ref dataset_mix.py). key_s,
    key_t as in subgraph_augment; key_n [N] ranks the top-up atoms, salts
    [2] salt the bond hash. Given JAX's draws (rng_f, rng_s, rng_n, rng_b
    = split(rng, 4); f = uniform(rng_f, (G,), maxval=0.2); rng_ss, rng_st
    = split(rng_s)) this returns its mix_augment bit for bit."""
    dev = batch.atom_type.device
    removed = _subgraph_removal(batch, key_s.to(dev), key_t.to(dev),
                                _k_sub(f.to(dev), batch), max_waves,
                                start_rank_slot, tile, bfs_stride)
    return _finish_mix(batch, removed, key_n, salts, node_frac, bond_keep,
                       tile, bond_window)


def paired_mix_augment(batch, key_s, views, node_frac: float = 0.25,
                       bond_keep: float = 0.75, max_waves: int = 32,
                       tile: int = 0, bond_window: int = 0,
                       bfs_stride: int = BFS_STRIDE):
    """Both mix views with one BFS sweep: shared start keys key_s and, per
    view, views[v] = (f, key_t, key_n, salts). Equal to two mix_augment
    calls with start_rank_slot 0 / 1."""
    dev = batch.atom_type.device
    rem_i, rem_j = _subgraph_removal_pair(
        batch, key_s.to(dev), [v[1].to(dev) for v in views],
        [_k_sub(v[0].to(dev), batch) for v in views], max_waves, tile,
        bfs_stride)
    return tuple(_finish_mix(batch, rem, v[2], v[3], node_frac, bond_keep,
                             tile, bond_window)
                 for rem, v in zip((rem_i, rem_j), views))


def _rand_keys(num: int, generator: torch.Generator):
    return torch.randint(0, 1 << 20, (num,), generator=generator)


def draw_subgraph_keys(num_nodes: int, generator: torch.Generator):
    """The random inputs of one paired_subgraph_augment call, drawn on the
    CPU: start keys [N] and the two views' tie-break keys."""
    return (_rand_keys(num_nodes, generator),
            tuple(_rand_keys(num_nodes, generator) for _ in range(2)))


def draw_mix_keys(num_nodes: int, num_graphs: int,
                  generator: torch.Generator, sub_frac_max: float = 0.2):
    """The random inputs of one paired_mix_augment call, drawn on the CPU:
    start keys [N] and per view (f [G] f32 in [0, sub_frac_max), tie-break
    keys [N], top-up keys [N], salts [2])."""
    key_s = _rand_keys(num_nodes, generator)
    views = tuple(
        (torch.rand(num_graphs, generator=generator) * sub_frac_max,
         _rand_keys(num_nodes, generator), _rand_keys(num_nodes, generator),
         torch.randint(0, _INT32_MAX, (2,), generator=generator))
        for _ in range(2))
    return key_s, views


def draw_paired_keys(kind: str, num_nodes: int, num_graphs: int,
                     generator: torch.Generator):
    """The random inputs of one paired augmentation of `kind`, drawn on
    the CPU in the order paired_augment draws them: node ((key_n, salts)
    per view), subgraph (key_s, (key_t_i, key_t_j)), mix (key_s, per view
    (f, key_t, key_n, salts)), none ()."""
    if kind == "none":
        return ()
    if kind == "node":
        return tuple(draw_node_keys(num_nodes, generator) for _ in range(2))
    if kind == "subgraph":
        return draw_subgraph_keys(num_nodes, generator)
    if kind == "mix":
        return draw_mix_keys(num_nodes, num_graphs, generator)
    raise ValueError(f"unknown augmentation kind {kind!r}")


def paired_augment_keys(batch, keys, kind: str = "node", tile: int = 0,
                        bond_window: int = 0, bfs_stride: int = BFS_STRIDE,
                        max_waves: int = 0):
    """The two views of one base batch from drawn keys (draw_paired_keys'
    structure, on any device): a pure function of (batch, keys)."""
    if kind == "none":
        return batch, batch
    if kind == "node":
        return tuple(node_augment(batch, *k, tile=tile,
                                  bond_window=bond_window) for k in keys)
    bfs = dict(max_waves=max_waves or 32, tile=tile, bfs_stride=bfs_stride)
    if kind == "subgraph":
        return paired_subgraph_augment(batch, *keys, **bfs)
    if kind == "mix":
        return paired_mix_augment(batch, *keys, bond_window=bond_window,
                                  **bfs)
    raise ValueError(f"unknown augmentation kind {kind!r}")


def paired_augment(batch, generator: torch.Generator, kind: str = "node",
                   tile: int = 0, bond_window: int = 0,
                   bfs_stride: int = BFS_STRIDE,
                   max_waves: int = 0):
    """The two contrastive views of one base batch (ref returns (data_i,
    data_j) per molecule, dataset/dataset.py:147). 'none' returns the batch
    twice; the random inputs of the other kinds come from `generator`
    (CPU). max_waves bounds the BFS horizon of subgraph / mix (0 keeps
    their default, 32; trainers pass a corpus-derived bound, see
    Pretrainer.setup_data); bfs_stride is the waves per product on tiled
    batches."""
    keys = draw_paired_keys(kind, batch.num_nodes, batch.num_graphs,
                            generator)
    return paired_augment_keys(batch, keys, kind, tile, bond_window,
                               bfs_stride, max_waves)


# ---- keys drawn ahead: one flat int64 row per step ----


def _key_layout(kind: str, num_nodes: int, num_graphs: int):
    """The structure of draw_paired_keys' result as (length, is_f32)
    leaves."""
    n, g = (num_nodes, False), (2, False)
    if kind == "none":
        return ()
    if kind == "node":
        return ((n, g), (n, g))
    if kind == "subgraph":
        return (n, (n, n))
    if kind == "mix":
        view = ((num_graphs, True), n, n, g)
        return (n, (view, view))
    raise ValueError(f"unknown augmentation kind {kind!r}")


def _is_leaf(node) -> bool:
    return bool(node) and isinstance(node[0], int)


def flatten_keys(keys) -> torch.Tensor:
    """draw_paired_keys' result as one int64 row: the int keys as they
    are, mix's f32 fractions by their bits."""
    parts = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            parts.append(node.view(torch.int32).long()
                         if node.dtype == torch.float32 else node.long())
        else:
            for c in node:
                walk(c)

    walk(keys)
    return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.long)


def unflatten_keys(kind: str, row: torch.Tensor, num_nodes: int,
                   num_graphs: int):
    """The inverse of flatten_keys: views of `row` (mix's fractions
    reinterpreted as f32), bit-equal to the drawn keys."""
    pos = 0

    def build(node):
        nonlocal pos
        if not _is_leaf(node):
            return tuple(build(c) for c in node)
        length, is_f32 = node
        x = row[pos: pos + length]
        pos += length
        return x.to(torch.int32).view(torch.float32) if is_f32 else x

    return build(_key_layout(kind, num_nodes, num_graphs))


def view_delta(view):
    """The augmented fields of a view, as a tuple."""
    return tuple(getattr(view, f) for f in AUG_DELTA_FIELDS)


def precompute_deltas_for(get_batch, keys_for_step, n: int, kind: str,
                          **kwargs):
    """Both views' deltas for steps 0 .. n-1, stacked on a leading [n]
    axis: step i augments get_batch(i) with keys_for_step(i)
    (draw_paired_keys' structure). Equal, view for view, to paired_augment
    of each step's batch with the generator its keys were drawn from.
    kwargs go to paired_augment_keys."""
    steps = [tuple(view_delta(v) for v in paired_augment_keys(
        get_batch(i), keys_for_step(i), kind, **kwargs)) for i in range(n)]
    return tuple(tuple(torch.stack([s[v][f] for s in steps])
                       for f in range(len(AUG_DELTA_FIELDS)))
                 for v in range(2))


def precompute_paired_deltas(batch, keys_for_step, k: int, kind: str,
                             **kwargs):
    """precompute_deltas_for over one shared base batch."""
    return precompute_deltas_for(lambda i: batch, keys_for_step, k, kind,
                                 **kwargs)


def apply_view_delta(batch, delta):
    """A full view from the base batch and a delta tuple."""
    return dataclasses.replace(batch, **dict(zip(AUG_DELTA_FIELDS, delta)))

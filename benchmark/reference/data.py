"""Frozen copies of the data arithmetic the port's steps follow, in plain
PyTorch and numpy: the corpus split, the tile-unit plan and each epoch's
unit order, the augmentation keys of a step, and MolCLR's node and
subgraph augmentations applied to a packed batch.

A batch here is a dict of tensors with the packed layout's COO view:
atom_type, chirality, node_graph, node_mask [N]; src, dst, bond_type,
bond_dir, edge_bond, edge_mask [E] (bond k on directed rows of one id);
graph_mask, graph_n_nodes, graph_n_bonds [G]. The augmentations rank
atoms and bonds by (key, position in the batch), as the published
samplers draw a uniform subset, so they need the batch's layout: the
keys are drawn per packed position.
"""

from __future__ import annotations

import numpy as np
import torch

MASK_ATOM_TYPE = 118        # ref dataset/dataset.py:123 (len(ATOM_LIST))
SELF_LOOP_BOND_TYPE = 4     # ref models/ginet_molclr.py:35
_INT32_MAX = 0x7FFFFFFF
_U32 = 0xFFFFFFFF
_INF = 0x3FFFFF
TRAIN_STREAM, VALID_STREAM = 0, 1

FIELDS = ("atom_type", "chirality", "node_graph", "node_mask", "src", "dst",
          "bond_type", "bond_dir", "edge_bond", "edge_mask", "graph_mask",
          "graph_n_nodes", "graph_n_bonds")


# ---- the split, the unit plan, the epoch orders ----

def split_ids(n: int, seed: int, valid_size: float):
    """(train ids, valid ids) of a corpus of n molecules: one seeded
    permutation, the first int(n * valid_size) for validation."""
    order = np.random.RandomState(seed).permutation(n)
    n_valid = int(n * valid_size)
    return order[n_valid:], order[:n_valid]


def unit_groups(atoms: np.ndarray, tile: int, seed: int) -> list[np.ndarray]:
    """Greedy first-fit of the molecules (atom counts `atoms`, indices into
    the train split) into `tile`-node units after one seeded shuffle."""
    order = np.random.RandomState(seed).permutation(len(atoms))
    groups, cur, nodes = [], [], 0
    for i in order:
        a = int(atoms[i])
        if nodes + a > tile:
            groups.append(np.array(cur, np.int64))
            cur, nodes = [], 0
        cur.append(i)
        nodes += a
    if cur:
        groups.append(np.array(cur, np.int64))
    return groups


def epoch_orders(n_units: int, per_step: int, seed: int, epoch: int,
                 steps: int) -> np.ndarray:
    """[steps, per_step] unit rows of one epoch."""
    rng = np.random.RandomState((seed * 1_000_003 + epoch) % (2**31 - 1))
    perm = rng.permutation(n_units)
    s = n_units // per_step
    return perm[: s * per_step].reshape(s, per_step)[:steps]


# ---- keys ----

def step_seed(seed: int, *ids: int) -> int:
    words = np.random.SeedSequence([seed, *ids]).generate_state(2)
    return (int(words[0]) << 31) ^ int(words[1])


def step_generator(seed: int, *ids: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(step_seed(seed, *ids))


def draw_keys(kind: str, num_nodes: int, gen: torch.Generator):
    """The random inputs of one paired augmentation, in their draw order:
    node: ((key_n, salts), (key_n, salts)); subgraph: (key_s, (key_t_i,
    key_t_j))."""
    def keys():
        return torch.randint(0, 1 << 20, (num_nodes,), generator=gen)

    if kind == "node":
        return tuple((keys(), torch.randint(0, _INT32_MAX, (2,),
                                            generator=gen))
                     for _ in range(2))
    if kind == "subgraph":
        return keys(), (keys(), keys())
    raise ValueError(f"augmentation {kind!r} has no reference")


# ---- augmentation ----

def _ranks(key: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor):
    """Rank of each valid element among its segment's valid elements by
    (key, position); invalid elements rank past every valid one."""
    n = key.shape[0]
    pos = torch.arange(n, device=key.device)
    big = torch.iinfo(torch.int64).max // 4
    k = torch.where(valid, key.long(), big)
    order = torch.argsort(k, stable=True)
    order = order[torch.argsort(seg[order], stable=True)]
    sseg = seg[order]
    first = torch.ones(n, dtype=torch.bool, device=key.device)
    first[1:] = sseg[1:] != sseg[:-1]
    start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    rank = torch.empty(n, dtype=torch.long, device=key.device)
    rank[order] = pos - start
    return rank


def _mulmod32(x, c: int):
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def bond_keys(salts: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Uniform keys in [0, 2^20) hashed from bond ids (murmur3's
    finalizer, salted), as the port draws a bond's deletion key."""
    x = (ids.long() & _U32) ^ (salts[0].long() & _U32)
    x = _mulmod32(x ^ (x >> 16), 0x7FEB352D)
    x = _mulmod32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16) ^ (salts[1].long() & _U32)
    return x >> 12


def _bonds(b: dict):
    """(the id of each real bond, its molecule) from the directed rows,
    each bond once."""
    e = b["edge_mask"]
    ids = b["edge_bond"][e]
    g = b["node_graph"][b["src"][e]]
    uniq, inv = torch.unique(ids, return_inverse=True)
    graph = torch.zeros_like(uniq).scatter_(0, inv, g)
    return uniq, graph


def _view(b: dict, masked: torch.Tensor, dropped_bonds: torch.Tensor):
    """The view: masked atoms set to the mask token with chirality 0, the
    directed rows of dropped bonds removed."""
    v = dict(b)
    v["atom_type"] = torch.where(masked, MASK_ATOM_TYPE, b["atom_type"])
    v["chirality"] = torch.where(masked, 0, b["chirality"])
    drop = torch.isin(b["edge_bond"], dropped_bonds)
    v["edge_mask"] = b["edge_mask"] & ~drop
    return v


def node_view(b: dict, key_n: torch.Tensor, salts: torch.Tensor) -> dict:
    """MolCLR's atom masking and bond deletion (ref dataset/dataset.py:
    111-147): per molecule the max(1, floor(N / 4)) atoms of lowest key
    masked and the floor(M / 4) bonds of lowest hashed key deleted."""
    dev = b["atom_type"].device
    rank = _ranks(key_n.to(dev), b["node_graph"], b["node_mask"])
    k_n = torch.clamp(torch.floor(0.25 * b["graph_n_nodes"].float()).long(),
                      min=1)
    masked = b["node_mask"] & (rank < k_n[b["node_graph"]])
    ids, graph = _bonds(b)
    key_b = bond_keys(salts.to(dev), ids)
    order = torch.argsort(ids)
    ids, graph, key_b = ids[order], graph[order], key_b[order]
    brank = _ranks(key_b, graph, torch.ones_like(ids, dtype=torch.bool))
    k_b = torch.floor(0.25 * b["graph_n_bonds"].float()).long()
    return _view(b, masked, ids[brank < k_b[graph]])


def bfs_waves(b: dict, start: torch.Tensor, max_waves: int) -> torch.Tensor:
    """Breadth-first wave at which each atom is reached from the start
    atoms over the batch's bonds, _INF beyond max_waves."""
    e = b["edge_mask"]
    src, dst = b["src"][e], b["dst"][e]
    t = torch.where(start, 0, _INF)
    for wave in range(1, max_waves + 1):
        front = t[src] == wave - 1
        if not bool(front.any()):
            break
        hit = torch.zeros_like(start)
        hit[dst[front]] = True
        t = torch.where(hit & (t == _INF), wave, t)
    return t


def subgraph_views(b: dict, key_s, keys_t, max_waves: int):
    """MolCLR's subgraph removal for both views (ref
    dataset_subgraph.py:70-88,96-177): from the atoms ranked 0 and 1 by the
    shared start keys, a breadth-first search removes floor(N / 4) atoms,
    wave by wave, random inside a wave; the removed atoms are masked and
    every bond touching one is deleted."""
    dev = b["atom_type"].device
    start_rank = _ranks(key_s.to(dev), b["node_graph"], b["node_mask"])
    k_sub = torch.floor(0.25 * b["graph_n_nodes"].float()).long()
    e = b["edge_mask"]
    views = []
    for v in range(2):
        start = b["node_mask"] & (start_rank == v)
        t = bfs_waves(b, start, max_waves)
        key = torch.clamp(t, max=max_waves + 1) * (1 << 20) \
            + keys_t[v].to(dev).long()
        rank = _ranks(key, b["node_graph"], b["node_mask"])
        removed = (b["node_mask"] & (t < _INF)
                   & (rank < k_sub[b["node_graph"]]))
        touch = e & (removed[b["src"]] | removed[b["dst"]])
        dropped = torch.unique(b["edge_bond"][touch])
        views.append(_view(b, removed, dropped))
    return views[0], views[1]


def paired_views(b: dict, kind: str, keys, max_waves: int):
    if kind == "node":
        return tuple(node_view(b, *k) for k in keys)
    return subgraph_views(b, keys[0], keys[1], max_waves)

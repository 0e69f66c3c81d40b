"""Graphormer (Ying et al., NeurIPS 2021, arXiv:2106.05234) fine-tuning in
plain PyTorch, one molecule at a time: its own breadth-first distances and
Floyd-Warshall path rule, dense [n + 1, n + 1] attention with the graph
token first, f32 with TF32 off (`tf32=True`: the matrix products in TF32,
the precision below the configuration's). No tiles, no packing and no
kernel: molecules are read out of a packed batch's fields, and the
program's dropout keep masks are read back per molecule.

  x_i      E_atom[type] + E_chir[chir] + Z_in[deg + 1] + Z_out[deg + 1]
  bias     b[phi + 1] (phi 510 with no path: row 511) + the mean over the
           path's first min(phi, hops) bonds of ((E_type[t] + E_dir[d]) /
           2) W_n; t on the graph token's row and column
  layer    x += drop(MHA(LN(x))), scores (q / sqrt(d_h)) k^T + bias,
           dropout on the probabilities; x += drop(fc2(drop(gelu(fc1(LN(
           x))))))
  readout  LN; the graph token's row; Linear, GELU, LN, Linear
  path     Floyd-Warshall over intermediates k = 0, 1, ... recording k on
           strict improvement; the path of (i, j) is that of (i, k), then
           k, then that of (k, j) (Graphormer's algos.pyx get_all_edges)

Parameters are a dict keyed like the program's state dict.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

UNREACHABLE = 510
GRAPH_TOKEN_TYPE = 119
EPS = 1e-5


@contextlib.contextmanager
def precision(tf32: bool):
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


def molecules(b: dict) -> list:
    """Each molecule slot of a packed batch (a dict of its fields on the
    CPU) as {"rows": its rows, graph token first, "atom_type",
    "chirality", "bonds": [(i, j, type, dir)] with i < j over its atoms
    0..n-1}; None for an empty slot."""
    nm = b["node_mask"].bool()
    em = b["edge_mask"].bool()
    graph = b["node_graph"].tolist()
    edges: dict = {}
    for s, d, t, r in zip(b["src"][em].tolist(), b["dst"][em].tolist(),
                          b["bond_type"][em].tolist(),
                          b["bond_dir"][em].tolist()):
        edges.setdefault(graph[s], []).append((s, d, t, r))
    out = []
    for g in range(b["graph_mask"].shape[0]):
        rows = torch.nonzero(nm & (b["node_graph"] == g))[:, 0]
        if not bool(b["graph_mask"][g]) or rows.numel() == 0:
            out.append(None)
            continue
        if int(b["atom_type"][rows[0]]) != GRAPH_TOKEN_TYPE:
            raise ValueError(f"slot {g} does not begin with a graph token")
        local = {int(r): i for i, r in enumerate(rows[1:].tolist())}
        bonds = set()
        for s, d, t, r in edges.get(g, []):
            if s in local and d in local:
                i, j = local[s], local[d]
                bonds.add((min(i, j), max(i, j), t, r))
        out.append({"rows": rows, "atom_type": b["atom_type"][rows[1:]],
                    "chirality": b["chirality"][rows[1:]],
                    "bonds": sorted(bonds)})
    return out


def bfs_distances(n: int, bonds: list) -> list:
    """Breadth-first distances [n][n], UNREACHABLE where no path."""
    adj = [[] for _ in range(n)]
    for i, j, _, _ in bonds:
        adj[i].append(j)
        adj[j].append(i)
    dist = [[UNREACHABLE] * n for _ in range(n)]
    for s in range(n):
        dist[s][s] = 0
        frontier = [s]
        while frontier:
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if dist[s][v] == UNREACHABLE:
                        dist[s][v] = dist[s][u] + 1
                        nxt.append(v)
            frontier = nxt
    return dist


def shortest_paths(n: int, bonds: list, hops: int):
    """(distances [n, n] long, hop bonds: [n, n, hops] (type, dir) pairs
    as two long tensors and their mask)."""
    dist = bfs_distances(n, bonds)
    fw = torch.full((n, n), UNREACHABLE, dtype=torch.long)
    for i, j, _, _ in bonds:
        fw[i, j] = fw[j, i] = 1
    fw.fill_diagonal_(0)
    inter = torch.full((n, n), -1, dtype=torch.long)
    for k in range(n):
        cand = fw[:, k: k + 1] + fw[k: k + 1, :]
        better = cand < fw
        fw = torch.where(better, cand, fw)
        inter = torch.where(better, k, inter)
    if fw.tolist() != dist:
        raise AssertionError("Floyd-Warshall and BFS distances differ")
    inter = inter.tolist()
    feat = {}
    for i, j, t, r in bonds:
        feat[(i, j)] = feat[(j, i)] = (t, r)
    memo: dict = {}

    def between(i, j):
        k = inter[i][j]
        if k == -1:
            return []
        if (i, j) not in memo:
            memo[(i, j)] = between(i, k) + [k] + between(k, j)
        return memo[(i, j)]

    none = [(0, 0, False)] * hops
    hop = [[none] * n for _ in range(n)]
    for i in range(n):
        for j in range(n):
            if i == j or dist[i][j] == UNREACHABLE:
                continue
            path = [i] + between(i, j) + [j]
            cut = min(len(path) - 1, hops)
            hop[i][j] = [feat[(path[h], path[h + 1])] + (True,)
                         for h in range(cut)] + none[cut:]
    hop = torch.tensor(hop, dtype=torch.long).reshape(n, n, hops, 3)
    return torch.tensor(dist), hop[..., 0], hop[..., 1], hop[..., 2] > 0


def molecule_keep(keep: dict, rows: torch.Tensor, tile: int) -> dict:
    """One molecule's slice of the program's keep masks (models/
    graphormer.py keep_masks) at its rows of the packed batch."""
    t = int(rows[0]) // tile
    loc = rows % tile
    return {"input": keep["input"][rows],
            "layers": [{"attn": m["attn"][t][:, loc][:, :, loc],
                        "attn_out": m["attn_out"][rows],
                        "act": m["act"][rows],
                        "ffn_out": m["ffn_out"][rows]}
                       for m in keep["layers"]]}


def _linear(p, name, x):
    return x @ p[name + ".weight"].t() + p[name + ".bias"]


def _norm(p, name, x):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                        p[name + ".bias"], EPS)


def _drop(x, keep, rate):
    if keep is None:
        return x
    return torch.where(keep, x / torch.tensor(1.0 - rate, device=x.device),
                       0.0)


def attention_bias(p: dict, mol: dict, paths, heads: int,
                   hops: int) -> torch.Tensor:
    """[heads, n + 1, n + 1], the graph token first."""
    dist, types, dirs, real = (x.to(p["graph_token"].device) for x in paths)
    n = dist.shape[0]
    row = torch.where(dist >= UNREACHABLE, UNREACHABLE + 1, dist + 1)
    atoms = p["spatial_embedding.weight"][row]                 # [n, n, H]
    e = (p["edge_type_embedding.weight"][types]
         + p["edge_dir_embedding.weight"][dirs]) / 2           # [n, n, K, H]
    e = torch.where(real[..., None], e, 0.0)
    edge = sum(e[:, :, k, :] @ p["edge_hop_weight"][k] for k in range(hops))
    count = dist.clamp(min=1, max=hops).to(edge.dtype)
    atoms = atoms + edge / count[..., None]
    bias = torch.zeros((n + 1, n + 1, heads), device=atoms.device)
    bias[1:, 1:] = atoms
    t = p["graph_token_distance"][0]
    bias[0, :] = bias[0, :] + t
    bias[1:, 0] = bias[1:, 0] + t
    return bias.permute(2, 0, 1)


def forward(p: dict, mol: dict, paths, *, layers: int, heads: int,
            hops: int, keep=None, rate: float = 0.0) -> torch.Tensor:
    """The molecule's logits (or regression output)."""
    dev = p["graph_token"].device
    n = mol["atom_type"].shape[0]
    deg = torch.zeros(n, dtype=torch.long)
    for i, j, _, _ in mol["bonds"]:
        deg[i] += 1
        deg[j] += 1
    deg = (deg + 1).to(dev)
    x = (p["atom_embedding.weight"][mol["atom_type"].to(dev)]
         + p["chirality_embedding.weight"][mol["chirality"].to(dev)]
         + p["in_degree_embedding.weight"][deg]
         + p["out_degree_embedding.weight"][deg])
    x = torch.cat([p["graph_token"], x])
    x = _drop(x, None if keep is None else keep["input"], rate)
    bias = attention_bias(p, mol, paths, heads, hops)
    d = x.shape[1]
    dh = d // heads
    for i in range(layers):
        g = f"layers.{i}."
        k_i = None if keep is None else keep["layers"][i]
        y = _norm(p, g + "attn_norm", x)
        q = (_linear(p, g + "q", y) * dh ** -0.5).view(n + 1, heads, dh)
        k = _linear(p, g + "k", y).view(n + 1, heads, dh)
        v = _linear(p, g + "v", y).view(n + 1, heads, dh)
        s = torch.einsum("ihd,jhd->hij", q, k) + bias
        a = torch.softmax(s, dim=-1)
        a = _drop(a, None if k_i is None else k_i["attn"], rate)
        o = torch.einsum("hij,jhd->ihd", a, v).reshape(n + 1, d)
        o = _drop(_linear(p, g + "out", o),
                  None if k_i is None else k_i["attn_out"], rate)
        x = x + o
        y = F.gelu(_linear(p, g + "fc1", _norm(p, g + "ffn_norm", x)))
        y = _drop(y, None if k_i is None else k_i["act"], rate)
        y = _drop(_linear(p, g + "fc2", y),
                  None if k_i is None else k_i["ffn_out"], rate)
        x = x + y
    hg = _norm(p, "final_norm", x)[0]
    y = F.gelu(_linear(p, "pred_head.0", hg))
    return _linear(p, "pred_head.3", _norm(p, "pred_head.2", y))


def half_mask(graph_mask: torch.Tensor) -> torch.Tensor:
    """The fault "half of the batch left out": the first half of the real
    molecules kept, the rest masked out of the loss."""
    rank = torch.cumsum(graph_mask.long(), 0) - 1
    return graph_mask & (rank < int(graph_mask.sum()) // 2)


def adam_update(p: dict, grads: dict, state: dict, lr: dict, wd: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One step of torch's Adam (weight decay added to the gradient) on
    every leaf of p, in place; lr maps a leaf name to its rate."""
    with torch.no_grad():
        for k, g in grads.items():
            st = state.setdefault(k, {"t": 0, "m": torch.zeros_like(g),
                                      "v": torch.zeros_like(g)})
            st["t"] += 1
            g = g + wd * p[k]
            st["m"].mul_(b1).add_((1 - b1) * g)
            st["v"].mul_(b2).add_((1 - b2) * g * g)
            m_hat = st["m"] / (1 - b1 ** st["t"])
            v_hat = st["v"] / (1 - b2 ** st["t"])
            p[k] -= lr[k] * m_hat / (torch.sqrt(v_hat) + eps)


def finetune_steps(p0: dict, batches: list, labels: list, keeps: list, *,
                   layers: int, heads: int, hops: int, tile: int,
                   drop: float, head_lr: float, base_lr: float, wd: float,
                   device, tf32: bool = False, half: bool = False) -> dict:
    """Steps on batches[i] (packed batch dicts) with labels[i] [G] and the
    program's keep masks keeps[i] (None: no dropout) from the weights p0:
    the mean
    cross-entropy over the real molecules (half: over half of them, a
    planted fault), one backward, the two-group Adam (pred_head.* at
    head_lr). Returns the losses, the first gradient as Adam takes it
    (plus weight decay) and the weights after the last step."""
    p = {k: v.detach().clone().to(device) for k, v in p0.items()}
    lrs = {k: head_lr if k.startswith("pred_head") else base_lr for k in p}
    state, losses, first = {}, [], None
    kw = dict(layers=layers, heads=heads, hops=hops, rate=drop)
    with precision(tf32):
        for b, lab, keep in zip(batches, labels, keeps):
            mols = molecules(b)
            real = half_mask(b["graph_mask"].bool()) if half \
                else b["graph_mask"].bool()
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in p.items()}
            terms = []
            for g, mol in enumerate(mols):
                if mol is None or not bool(real[g]):
                    continue
                paths = shortest_paths(mol["atom_type"].shape[0],
                                       mol["bonds"], hops)
                out = forward(leaves, mol, paths, keep=None if keep is None
                              else molecule_keep(keep, mol["rows"].to(device),
                                                 tile), **kw)
                terms.append(F.cross_entropy(
                    out[None], lab[g: g + 1].long().to(device)))
            loss = torch.stack(terms).sum() / max(len(terms), 1)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()), allow_unused=True)))
            grads = {k: torch.zeros_like(p[k]) if g is None else g
                     for k, g in grads.items()}
            if first is None:
                first = {k: (g + wd * p[k]).cpu() for k, g in grads.items()}
            adam_update(p, grads, state, lrs, wd)
            losses.append(float(loss.detach()))
    return {"losses": losses, "first_grad": first,
            "params": {k: v.cpu() for k, v in p.items()}}


@torch.no_grad()
def predict(p: dict, batches: list, *, layers: int, heads: int, hops: int,
            device, tf32: bool = False) -> torch.Tensor:
    """Evaluation outputs [batches, G, out] of every molecule slot (zeros
    for empty slots)."""
    p = {k: v.to(device) for k, v in p.items()}
    out_dim = p["pred_head.3.bias"].shape[0]
    preds = []
    with precision(tf32):
        for b in batches:
            rows = torch.zeros((b["graph_mask"].shape[0], out_dim))
            for g, mol in enumerate(molecules(b)):
                if mol is not None:
                    paths = shortest_paths(mol["atom_type"].shape[0],
                                           mol["bonds"], hops)
                    rows[g] = forward(p, mol, paths, layers=layers,
                                      heads=heads, hops=hops).cpu()
            preds.append(rows)
    return torch.stack(preds)

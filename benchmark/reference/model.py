"""MolCLR's networks in plain PyTorch, as functions of a parameter dict
keyed like the published state dicts (ref models/ginet_molclr.py,
gcn_molclr.py, ginet_finetune.py).

  trunk     h0 = E_type[x0] + E_chir[x1]; per layer conv -> BatchNorm ->
            relu (not after the last) [-> dropout when fine-tuning]
  GINE      agg_i = sum over i's bonds and its self-loop (type 4, dir 0) of
            (h_j + E1[type] + E2[dir]); out = W2 relu(W1 agg + b1) + b2
  GCN       xw = h W; out_i = sum over the same of (xw_j + e1[type] +
            e2[dir]) + bias, e1 / e2 scalars (the published layer computes
            a normalization and discards it)
  BatchNorm over the real atoms: batch mean and biased variance in
            training (running stats updated with the unbiased one, momentum
            0.1), running stats in evaluation, eps 1e-5
  pool      mean over each molecule's atoms; feat_lin
  MolCLR    projection feat -> feat -> relu -> feat / 2
  FineTune  feat -> feat / 2 -> softplus -> feat / 2 -> softplus -> 2

A batch is a dict of tensors in the COO layout of reference/data.py.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .data import SELF_LOOP_BOND_TYPE

EPS, MOMENTUM = 1e-5, 0.1


def _aggregate(b: dict, x: torch.Tensor, e1: torch.Tensor,
               e2: torch.Tensor) -> torch.Tensor:
    """sum over each atom's kept bonds and its self-loop of x_j + e1[type]
    + e2[dir] (e1, e2 broadcast over the features when they are [., 1])."""
    e = b["edge_mask"]
    src, dst = b["src"][e], b["dst"][e]
    msg = x[src] + e1[b["bond_type"][e]] + e2[b["bond_dir"][e]]
    out = x + e1[SELF_LOOP_BOND_TYPE] + e2[0]
    return out.index_add(0, dst, msg)


def _batch_norm(out, mask, p, buffers, prefix, training):
    m = mask[:, None].to(out.dtype)
    if training:
        n = m.sum()
        mean = (out * m).sum(0) / n
        var = (((out - mean) ** 2) * m).sum(0) / n
        with torch.no_grad():
            buffers[prefix + "running_mean"].mul_(1 - MOMENTUM).add_(
                MOMENTUM * mean)
            buffers[prefix + "running_var"].mul_(1 - MOMENTUM).add_(
                MOMENTUM * var * n / (n - 1))
    else:
        mean = buffers[prefix + "running_mean"]
        var = buffers[prefix + "running_var"]
    y = ((out - mean) / torch.sqrt(var + EPS) * p[prefix + "weight"]
         + p[prefix + "bias"])
    return torch.where(mask[:, None], y, 0.0)


def trunk(p: dict, buffers: dict, b: dict, gnn: str, layers: int,
          training: bool, keep=None, drop_ratio: float = 0.0):
    """Node embeddings [N, D]; keep: one bool [N, D] mask per layer
    (fine-tuning dropout in training)."""
    mask = b["node_mask"]
    h = (p["x_embedding1.weight"][b["atom_type"]]
         + p["x_embedding2.weight"][b["chirality"]])
    h = torch.where(mask[:, None], h, 0.0)
    for i in range(layers):
        g = f"gnns.{i}."
        if gnn == "gin":
            agg = _aggregate(b, h, p[g + "edge_embedding1.weight"],
                             p[g + "edge_embedding2.weight"])
            mid = torch.relu(agg @ p[g + "mlp.0.weight"].t()
                             + p[g + "mlp.0.bias"])
            out = mid @ p[g + "mlp.2.weight"].t() + p[g + "mlp.2.bias"]
        else:
            xw = h @ p[g + "weight"]
            out = _aggregate(b, xw, p[g + "edge_embedding1.weight"],
                             p[g + "edge_embedding2.weight"]) + p[g + "bias"]
        h = _batch_norm(out, mask, p, buffers, f"batch_norms.{i}.", training)
        if i != layers - 1:
            h = torch.relu(h)
        if keep is not None:
            h = torch.where(keep[i], h / torch.tensor(1.0 - drop_ratio), 0.0)
    return h


def encode(p, buffers, b, gnn, layers, training, keep=None,
           drop_ratio=0.0) -> torch.Tensor:
    """Mean-pooled molecule features after feat_lin [G, feat]."""
    h = trunk(p, buffers, b, gnn, layers, training, keep, drop_ratio)
    g = b["graph_mask"].shape[0]
    mask = b["node_mask"]
    s = torch.zeros(g, h.shape[1], dtype=h.dtype, device=h.device)
    s = s.index_add(0, b["node_graph"][mask], h[mask])
    n = torch.clamp(b["graph_n_nodes"].to(h.dtype), min=1.0)[:, None]
    hg = s / n
    return hg @ p["feat_lin.weight"].t() + p["feat_lin.bias"]


def project(p, hg):
    z = torch.relu(hg @ p["out_lin.0.weight"].t() + p["out_lin.0.bias"])
    return z @ p["out_lin.2.weight"].t() + p["out_lin.2.bias"]


def predict_head(p, hg, n_layer: int = 2):
    x = hg
    for j in range(n_layer):
        x = F.softplus(x @ p[f"pred_head.{2 * j}.weight"].t()
                       + p[f"pred_head.{2 * j}.bias"])
    k = 2 * n_layer
    return x @ p[f"pred_head.{k}.weight"].t() + p[f"pred_head.{k}.bias"]


def nt_xent(zi, zj, graph_mask, temperature: float):
    """MolCLR's NT-Xent over the real pairs: r = [zj; zi] cosine-normalized,
    s = r r^T / T; each row's loss is logsumexp over the other real rows
    minus its partner's similarity; the mean over real rows."""
    r = torch.cat([zj, zi])
    r = r / torch.clamp(torch.linalg.vector_norm(r, dim=1, keepdim=True),
                        min=1e-12)
    s = r @ r.t() / temperature
    n, b = s.shape[0], zi.shape[0]
    valid = torch.cat([graph_mask, graph_mask])
    dead = torch.eye(n, dtype=torch.bool, device=s.device) | ~valid[None, :]
    partner = torch.cat([torch.arange(b, n), torch.arange(0, b)]).to(s.device)
    pos = s[torch.arange(n, device=s.device), partner]
    row = torch.logsumexp(s.masked_fill(dead, float("-inf")), dim=1) - pos
    w = valid.to(row.dtype)
    return (row * w).sum() / torch.clamp(w.sum(), min=1.0)


def masked_ce(pred, labels, graph_mask):
    per = F.cross_entropy(pred, labels.long(), reduction="none")
    w = graph_mask.to(per.dtype)
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


def adam_update(p: dict, grads: dict, state: dict, lr: dict, wd: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One step of torch's Adam (weight decay added to the gradient, bias
    corrections from the step count) on every leaf of p, in place; lr maps
    a leaf name to its learning rate."""
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

"""The reference's training steps: MolCLR pretraining (two augmented views,
the encoder and projection, NT-Xent, Adam) and ensemble fine-tuning
(dropout, M member trunks and heads, CE, the two-group Adam, validation
predictions), from given initial weights on given batches, in plain
PyTorch. `tf32=True` computes the matrix products in TF32, the precision
below the configuration's, as the control that the comparison has to
reject."""

from __future__ import annotations

import contextlib

import torch

from . import data as rdata
from . import model as rmodel


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


def _on(d: dict, device) -> dict:
    return {k: v.to(device) for k, v in d.items()}


def half_mask(graph_mask: torch.Tensor) -> torch.Tensor:
    """The fault "half of the batch left out": the first half of the real
    molecules kept, the rest masked out of the loss."""
    rank = torch.cumsum(graph_mask.long(), 0) - 1
    return graph_mask & (rank < int(graph_mask.sum()) // 2)


def pretrain_steps(p0: dict, buf0: dict, batches: list, keys: list, *,
                   kind: str, max_waves: int, gnn: str, layers: int,
                   temperature: float, lr: float, wd: float, device,
                   tf32: bool = False, dtype=torch.float32,
                   half: bool = False) -> dict:
    """Steps on batches[i] with augmentation keys keys[i] from weights p0
    and BatchNorm buffers buf0, computed in `dtype` (half: the loss over
    half of the molecules, a planted fault). Returns the losses, the first
    step's gradient as Adam takes it (plus weight decay) and the weights
    after the last step."""
    p = {k: v.detach().clone().to(device, dtype) for k, v in p0.items()}
    buffers = {k: v.detach().clone().to(device) for k, v in buf0.items()}
    buffers = {k: v.to(dtype) if v.is_floating_point() else v
               for k, v in buffers.items()}
    state, losses, first = {}, [], None
    lrs = {k: lr for k in p}
    with precision(tf32):
        for b, k in zip(batches, keys):
            b = _on(b, device)
            vi, vj = rdata.paired_views(b, kind, k, max_waves)
            leaves = {n: v.detach().requires_grad_(True)
                      for n, v in p.items()}
            zi = rmodel.project(leaves, rmodel.encode(
                leaves, buffers, vi, gnn, layers, True))
            zj = rmodel.project(leaves, rmodel.encode(
                leaves, buffers, vj, gnn, layers, True))
            pairs = half_mask(b["graph_mask"]) if half else b["graph_mask"]
            loss = rmodel.nt_xent(zi, zj, pairs, temperature)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            grads = dict(zip(leaves, grads))
            if first is None:
                first = {n: (g + wd * p[n]).cpu() for n, g in grads.items()}
            rmodel.adam_update(p, grads, state, lrs, wd)
            losses.append(float(loss.detach()))
    return {"losses": losses, "first_grad": first,
            "params": {k: v.cpu() for k, v in p.items()}}


def draw_masks(gens: list, n: int, d: int, layers: int, rate: float,
               device) -> list:
    """Each seed's keep masks for one step, one [n, d] per layer, drawn
    from its generator as the fine-tuning step draws them."""
    return [[torch.rand((n, d), generator=g, device=device) < 1.0 - rate
             for _ in range(layers)] for g in gens]


def finetune_steps(p0: list, buf0: list, batches: list, labels: list, *,
                   mask_seeds: list, n_seeds: int, layers: int, d: int,
                   drop: float, head_lr: float, base_lr: float, wd: float,
                   pred_layers: int, valid: list, device,
                   tf32: bool = False, half: bool = False) -> dict:
    """Steps of the M = T x S members (member m = t S + s trains on label
    column t from seed s's weights p0[m] and takes seed s's dropout masks)
    on batches[i] with labels[i] [G, T]; then every member's evaluation
    predictions on the `valid` batches. Returns the per-step member
    losses, the first gradient as Adam takes it, the weights after the
    last step, and the predictions [batches, M, G, 2]. half: each loss
    over half of the molecules, a planted fault."""
    m_count = len(p0)
    ps = [{k: v.detach().clone().to(device) for k, v in p.items()}
          for p in p0]
    bufs = [{k: v.detach().clone().to(device) for k, v in b.items()}
            for b in buf0]
    gens = [torch.Generator(device=device).manual_seed(s) for s in mask_seeds]
    states = [{} for _ in range(m_count)]
    lrs = {k: head_lr if k.startswith("pred_head") else base_lr
           for k in ps[0]}
    losses, first = [], None
    with precision(tf32):
        for b, lab in zip(batches, labels):
            b = _on(b, device)
            lab = lab.to(device)
            n = b["atom_type"].shape[0]
            real = half_mask(b["graph_mask"]) if half else b["graph_mask"]
            masks = draw_masks(gens, n, d, layers, drop, device)
            leaves = [{k: v.detach().requires_grad_(True)
                       for k, v in p.items()} for p in ps]
            step = []
            for m in range(m_count):
                t, s = divmod(m, n_seeds)
                hg = rmodel.encode(leaves[m], bufs[m], b, "gin", layers,
                                   True, masks[s], drop)
                pred = rmodel.predict_head(leaves[m], hg, pred_layers)
                step.append(rmodel.masked_ce(pred, lab[:, t], real))
            total = torch.stack(step).sum()
            flat = [v for lv in leaves for v in lv.values()]
            grads = torch.autograd.grad(total, flat)
            it = iter(grads)
            per = [{k: next(it) for k in lv} for lv in leaves]
            if first is None:
                first = [{k: (g + wd * ps[m][k]).cpu() for k, g in gm.items()}
                         for m, gm in enumerate(per)]
            for m in range(m_count):
                rmodel.adam_update(ps[m], per[m], states[m], lrs, wd)
            losses.append([float(x.detach()) for x in step])
        preds = []
        with torch.no_grad():
            for b in valid:
                b = _on(b, device)
                preds.append(torch.stack([
                    rmodel.predict_head(ps[m], rmodel.encode(
                        ps[m], bufs[m], b, "gin", layers, False),
                        pred_layers) for m in range(m_count)]).cpu())
    return {"losses": losses, "first_grad": first,
            "params": [{k: v.cpu() for k, v in p.items()} for p in ps],
            "preds": torch.stack(preds)}

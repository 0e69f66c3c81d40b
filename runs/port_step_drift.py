"""Free-running drift of the port's pretraining step, card against CPU.

    python3 runs/port_step_drift.py      (from the repository root, on a card)

Runs 4 full-width f32 steps (chip_smoke.py's pretraining batch and model)
three ways from the same weights and the same CPU-drawn augmentation keys:
on the CPU (plain path), on the card (kernels), and on the card with the
K1 kernels swapped for their plain versions; prints the losses and, per
parameter, the worst relative difference of the step-0 gradients from the
CPU's. Also checks that the augmented views are equal on both devices."""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from molclr_tpu_torch.data import augment as A  # noqa: E402
from molclr_tpu_torch.ops import fused_layer as FL  # noqa: E402
from molclr_tpu_torch.train import pretrain as P  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
batch, spec = cs.pretrain_batch()
cfg = cs.pretrain_cfg()
bw = spec.max_graph_bonds

# views equal on both devices?
for step in range(3):
    g1 = P.step_generator(cfg.seed, 0, step); g2 = P.step_generator(cfg.seed, 0, step)
    vc = A.paired_augment(batch.to("cpu"), g1, "node", tile=256, bond_window=bw)
    vg = A.paired_augment(batch.to(dev), g2, "node", tile=256, bond_window=bw)
    same = all(torch.equal(getattr(a, f).cpu(), getattr(b, f)) for a, b in zip(vg, vc) for f in A.AUG_DELTA_FIELDS)
    print("views equal step", step, same)

def run(where, plain_on_card=False, steps=4):
    real_fwd, real_bwd = FL.fused_gine_bn_layer_fwd, FL.fused_gine_bn_layer_bwd
    if plain_on_card:
        FL.fused_gine_bn_layer_fwd = lambda *a, residuals: FL.fused_gine_bn_layer_fwd_plain(*a)
        FL.fused_gine_bn_layer_bwd = FL.fused_gine_bn_layer_bwd_plain
    model = cs.build_model(cfg, torch.Generator().manual_seed(2)).to(where)
    opt = cs.optim.adam_torch(model.parameters(), cfg.weight_decay)
    b = batch.to(where)
    losses, grads0 = [], None
    for s in range(steps):
        losses.append(P.train_step(model, opt, b, cfg, s, 5e-4, bond_window=bw).item())
        if s == 0:
            grads0 = {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()}
    FL.fused_gine_bn_layer_fwd, FL.fused_gine_bn_layer_bwd = real_fwd, real_bwd
    return losses, grads0

lc, gc = run("cpu")
lk, gk = run(dev)
lp, gp = run(dev, plain_on_card=True)
print("cpu        ", lc)
print("card kernel", lk)
print("card plain ", lp)
for name, g in (("kernel", gk), ("plain", gp)):
    worst = sorted(((((g[k] - gc[k]).abs().max() / gc[k].abs().max().clamp(min=1e-12)).item(), k) for k in gc), reverse=True)[:6]
    print(name, "grad rel diff worst:", [(round(v, 8), k) for v, k in worst])

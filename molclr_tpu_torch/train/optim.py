"""Optimizers and the pretraining LR schedule.

Port of molclr_tpu/train/optim.py (`warmup_then_cosine`, `adam_torch`,
`two_group_adam`): Adam with torch semantics, which IS torch.optim.Adam
(weight decay added to the gradient before the moment updates, bias
correction, b1 0.9, b2 0.999, eps 1e-8). Pretraining runs a constant LR
for `warm_up` epochs and then a cosine to 0, at epoch granularity (ref
molclr.py:84-91,146-147); optax evaluates the schedule at the update count
before each step, and `set_lr` does the same. Fine-tuning runs two
parameter groups at constant LRs (ref finetune.py:167-178).
"""

from __future__ import annotations

import math

import torch


def warmup_then_cosine(base_lr: float, steps_per_epoch: int, epochs: int,
                       warm_up: int):
    """step -> LR: base_lr for warm_up epochs, then cosine to 0 over the
    remaining epochs (like CosineAnnealingLR stepped once per epoch)."""
    decay_epochs = max(1, epochs - warm_up)

    def schedule(step: int) -> float:
        epoch = step // max(1, steps_per_epoch)
        t = min(max((epoch - warm_up) / decay_epochs, 0.0), 1.0)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * t))

    return schedule


def adam_torch(params, weight_decay: float = 0.0) -> torch.optim.Adam:
    """torch.optim.Adam with the reference's betas and eps; the LR is set
    per step by `set_lr`."""
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


# the head's parameters (the JAX package's _HEAD_PREFIXES pred_, motif_,
# out_lin in this package's state-dict names)
HEAD_PREFIXES = ("pred_head", "motif_", "out_lin")


def two_group_adam(model: torch.nn.Module, head_lr: float, base_lr: float,
                   weight_decay: float = 0.0) -> torch.optim.Adam:
    """torch.optim.Adam with two parameter groups: the head (parameters
    whose state-dict name starts with one of HEAD_PREFIXES) at head_lr and
    the rest at base_lr, both with weight_decay. The grouping is structural
    as in the JAX package (the reference's name match misses GIN heads,
    quirk Q6)."""
    head, base = [], []
    for name, p in model.named_parameters():
        (head if name.startswith(HEAD_PREFIXES) else base).append(p)
    return torch.optim.Adam(
        [{"params": head, "lr": head_lr}, {"params": base, "lr": base_lr}],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)

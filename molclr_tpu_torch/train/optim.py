"""Optimizers and the pretraining LR schedule.

Port of molclr_tpu/train/optim.py (`warmup_then_cosine`, `adam_torch`,
`adam_torch_fused`, `two_group_adam`): Adam with torch semantics, which IS
torch.optim.Adam (weight decay added to the gradient before the moment
updates, bias correction, b1 0.9, b2 0.999, eps 1e-8). Pretraining runs a
constant LR for `warm_up` epochs and then a cosine to 0, at epoch
granularity (ref molclr.py:84-91,146-147); optax evaluates the schedule at
the update count before each step, and `set_lr` does the same. Fine-tuning
runs two parameter groups at constant LRs (ref finetune.py:167-178).

`FusedAdam` (adam_impl 'fused') keeps the parameters, their gradients and
both moments in four contiguous f32 buffers and updates them with a few
wide elementwise operations over the whole [P] vector. Its step count and
LR are device tensors, as are those of torch.optim.Adam built with
`capturable=True`, so that a CUDA graph can replay a step
(train/graphed.py).
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


def adam_torch(params, weight_decay: float = 0.0, capturable: bool = False
               ) -> torch.optim.Adam:
    """torch.optim.Adam with the reference's betas and eps; the LR is set
    per step by `set_lr`. capturable=True (parameters on the card) keeps
    the step count and the LR on the device, for CUDA graphs."""
    params = list(params)
    lr = (torch.zeros((), device=params[0].device) if capturable else 0.0)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay,
                            capturable=capturable)


class FusedAdam:
    """adam_torch over one contiguous f32 buffer: the port of the JAX
    package's `adam_torch_fused`. The parameters become views into `flat`
    and their gradients views into `grad`, which autograd accumulates into
    (zero_grad zeroes the buffer and keeps the views); `mu` and `nu` are
    two more [P] buffers. The update is JAX's, each operation rounded in
    f32: g + wd p, the moments, mu_hat / (sqrt(nu_hat) + eps) times -lr,
    with the bias corrections from the device step count."""

    def __init__(self, params, weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        params = list(params)
        dev = params[0].device
        size = sum(p.numel() for p in params)
        self.flat = torch.empty(size, dtype=torch.float32, device=dev)
        self.grad = torch.zeros_like(self.flat)
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)
        self.weight_decay, self.b1, self.b2, self.eps = (weight_decay, b1,
                                                         b2, eps)
        off = 0
        with torch.no_grad():
            for p in params:
                if p.dtype != torch.float32:
                    raise TypeError(f"FusedAdam takes f32 parameters, not "
                                    f"{p.dtype}")
                n = p.numel()
                self.flat[off: off + n].copy_(p.reshape(-1))
                p.data = self.flat[off: off + n].view_as(p)
                p.grad = self.grad[off: off + n].view_as(p)
                off += n
        self.param_groups = [{"params": params, "lr": self.lr}]

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Zero the gradient buffer (its views stay the gradients, whatever
        set_to_none says)."""
        self.grad.zero_()

    @torch.no_grad()
    def step(self) -> None:
        g = self.grad
        if self.weight_decay:
            g = g + self.weight_decay * self.flat
        torch.add(self.b1 * self.mu, (1.0 - self.b1) * g, out=self.mu)
        torch.add(self.b2 * self.nu, (1.0 - self.b2) * (g * g), out=self.nu)
        self.count.add_(1)
        c = self.count.float()
        mu_hat = self.mu / (1.0 - torch.pow(self.b1, c))
        nu_hat = self.nu / (1.0 - torch.pow(self.b2, c))
        self.flat.add_(-self.lr * mu_hat / (torch.sqrt(nu_hat) + self.eps))

    def state_dict(self) -> dict:
        return {"count": self.count.clone(), "mu": self.mu.clone(),
                "nu": self.nu.clone()}

    def load_state_dict(self, state: dict) -> None:
        """Copy a state_dict into the buffers in place (a captured graph
        keeps reading them)."""
        for k in ("count", "mu", "nu"):
            getattr(self, k).copy_(state[k])


def make_adam(impl: str, params, weight_decay: float = 0.0,
              capturable: bool = False):
    """adam_impl 'chain' (torch.optim.Adam, capturable when asked) or
    'fused' (FusedAdam, always capturable)."""
    if impl == "chain":
        return adam_torch(params, weight_decay, capturable)
    if impl == "fused":
        return FusedAdam(params, weight_decay)
    raise ValueError(f"unknown adam_impl {impl!r}")


def set_lr(opt, lr: float) -> None:
    """Set every group's LR: a float in place, a device LR tensor filled."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def load_optimizer_state(opt, state: dict) -> None:
    """opt.load_state_dict(state), keeping this optimizer's `capturable`
    flag and the kind of its LR (a device tensor or a float), which
    torch.optim's load_state_dict takes from the saved groups. It also
    places each step count by the saved groups' flag, so a state saved
    by a non-capturable Adam keeps its counts on the CPU; they go where
    this optimizer keeps them: on the parameter's device when it is
    capturable, on the CPU when not."""
    if isinstance(opt, FusedAdam):
        opt.load_state_dict(state)
        return
    kept = [(g["capturable"], g["lr"]) for g in opt.param_groups]
    opt.load_state_dict(state)
    for g, (capturable, lr) in zip(opt.param_groups, kept):
        saved = float(g["lr"])
        g["capturable"] = capturable
        if isinstance(lr, torch.Tensor):
            lr.fill_(saved)
            g["lr"] = lr
        else:
            g["lr"] = saved
        for p in g["params"]:
            st = opt.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(p.device if capturable
                                           else "cpu")


# the head's parameters (the JAX package's _HEAD_PREFIXES pred_, motif_,
# out_lin in this package's state-dict names)
HEAD_PREFIXES = ("pred_head", "motif_", "out_lin")


def two_group_adam(models, head_lr: float, base_lr: float,
                   weight_decay: float = 0.0,
                   quirk_q6_single_group: bool = False,
                   capturable: bool = False) -> torch.optim.Adam:
    """torch.optim.Adam with two parameter groups over one model or a list
    of them (the members of an ensemble: Adam is elementwise, so one
    optimizer over all members steps each as its own would): the head
    (parameters whose state-dict name starts with one of HEAD_PREFIXES) at
    head_lr and the rest at base_lr, both with weight_decay. The grouping
    is structural as in the JAX package (the reference's name match misses
    GIN heads, quirk Q6); quirk_q6_single_group reproduces the miss: one
    group at base_lr. capturable=True (parameters on the card) keeps the
    step counts on the device, for CUDA graphs."""
    if isinstance(models, torch.nn.Module):
        models = [models]
    named = [(name, p) for model in models
             for name, p in model.named_parameters()]
    if quirk_q6_single_group:
        groups = [{"params": [p for _, p in named], "lr": base_lr}]
    else:
        head = [name.startswith(HEAD_PREFIXES) for name, _ in named]
        groups = [{"params": [p for (_, p), h in zip(named, head) if h],
                   "lr": head_lr},
                  {"params": [p for (_, p), h in zip(named, head) if not h],
                   "lr": base_lr}]
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay, capturable=capturable)
